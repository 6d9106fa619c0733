"""Second-order sensitivities (full Hessian) of a European option PV.

Port of ``examples/pv_second_derivatives.py`` (reference
tests/pv_tests/pv_second_derivatives.py): runs the controller with
``compute_higher_derivatives()``, prints the 3x3 Hessian of the PV w.r.t.
(spot, volatility, rate) and compares gamma / vomma against the analytic
Black-Scholes formulas.  The PV is the analytic evaluation, so the book is
not simulated.

Run: python examples_torch/pv_second_derivatives.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_risk_engine_tpu_torch import (
    BlackScholesModel,
    Equity,
    EuropeanOption,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)
from montecarlo_risk_engine_tpu_torch.metrics.metrics import EvaluationType


def main(num_paths=1024, save_plot=True, device=None):
    device = resolve_device(device)
    model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2, asset_id="eq")
    option = EuropeanOption(Equity("eq"), 2.0, 100.0, OptionType.CALL, asset_id="eq")
    controller = SimulationController(
        netting_sets=[NettingSet(name="opt", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(
            metrics=[PVMetric(evaluation_type=EvaluationType.ANALYTICAL)]
        ),
        num_paths_mainsim=num_paths,
        num_paths_presim=0,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        differentiate=True,
        device=device,
    )
    controller.compute_higher_derivatives()
    results = controller.run_simulation()

    names = model.get_model_param_names()
    print("PV      :", float(results.get_results("opt", "pv", evaluation_idx=0)))
    print("grad    :", results.get_derivatives("opt", "pv", evaluation_idx=0))
    print("\nHessian (AAD, forward over the gradient):")
    hess = np.array([
        [
            float(results.get_second_derivatives("opt", "pv", param1=p1,
                                                 param2=p2, evaluation_idx=0))
            for p2 in names
        ]
        for p1 in names
    ])
    for p1, row in zip(names, hess):
        print(f"  {p1:>10s}: " + "  ".join(f"{v:12.6f}" for v in row))

    params = model.initial_params(device=device)
    gamma_ref = float(option.compute_dDeltadSpot_analytically(model, params))
    vomma_ref = float(option.compute_dVegadSigma_analytically(model, params))
    gamma = hess[names.index("spot"), names.index("spot")]
    vomma = hess[names.index("volatility"), names.index("volatility")]
    print(f"\ngamma AAD={gamma:.10f} analytic={gamma_ref:.10f}  |diff|={abs(gamma-gamma_ref):.2e}")
    print(f"vomma AAD={vomma:.10f} analytic={vomma_ref:.10f}  |diff|={abs(vomma-vomma_ref):.2e}")
    assert abs(gamma - gamma_ref) < 1e-8
    assert abs(vomma - vomma_ref) < 1e-7
    return gamma, vomma


if __name__ == "__main__":
    main()
