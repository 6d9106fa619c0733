"""European-option Monte Carlo convergence against the Black-Scholes formula.

Port of ``examples/pv_european_option.py`` (reference
tests/pv_tests/pv_european_option.py): PV + MC error across increasing path
counts converging onto the closed form, plus first-order Greeks from AAD
vs the analytic delta/vega.  The book runs on the hybrid path kernel K2
(Black-Scholes exact).

Run: python examples_torch/pv_european_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import save_profile_plot
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


def run(num_paths, device=None):
    device = resolve_device(device)
    model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2, asset_id="eq")
    option = EuropeanOption(Equity("eq"), 2.0, 100.0, OptionType.CALL, asset_id="eq")
    controller = SimulationController(
        netting_sets=[NettingSet(name="opt", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=0,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        differentiate=True,
        device=device,
    )
    results = controller.run_simulation()
    analytic = float(option.compute_pv_analytically(model, model.initial_params(device=device)))
    pv = float(results.get_results("opt", "pv", evaluation_idx=0))
    err = float(results.get_mc_error("opt", "pv", evaluation_idx=0))
    grads = results.get_derivatives("opt", "pv", evaluation_idx=0)
    return pv, err, analytic, {k: float(v) for k, v in grads.items()}


def main(num_paths=200_000, save_plot=True, device=None):
    device = resolve_device(device)
    counts = [n for n in (1_000, 4_000, 16_000, 64_000, num_paths) if n <= num_paths]
    pvs, errs, analytic = [], [], None
    for n in counts:
        pv, err, analytic, grads = run(n, device)
        pvs.append(pv)
        errs.append(err)
        print(f"paths={n:>8d}  pv={pv:10.6f} +- {err:.6f}  analytic={analytic:10.6f}"
              f"  |rel err|={abs(pv - analytic) / analytic:.2e}")
    print("AAD greeks at the largest run:", grads)
    assert abs(pvs[-1] - analytic) < 4.0 * errs[-1] + 1e-10
    if save_plot:
        path = save_profile_plot(
            "pv_european_option.png", np.log10(counts),
            {"|MC - analytic|": np.abs(np.array(pvs) - analytic),
             "MC standard error": np.array(errs)},
            "European call — MC convergence to Black-Scholes",
            ylabel="absolute error",
        )
        print(f"saved {path}")
        return path
    return pvs[-1]


if __name__ == "__main__":
    main()
