"""Digital (binary) option: fuzzy-smoothed MC vs the analytic price.

Port of ``examples/pv_binary_option.py`` (reference
tests/pv_tests/pv_binary_option.py): the cash-or-nothing payoff is always
fuzzy-smoothed (width eps=1), which keeps the MC estimate unbiased at the
money and makes the pathwise delta usable; sweeps the strike across
moneyness.  The book runs on K2 (Black-Scholes exact).

Run: python examples_torch/pv_binary_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    BinaryOption,
    BlackScholesModel,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)


def run(strike, num_paths, differentiate=False, device=None):
    device = resolve_device(device)
    model = BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.25, asset_id="eq")
    option = BinaryOption(1.5, strike, payment_amount=10.0,
                          option_type=OptionType.CALL, asset_id="eq")
    controller = SimulationController(
        netting_sets=[NettingSet(name="digital", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=0,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        differentiate=differentiate,
        device=device,
    )
    results = controller.run_simulation()
    pv = float(results.get_results("digital", "pv", evaluation_idx=0))
    analytic = float(option.compute_pv_analytically(model, model.initial_params(device=device)))
    delta = None
    if differentiate:
        delta = float(results.get_derivatives("digital", "pv", evaluation_idx=0)["spot"])
    return pv, analytic, delta


def main(num_paths=100_000, save_plot=True, device=None):
    device = resolve_device(device)
    strikes = np.array([70.0, 85.0, 100.0, 115.0, 130.0])
    mc, analytic, deltas = [], [], []
    for k in strikes:
        pv, ref, delta = run(k, num_paths, differentiate=True, device=device)
        mc.append(pv)
        analytic.append(ref)
        deltas.append(delta)
    curves = {"MC (fuzzy payoff)": np.array(mc), "analytic": np.array(analytic),
              "AAD delta x100": 100.0 * np.array(deltas)}
    print_profile_table(strikes, curves)
    if save_plot:
        path = save_profile_plot(
            "pv_binary_option.png", strikes, curves,
            "Cash-or-nothing call — fuzzy MC vs analytic across strikes",
            ylabel="PV / scaled delta",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
