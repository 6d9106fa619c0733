"""European-option exposure: LSM regression profile vs the analytic profile.

Port of ``examples/ee_pfe_european_vs_analytic.py`` (reference
tests/exposure_tests/ee_pfe_european_option.py): the discounted EE of a
European call is flat at the forward option value before maturity;
overlays the regression-based profile against the closed-form
discounted-exposure fast path.  The paths come from K2 (Black-Scholes
exact).

Run: python examples_torch/ee_pfe_european_vs_analytic.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, profile, save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    BlackScholesModel,
    EPEMetric,
    Equity,
    EuropeanOption,
    NettingSet,
    OptionType,
    PFEMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)


def run(num_paths, force_regression, device=None):
    model = BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    option = EuropeanOption(Equity("eq"), 3.0, 100.0, OptionType.CALL, asset_id="eq")
    timeline = np.linspace(0.25, 2.75, 11)
    metrics = [EPEMetric(), PFEMetric(0.95)]
    kwargs = {}
    if force_regression:
        # disable the family batch so the generic LSM executor runs
        kwargs["batch_products"] = False
    controller = SimulationController(
        netting_sets=[NettingSet(name="opt", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=metrics, exposure_timeline=timeline),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
        **kwargs,
    )
    return timeline, controller.run_simulation()


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline, r_analytic = run(num_paths, force_regression=False, device=device)
    _, r_lsm = run(num_paths, force_regression=True, device=device)
    n = len(timeline)
    curves = {
        "EE analytic fast path": profile(r_analytic, "opt", "epe", n),
        "EE LSM regression": profile(r_lsm, "opt", "epe", n),
        "PFE95 analytic": profile(r_analytic, "opt", "pfe[0.95]", n),
        "PFE95 LSM": profile(r_lsm, "opt", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_european_vs_analytic.png", timeline, curves,
            "European call exposure — analytic vs LSM (Black-Scholes)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
