"""Collateralized vs uncollateralized swap exposure with MPoR.

Port of ``examples/ee_pfe_swap_collateralized.py`` (reference
tests/exposure_tests/ee_pfe_swap_collateralized.py:35-74): overlays the EE
profile of a payer swap with and without a collateral agreement (margin
period of risk = 2 weeks) and saves the plot.  The paths come from K2
(Vasicek exact).

Run: python examples_torch/ee_pfe_swap_collateralized.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, profile, save_profile_plot, vasicek_model
from montecarlo_risk_engine_tpu_torch import (
    EPEMetric,
    InterestRateSwap,
    IRSType,
    NettingSet,
    PFEMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)


def run(mpor, num_paths, device=None):
    model = vasicek_model()
    swap = InterestRateSwap(0.0, 5.0, notional=100.0, fixed_rate=0.032,
                            tenor_fixed=0.5, tenor_float=0.5,
                            irs_type=IRSType.PAYER, asset_id="irs")
    timeline = np.linspace(0.25, 4.75, 19)
    controller = SimulationController(
        netting_sets=[NettingSet(name="swap", products=[swap],
                                 margin_period_of_risk=mpor)],
        model=model,
        risk_metrics=RiskMetrics(
            metrics=[EPEMetric(), PFEMetric(0.95)], exposure_timeline=timeline
        ),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    return timeline, results


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline, r_unsec = run(None, num_paths, device)
    _, r_coll = run(2.0 / 52.0, num_paths, device)
    n = len(timeline)
    curves = {
        "EE uncollateralized": profile(r_unsec, "swap", "epe", n),
        "EE collateralized (MPoR 2w)": profile(r_coll, "swap", "epe", n),
        "PFE95 uncollateralized": profile(r_unsec, "swap", "pfe[0.95]", n),
        "PFE95 collateralized": profile(r_coll, "swap", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_swap_collateralized.png", timeline, curves,
            "Payer swap exposure — collateral with 2-week MPoR (Vasicek)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
