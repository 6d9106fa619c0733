"""EE / PFE profile of a Bermudan payer swaption under Vasicek.

Port of ``examples/ee_pfe_bermudan_swaption.py`` (reference
tests/exposure_tests/ee_pfe_bermudan_swaption.py:17-95): a Bermudan option
exercising into the remaining payer swap, exposure profile from LSM
continuation values, PNG saved to examples_torch/plots/.  The paths come
from K2 (Vasicek exact).

Run: python examples_torch/ee_pfe_bermudan_swaption.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, profile, save_profile_plot, vasicek_model
from montecarlo_risk_engine_tpu_torch import (
    BermudanOption,
    EPEMetric,
    InterestRateSwap,
    IRSType,
    NettingSet,
    OptionType,
    PFEMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    model = vasicek_model()
    swap = InterestRateSwap(0.0, 5.0, notional=100.0, fixed_rate=0.032,
                            tenor_fixed=0.5, tenor_float=0.5,
                            irs_type=IRSType.PAYER, asset_id="irs")
    swaption = BermudanOption(
        underlying=swap, exercise_dates=[1.0, 2.0, 3.0], strike=0.0,
        option_type=OptionType.CALL, asset_id="irs",
    )
    timeline = np.linspace(0.25, 4.75, 19)
    controller = SimulationController(
        netting_sets=[NettingSet(name="swaption", products=[swaption])],
        model=model,
        risk_metrics=RiskMetrics(
            metrics=[EPEMetric(), PFEMetric(0.95)], exposure_timeline=timeline
        ),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=2,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    curves = {
        "EE": profile(results, "swaption", "epe", len(timeline)),
        "PFE 95%": profile(results, "swaption", "pfe[0.95]", len(timeline)),
    }
    print_profile_table(timeline, curves)
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_bermudan_swaption.png", timeline, curves,
            "Bermudan payer swaption — EE / PFE (Vasicek)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
