"""EE / PFE of an up-and-out barrier call (knock-out kills exposure).

Port of ``examples/ee_pfe_barrier_option.py`` (reference
tests/exposure_tests/ee_pfe_barrier_option.py): the knock-out feature caps
the upside — the PFE of the barrier option stays far below the vanilla
call's because precisely the high-spot paths knock out.  The paths come
from K2 (Black-Scholes exact).

Run: python examples_torch/ee_pfe_barrier_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot)
from montecarlo_risk_engine_tpu_torch import (
    BarrierOption,
    BarrierOptionType,
    BlackScholesModel,
    Equity,
    EuropeanOption,
    OptionType,
    resolve_device,
)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline = np.linspace(0.2, 1.9, 9)

    def run(product, name):
        model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2, asset_id="eq")
        return run_exposure_book(model, [product], timeline,
                                 num_paths=num_paths, ns_name=name, device=device)

    barrier = BarrierOption(
        startdate=0.0, maturity=2.0, strike=100.0,
        num_observation_timepoints=10, option_type=OptionType.CALL,
        barrier1=130.0, barrier_option_type1=BarrierOptionType.UPANDOUT,
        asset_id="eq",
    )
    vanilla = EuropeanOption(Equity("eq"), 2.0, 100.0, OptionType.CALL, asset_id="eq")
    r_bar = run(barrier, "barrier")
    r_van = run(vanilla, "vanilla")
    n = len(timeline)
    curves = {
        "barrier EE": profile(r_bar, "barrier", "epe", n),
        "vanilla EE": profile(r_van, "vanilla", "epe", n),
        "barrier PFE95": profile(r_bar, "barrier", "pfe[0.95]", n),
        "vanilla PFE95": profile(r_van, "vanilla", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    assert curves["barrier PFE95"][-1] < curves["vanilla PFE95"][-1]
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_barrier_option.png", timeline, curves,
            "Up-and-out call vs vanilla — the knock-out caps PFE",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
