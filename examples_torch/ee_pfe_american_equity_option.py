"""EE / PFE profile of an American equity put (LSM continuation exposure).

Port of ``examples/ee_pfe_american_equity_option.py`` (reference
tests/exposure_tests/ee_pfe_american_equity_option.py): the exposure of an
American option decays as paths exercise — once exercised, the deal
contributes nothing to future exposure.  The paths come from K2
(Black-Scholes exact).

Run: python examples_torch/ee_pfe_american_equity_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot)
from montecarlo_risk_engine_tpu_torch import (
    AmericanOption,
    BlackScholesModel,
    Equity,
    OptionType,
    resolve_device,
)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.3, asset_id="eq")
    option = AmericanOption(Equity("eq"), maturity=3.0, num_exercise_dates=24,
                            strike=100.0, option_type=OptionType.PUT, asset_id="eq")
    timeline = np.linspace(0.125, 2.875, 23)
    results = run_exposure_book(model, [option], timeline, num_paths=num_paths,
                                ns_name="american", device=device)
    n = len(timeline)
    curves = {
        "EE": profile(results, "american", "epe", n),
        "PFE 95%": profile(results, "american", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    # exercised paths drop out: late exposure must sit below the early peak
    assert curves["EE"][-1] < max(curves["EE"]) + 1e-12
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_american_equity_option.png", timeline, curves,
            "American put — EE / PFE decay as paths exercise",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
