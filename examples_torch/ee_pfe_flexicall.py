"""EE / PFE of a FlexiCall (k-of-n exercise rights) vs its right count.

Port of ``examples/ee_pfe_flexicall.py`` (reference
tests/exposure_tests/ee_pfe_flexicall.py): a strip of European calls where
only k of the n exercise opportunities may be used — exposure interpolates
between the single-best-right and the full-strip profiles as k grows.  The
paths come from K2 (Black-Scholes exact).

Run: python examples_torch/ee_pfe_flexicall.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot)
from montecarlo_risk_engine_tpu_torch import (
    BlackScholesModel,
    Equity,
    EuropeanOption,
    FlexiCall,
    OptionType,
    resolve_device,
)


def _run(num_rights, timeline, num_paths, device=None):
    model = BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.25, asset_id="eq")
    strip = [
        EuropeanOption(Equity("eq"), t, 100.0, OptionType.CALL, asset_id="eq")
        for t in (1.0, 1.5, 2.0, 2.5)
    ]
    flexi = FlexiCall(strip, num_exercise_rights=num_rights, asset_id="eq")
    return run_exposure_book(model, [flexi], timeline, num_paths=num_paths,
                             ns_name="flexi", device=device)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline = np.linspace(0.25, 2.4, 10)
    n = len(timeline)
    curves = {}
    for k in (1, 2, 4):
        results = _run(k, timeline, num_paths, device)
        curves[f"EE ({k} rights)"] = profile(results, "flexi", "epe", n)
    print_profile_table(timeline, curves)
    # more rights => more exposure, pointwise up to MC noise at t=0.25
    assert curves["EE (4 rights)"][0] >= curves["EE (1 rights)"][0] - 1e-9
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_flexicall.png", timeline, curves,
            "FlexiCall — EE vs number of exercise rights",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
