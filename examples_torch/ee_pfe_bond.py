"""EE / PFE of a floating-rate note vs a fixed-coupon bond under Vasicek.

Port of ``examples/ee_pfe_bond.py`` (reference
tests/exposure_tests/ee_pfe_bond.py): the FRN resets to par at every coupon
date so its exposure hugs the notional, while the fixed-coupon bond's
exposure carries full duration risk of the short rate.  The paths come from
K2 (Vasicek exact).

Run: python examples_torch/ee_pfe_bond.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot, vasicek_model)
from montecarlo_risk_engine_tpu_torch import Bond, resolve_device


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline = np.linspace(0.1, 1.9, 10)

    def run(fixed_rate, name):
        model = vasicek_model()
        bond = Bond(startdate=0.0, maturity=2.0, notional=1.0, tenor=0.25,
                    pays_notional=True, fixed_rate=fixed_rate, asset_id="irs")
        return run_exposure_book(model, [bond], timeline, num_paths=num_paths,
                                 num_steps=4, ns_name=name, device=device)

    r_frn = run(None, "frn")
    r_fix = run(0.05, "coupon")
    n = len(timeline)
    curves = {
        "FRN EE": profile(r_frn, "frn", "epe", n),
        "coupon bond EE": profile(r_fix, "coupon", "epe", n),
        "FRN PFE95": profile(r_frn, "frn", "pfe[0.95]", n),
        "coupon PFE95": profile(r_fix, "coupon", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    # the FRN's PFE-EE band is tighter than the coupon bond's (par-reset)
    frn_band = (curves["FRN PFE95"] - curves["FRN EE"]).mean()
    fix_band = (curves["coupon PFE95"] - curves["coupon bond EE"]).mean()
    assert frn_band < fix_band, (frn_band, fix_band)
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_bond.png", timeline, curves,
            "FRN vs fixed-coupon bond — EE / PFE under Vasicek",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
