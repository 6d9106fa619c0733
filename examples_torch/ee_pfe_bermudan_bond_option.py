"""EE / PFE of a Bermudan option on a zero-coupon bond under Vasicek.

Port of ``examples/ee_pfe_bermudan_bond_option.py`` (reference
tests/exposure_tests/ee_pfe_bermudan_bond_option.py): rates-driven early
exercise — the option exercises into the bond when short rates fall, and
the exposure profile collapses at the final exercise date.  The paths come
from K2 (Vasicek exact).

Run: python examples_torch/ee_pfe_bermudan_bond_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot, vasicek_model)
from montecarlo_risk_engine_tpu_torch import BermudanOption, Bond, OptionType, resolve_device


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    model = vasicek_model()
    bond = Bond(startdate=0.0, maturity=6.0, notional=1.0, tenor=6.0,
                pays_notional=True, fixed_rate=0.0, asset_id="irs")
    option = BermudanOption(bond, exercise_dates=[1.0, 2.0, 3.0], strike=0.85,
                            option_type=OptionType.CALL, asset_id="irs")
    timeline = np.linspace(0.25, 3.0, 12)
    results = run_exposure_book(model, [option], timeline, num_paths=num_paths,
                                num_steps=2, ns_name="bondopt", device=device)
    n = len(timeline)
    curves = {
        "EE": profile(results, "bondopt", "epe", n),
        "PFE 95%": profile(results, "bondopt", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    assert curves["PFE 95%"].max() >= curves["EE"].max() > 0.0
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_bermudan_bond_option.png", timeline, curves,
            "Bermudan zero-bond call under Vasicek — EE / PFE",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
