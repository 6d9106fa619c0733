"""EE / PFE of a European payer swaption under Vasicek.

Port of ``examples/ee_pfe_swaption.py`` (reference
tests/exposure_tests/ee_pfe_swaption.py): optionality keeps the
pre-exercise exposure strictly positive (an option can't be a liability),
and after physical exercise the profile hands over to the swap's.  The
paths come from K2 (Vasicek exact).

Run: python examples_torch/ee_pfe_swaption.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot, vasicek_model)
from montecarlo_risk_engine_tpu_torch import (
    ENEMetric,
    EPEMetric,
    EuropeanOption,
    InterestRateSwap,
    IRSType,
    OptionType,
    PFEMetric,
    resolve_device,
)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    model = vasicek_model()
    swap = InterestRateSwap(1.0, 5.0, notional=100.0, fixed_rate=0.032,
                            tenor_fixed=0.5, tenor_float=0.5,
                            irs_type=IRSType.PAYER, asset_id="irs")
    swaption = EuropeanOption(swap, exercise_date=1.0, strike=0.0,
                              option_type=OptionType.CALL, asset_id="irs")
    timeline = np.linspace(0.1, 4.75, 20)
    results = run_exposure_book(
        model, [swaption], timeline,
        metrics=[EPEMetric(), ENEMetric(), PFEMetric(0.95)],
        num_paths=num_paths, num_steps=2, ns_name="swaption", device=device,
    )
    n = len(timeline)
    curves = {
        "EE": profile(results, "swaption", "epe", n),
        "ENE": profile(results, "swaption", "ene", n),
        "PFE 95%": profile(results, "swaption", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    # before exercise the holder has pure optionality: negative exposure is
    # regression noise only, tiny relative to EE
    pre = timeline < 1.0
    assert (np.abs(curves["ENE"][pre]) < 0.05 * curves["EE"].max() + 1e-6).all()
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_swaption.png", timeline, curves,
            "European payer swaption — EE / ENE / PFE (Vasicek)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
