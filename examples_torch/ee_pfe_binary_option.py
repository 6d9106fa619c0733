"""EE / PFE of a cash-or-nothing digital call — bounded exposure.

Port of ``examples/ee_pfe_binary_option.py`` (reference
tests/exposure_tests/ee_pfe_binary_option.py): the digital payoff bounds
exposure by the payment amount, so the PFE saturates at the (discounted)
payment while EE tracks the risk-neutral digital price.  The paths come
from K2 (Black-Scholes exact).

Run: python examples_torch/ee_pfe_binary_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot)
from montecarlo_risk_engine_tpu_torch import (
    BinaryOption,
    BlackScholesModel,
    OptionType,
    resolve_device,
)

PAYMENT = 10.0


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    model = BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.25, asset_id="eq")
    option = BinaryOption(2.0, 100.0, payment_amount=PAYMENT,
                          option_type=OptionType.CALL, asset_id="eq")
    timeline = np.linspace(0.2, 1.8, 9)
    results = run_exposure_book(model, [option], timeline, num_paths=num_paths,
                                ns_name="digital", device=device)
    n = len(timeline)
    curves = {
        "EE": profile(results, "digital", "epe", n),
        "PFE 95%": profile(results, "digital", "pfe[0.95]", n),
        "discounted payment cap": PAYMENT * np.exp(-0.03 * 2.0) * np.ones(n),
    }
    print_profile_table(timeline, curves)
    # The polynomial continuation fit overshoots the saturating payoff at the
    # upper quantile (the PFE curve shows the regression-model dependence);
    # the MEAN exposure is unbiased, so EE respects the structural cap.
    cap = curves["discounted payment cap"]
    assert (curves["EE"] <= cap + 1e-6).all()
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_binary_option.png", timeline, curves,
            "Digital call — exposure bounded by the discounted payment",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
