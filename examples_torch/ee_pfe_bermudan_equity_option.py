"""EE / PFE of a Bermudan equity put vs its European counterpart.

Port of ``examples/ee_pfe_bermudan_equity_option.py`` (reference
tests/exposure_tests/ee_pfe_bermudan_equity_option.py): before the first
exercise date the Bermudan exposure dominates the European (extra
optionality); after exercise dates it decays as rights are used.  The paths
come from K2 (Black-Scholes exact).

Run: python examples_torch/ee_pfe_bermudan_equity_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot)
from montecarlo_risk_engine_tpu_torch import (
    BermudanOption,
    BlackScholesModel,
    Equity,
    EuropeanOption,
    OptionType,
    resolve_device,
)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline = np.linspace(0.2, 2.8, 14)

    def run(product, name):
        model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.3, asset_id="eq")
        return run_exposure_book(model, [product], timeline,
                                 num_paths=num_paths, ns_name=name, device=device)

    bermudan = BermudanOption(Equity("eq"), [1.0, 1.5, 2.0, 2.5, 3.0], 100.0,
                              OptionType.PUT, asset_id="eq")
    european = EuropeanOption(Equity("eq"), 3.0, 100.0, OptionType.PUT, asset_id="eq")
    r_berm = run(bermudan, "berm")
    r_euro = run(european, "euro")
    n = len(timeline)
    curves = {
        "Bermudan EE": profile(r_berm, "berm", "epe", n),
        "European EE": profile(r_euro, "euro", "epe", n),
        "Bermudan PFE95": profile(r_berm, "berm", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    # extra rights => the Bermudan can't be worth less before the first date
    # (band allows LSM/MC noise at small path counts)
    assert curves["Bermudan EE"][0] > 0.85 * curves["European EE"][0]
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_bermudan_equity_option.png", timeline, curves,
            "Bermudan vs European put — EE / PFE (Black-Scholes)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
