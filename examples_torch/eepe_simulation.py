"""EEPE of a payer swap: the time-averaged expected exposure scalar.

Port of ``examples/eepe_simulation.py`` (reference
tests/exposure_tests/eepe_simulation.py): EEPE is the plain time-average of
the EE profile (quirk Q6: no regulatory running-max step, preserved
deliberately); overlays the EE profile with the EEPE level line.  The paths
come from K2 (Vasicek exact).

Run: python examples_torch/eepe_simulation.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import (print_profile_table, profile, run_exposure_book,
                                    save_profile_plot, vasicek_model)
from montecarlo_risk_engine_tpu_torch import (
    EEPEMetric,
    EPEMetric,
    InterestRateSwap,
    IRSType,
    resolve_device,
)


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    model = vasicek_model()
    swap = InterestRateSwap(0.0, 5.0, notional=100.0, fixed_rate=0.032,
                            tenor_fixed=0.5, tenor_float=0.5,
                            irs_type=IRSType.PAYER, asset_id="irs")
    timeline = np.linspace(0.25, 4.75, 19)
    results = run_exposure_book(
        model, [swap], timeline, metrics=[EPEMetric(), EEPEMetric()],
        num_paths=num_paths, num_steps=2, ns_name="swap", device=device,
    )
    n = len(timeline)
    ee = profile(results, "swap", "epe", n)
    eepe = float(results.get_results("swap", "eepe", evaluation_idx=0))
    curves = {"EE": ee, "EEPE (time average)": np.full(n, eepe)}
    print_profile_table(timeline, curves)
    assert abs(eepe - ee.mean()) < 1e-8 * max(1.0, abs(eepe)), (eepe, ee.mean())
    if save_plot:
        path = save_profile_plot(
            "eepe_simulation.png", timeline, curves,
            "Payer swap — EE profile and its EEPE time-average",
        )
        print(f"saved {path}")
        return path
    return eepe


if __name__ == "__main__":
    main()
