"""Storage constraint-propagation optimizer: initial vs tightened volume bounds.

Port of ``examples/storage_volume_constraints.py`` (reference
tests/exposure_tests/storage_volume_constraints.py): the forward-reachability
optimizer (products/storage_config.py) tightens the declared volume windows
so every state the DP can visit keeps a feasible continuation — e.g. a
mandated end-of-horizon inventory pulls the admissible band down ahead of
time at the withdrawal-rate slope.  Host-side only: no simulation, so
``device`` is only checked.

Run: python examples_torch/storage_volume_constraints.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, save_profile_plot
from montecarlo_risk_engine_tpu_torch import StorageConfig, resolve_device


def build_config():
    cfg = StorageConfig()
    # generous band for most of the horizon ...
    cfg.add_volume_constraint(0.0, 80.0, 0.0, 100.0, 0.0)
    # ... but the inventory must end in [40, 50]
    cfg.add_volume_constraint(80.0, 91.0, 40.0, 50.0, 0.0)
    cfg.add_injection_flexibility(0.0, 91.0, 0.0, 3.0)
    cfg.add_withdrawal_flexibility(0.0, 91.0, 0.0, 2.0)
    return cfg


def main(num_paths=None, save_plot=True, device=None):
    resolve_device(device)
    cfg = build_config()
    dates = []
    date = 0.0
    while date <= 90.0:
        dates.append(date)
        date += 3.0
    initial_lo = np.array([cfg.get_initial_volume_constraint(d).vmin for d in dates])
    initial_hi = np.array([cfg.get_initial_volume_constraint(d).vmax for d in dates])

    cfg.optimize_volume_constraints(0.0, 90.0, 3.0, initial_volume=0.0)
    opt_lo = np.array([cfg.get_volume_constraint(d).vmin for d in dates])
    opt_hi = np.array([cfg.get_volume_constraint(d).vmax for d in dates])

    curves = {
        "declared vmin": initial_lo,
        "declared vmax": initial_hi,
        "optimized vmin": opt_lo,
        "optimized vmax": opt_hi,
    }
    print_profile_table(np.array(dates), curves)
    # the optimizer only tightens, never widens
    assert (opt_lo >= initial_lo - 1e-9).all() and (opt_hi <= initial_hi + 1e-9).all()
    # reaching the mandated 40 at day 90 with 3/day injection caps early vmax
    assert opt_hi[0] <= initial_hi[0]
    # starting empty, injection at 3/day bounds how fast vmin can rise
    assert opt_lo[-1] >= 40.0 - 1e-9
    if save_plot:
        path = save_profile_plot(
            "storage_volume_constraints.png", np.array(dates), curves,
            "Storage volume windows — declared vs reachability-tightened",
            ylabel="volume",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
