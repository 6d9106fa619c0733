"""Storage inventory trajectory under the LSM/DP exercise policy.

Port of ``examples/storage_volume_over_time.py`` (reference
tests/exposure_tests/storage_volume_over_time.py): simulates the optimal
inject/withdraw/hold policy and plots the mean, q05 and q95 inventory paths
over the rollout horizon — the seasonal forward curve pulls injection into
the cheap months and withdrawal into the expensive ones.  The paths come
from K2 (Schwartz-2F Euler).

Run: python examples_torch/storage_volume_over_time.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    NettingSet,
    PVMetric,
    RiskMetrics,
    SchwartzTwoFactorModel,
    SimulationController,
    SimulationScheme,
    Storage,
    StorageConfig,
    resolve_device,
)


def build_storage():
    cfg = StorageConfig()
    cfg.add_volume_constraint(0.0, 91.0, 0.0, 100.0, 0.0)
    cfg.add_injection_flexibility(0.0, 91.0, 0.0, 4.0)
    cfg.add_withdrawal_flexibility(0.0, 91.0, 0.0, 4.0)
    cfg.add_variable_injection_cost(0.0, 0.2)
    cfg.add_variable_withdrawal_cost(0.0, 0.2)
    return Storage(asset_id="gas", start_date=0.0, end_date=90.0,
                   initial_amount=0.0, storage_config=cfg, num_states=11,
                   rollout_interval=3.0)


def main(num_paths=8_000, save_plot=True, device=None):
    device = resolve_device(device)
    storage = build_storage()
    model = SchwartzTwoFactorModel(
        calibration_date=0.0,
        curve_times=[0.0, 30.0, 60.0, 90.0],
        curve_values=[90.0, 98.0, 106.0, 95.0],
        rate=0.0,
        short_term_mean_reversion=1.5 / 365.0,
        short_term_vol=0.2 / np.sqrt(365.0),
        long_term_drift=0.0,
        long_term_vol=0.08 / np.sqrt(365.0),
        rho=0.2,
        asset_id="gas",
    )
    controller = SimulationController(
        netting_sets=[NettingSet(name="storage", products=[storage])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.EULER,
        device=device,
    )
    states = controller.simulate_exercise_states(storage)  # [T_prod, N] grid coords
    dates = np.array(storage.product_timeline)
    volumes = np.stack([
        np.asarray(storage.state_to_volume(float(d), states[i]))
        for i, d in enumerate(dates)
    ])
    curves = {
        "mean volume": volumes.mean(axis=1),
        "q05": np.quantile(volumes, 0.05, axis=1),
        "q95": np.quantile(volumes, 0.95, axis=1),
    }
    print_profile_table(dates, curves)
    # the policy must actually move gas: some injection happens, and the
    # terminal inventory drains back toward empty on the falling curve tail
    assert curves["mean volume"].max() > 1.0
    assert curves["mean volume"][-1] < curves["mean volume"].max()
    if save_plot:
        path = save_profile_plot(
            "storage_volume_over_time.png", dates, curves,
            "Gas storage — inventory under the LSM/DP policy",
            ylabel="volume",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
