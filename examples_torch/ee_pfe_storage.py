"""Gas-storage exposure profile (Schwartz-2F).

Port of ``examples/ee_pfe_storage.py`` (reference
tests/exposure_tests/ee_pfe_storage.py): EE/PFE of a storage deal under
the DP policy, with a saved plot.  The paths come from K2 (Schwartz-2F
Euler).

Run: python examples_torch/ee_pfe_storage.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, profile, save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    EPEMetric,
    NettingSet,
    PFEMetric,
    RiskMetrics,
    SchwartzTwoFactorModel,
    SimulationController,
    SimulationScheme,
    resolve_device,
)
from montecarlo_risk_engine_tpu_torch.products.storage import Storage
from montecarlo_risk_engine_tpu_torch.products.storage_config import StorageConfig


def build_storage():
    cfg = StorageConfig()
    cfg.add_volume_constraint(0.0, 91.0, 0.0, 120.0, 0.0)
    cfg.add_injection_flexibility(0.0, 91.0, 0.0, 5.0)
    cfg.add_injection_flexibility(0.0, 91.0, 80.0, 3.0)
    cfg.add_withdrawal_flexibility(0.0, 91.0, 0.0, 2.0)
    cfg.add_withdrawal_flexibility(0.0, 91.0, 80.0, 6.0)
    cfg.add_variable_injection_cost(0.0, 0.25)
    cfg.add_variable_withdrawal_cost(0.0, 0.10)
    return Storage(asset_id="gas", start_date=0.0, end_date=90.0,
                   initial_amount=0.0, storage_config=cfg, num_states=10,
                   rollout_interval=3.0)


def main(num_paths=20_000, save_plot=True, device=None):
    device = resolve_device(device)
    storage = build_storage()
    model = SchwartzTwoFactorModel(
        calibration_date=0.0,
        curve_times=[0.0, 30.0, 60.0, 90.0],
        curve_values=[92.0, 96.0, 104.0, 99.0],
        rate=0.0,
        short_term_mean_reversion=1.5 / 365.0,
        short_term_vol=0.18 / np.sqrt(365.0),
        long_term_drift=0.0,
        long_term_vol=0.08 / np.sqrt(365.0),
        rho=0.2,
        asset_id="gas",
    )
    timeline = np.linspace(6.0, 87.0, 28)
    controller = SimulationController(
        netting_sets=[NettingSet(name="storage", products=[storage])],
        model=model,
        risk_metrics=RiskMetrics(
            metrics=[EPEMetric(), PFEMetric(0.95)], exposure_timeline=timeline
        ),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.EULER,
        device=device,
    )
    results = controller.run_simulation()
    n = len(timeline)
    curves = {
        "EE": profile(results, "storage", "epe", n),
        "PFE 95%": profile(results, "storage", "pfe[0.95]", n),
    }
    print_profile_table(timeline, curves)
    if save_plot:
        path = save_profile_plot(
            "ee_pfe_storage.png", timeline / 365.0, curves,
            "Gas storage — EE / PFE (Schwartz two-factor)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
