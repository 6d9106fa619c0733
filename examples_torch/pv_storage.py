"""Gas-storage PV: intrinsic (zero-vol) value vs extrinsic optionality.

Port of ``examples/pv_storage.py`` (reference tests/pv_tests/pv_storage.py):
the DP rollout on a zero-volatility Schwartz-2F model reproduces the
intrinsic calendar-spread value of the forward curve; turning volatility on
adds extrinsic value, which grows monotonically with vol.  The paths come
from K2 (Schwartz-2F Euler).

Run: python examples_torch/pv_storage.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    NettingSet,
    PVMetric,
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
    cfg.add_volume_constraint(0.0, 91.0, 0.0, 100.0, 0.0)
    cfg.add_injection_flexibility(0.0, 91.0, 0.0, 4.0)
    cfg.add_withdrawal_flexibility(0.0, 91.0, 0.0, 4.0)
    cfg.add_variable_injection_cost(0.0, 0.2)
    cfg.add_variable_withdrawal_cost(0.0, 0.2)
    return Storage(asset_id="gas", start_date=0.0, end_date=90.0,
                   initial_amount=0.0, storage_config=cfg, num_states=11,
                   rollout_interval=3.0)


def run(vol_scale, num_paths, device=None):
    model = SchwartzTwoFactorModel(
        calibration_date=0.0,
        curve_times=[0.0, 30.0, 60.0, 90.0],
        curve_values=[90.0, 98.0, 106.0, 95.0],
        rate=0.0,
        short_term_mean_reversion=1.5 / 365.0,
        short_term_vol=vol_scale * 0.2 / np.sqrt(365.0),
        long_term_drift=0.0,
        long_term_vol=vol_scale * 0.08 / np.sqrt(365.0),
        rho=0.2,
        asset_id="gas",
    )
    controller = SimulationController(
        netting_sets=[NettingSet(name="storage", products=[build_storage()])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.EULER,
        device=device,
    )
    results = controller.run_simulation()
    return (float(results.get_results("storage", "pv", evaluation_idx=0)),
            float(results.get_mc_error("storage", "pv", evaluation_idx=0)))


def main(num_paths=8_000, save_plot=True, device=None):
    device = resolve_device(device)
    scales = [0.0, 0.5, 1.0, 1.5]
    pvs = []
    for s in scales:
        n = 64 if s == 0.0 else num_paths  # zero vol: paths are identical
        pv, se = run(s, n, device)
        pvs.append(pv)
        print(f"vol scale={s:.1f}  pv={pv:9.4f} +- {se:.4f}")
    intrinsic = pvs[0]
    print(f"intrinsic (zero-vol) value {intrinsic:.4f}; "
          f"extrinsic at full vol {pvs[2] - intrinsic:.4f}")
    assert all(b > a - 0.5 for a, b in zip(pvs, pvs[1:])), pvs
    if save_plot:
        path = save_profile_plot(
            "pv_storage.png", scales, {"storage PV": np.array(pvs)},
            "Gas storage — intrinsic value + extrinsic optionality vs volatility",
            ylabel="PV",
        )
        print(f"saved {path}")
        return path
    return pvs


if __name__ == "__main__":
    main()
