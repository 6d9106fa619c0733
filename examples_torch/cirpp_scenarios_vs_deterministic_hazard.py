"""CIR++ survival-probability scenarios vs the deterministic hazard curve.

Port of ``examples/cirpp_scenarios_vs_deterministic_hazard.py`` (reference
tests/exposure_tests/cirpp_scenarios_vs_deterministic_hazard.py): simulated
pathwise survival probabilities S(0,t) = exp(-int lambda) under the
stochastic CIR++ intensity average onto the market curve implied by the
bootstrapped piecewise-constant hazards (the shift psi(t) guarantees the
calibration); the deterministic mode tracks the curve exactly.  The paths
come from the engine (``simulate_paths``) on ``device``.

Run: python examples_torch/cirpp_scenarios_vs_deterministic_hazard.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import print_profile_table, save_profile_plot
from montecarlo_risk_engine_tpu_torch import CIRPPModel, SimulationScheme, resolve_device, rng
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.helpers.cs_helper import probability_of_default

HAZARDS = {1.0: 0.02, 2.0: 0.016, 3.0: 0.024, 5.0: 0.03, 10.0: 0.012}


def survival_curve(model, timeline, num_paths, device=None):
    device = resolve_device(device)
    params = model.initial_params(device=device)
    states = simulate_paths(
        model, params, SimulationScheme.EULER, list(timeline), num_paths,
        4, rng.PHASE_MAINSIM, device=device,
    )
    # state = [y, log_B] with log_B = integrated intensity
    log_b = states[:, :, 1].cpu().numpy()
    return np.exp(-log_b).mean(axis=1), np.exp(-log_b)


def main(num_paths=20_000, save_plot=True, device=None):
    device = resolve_device(device)
    timeline = np.linspace(0.5, 5.0, 10)
    stoch = CIRPPModel(0.0, asset_id="cp", hazard_rates=HAZARDS, kappa=0.4,
                       theta=0.02, volatility=0.06, y0=0.015)
    det = CIRPPModel(0.0, asset_id="cp", hazard_rates=HAZARDS, kappa=0.4,
                     theta=0.02, volatility=0.06, y0=0.015, deterministic=True)
    tenors = sorted(HAZARDS)
    hazard_vals = torch.tensor([HAZARDS[t] for t in tenors], dtype=torch.float64, device=device)
    tenors = torch.tensor(tenors, dtype=torch.float64, device=device)
    market = np.array([
        1.0 - float(probability_of_default(hazard_vals, tenors, t))
        for t in timeline
    ])
    mean_stoch, paths = survival_curve(stoch, timeline, num_paths, device)
    mean_det, _ = survival_curve(det, timeline, 8, device)
    curves = {
        "market curve": market,
        "CIR++ MC mean": mean_stoch,
        "deterministic mode": mean_det,
        "scenario q05": np.quantile(paths, 0.05, axis=1),
        "scenario q95": np.quantile(paths, 0.95, axis=1),
    }
    print_profile_table(timeline, curves)
    assert np.allclose(mean_det, market, atol=2e-3), (mean_det, market)
    assert np.abs(mean_stoch - market).max() < 0.01
    if save_plot:
        path = save_profile_plot(
            "cirpp_scenarios_vs_deterministic_hazard.png", timeline, curves,
            "CIR++ survival scenarios vs the bootstrapped market curve",
            ylabel="S(0, t)",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
