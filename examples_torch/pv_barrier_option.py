"""Barrier option: discrete monitoring + Brownian-bridge correction vs analytic.

Port of ``examples/pv_barrier_option.py`` (reference
tests/pv_tests/pv_barrier_option.py): an up-and-out call priced by discrete
monitoring converges to the continuous-barrier analytic value only slowly in
the number of observation dates; the Brownian-bridge crossing correction
removes most of the discretisation bias at every monitoring frequency.  The
paths come from K2 (Black-Scholes exact).

Run: python examples_torch/pv_barrier_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    BarrierOption,
    BarrierOptionType,
    BlackScholesModel,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)


def run(n_obs, use_bridge, num_paths, device=None):
    device = resolve_device(device)
    model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2, asset_id="eq")
    option = BarrierOption(
        startdate=0.0, maturity=2.0, strike=100.0,
        num_observation_timepoints=n_obs, option_type=OptionType.CALL,
        barrier1=130.0, barrier_option_type1=BarrierOptionType.UPANDOUT,
        asset_id="eq",
    )
    if use_bridge:
        option.set_use_brownian_bridge()
    controller = SimulationController(
        netting_sets=[NettingSet(name="barrier", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=0,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    pv = float(results.get_results("barrier", "pv", evaluation_idx=0))
    analytic = float(option.compute_pv_analytically(model, model.initial_params(device=device)))
    return pv, analytic


def main(num_paths=100_000, save_plot=True, device=None):
    device = resolve_device(device)
    obs_counts = np.array([5, 10, 20, 40])
    discrete, bridged, analytic = [], [], None
    for n in obs_counts:
        pv_d, analytic = run(int(n), False, num_paths, device)
        pv_b, _ = run(int(n), True, num_paths, device)
        discrete.append(pv_d)
        bridged.append(pv_b)
    curves = {
        "discrete monitoring": np.array(discrete),
        "with Brownian bridge": np.array(bridged),
        "continuous analytic": np.full(len(obs_counts), analytic),
    }
    print_profile_table(obs_counts, curves)
    if save_plot:
        path = save_profile_plot(
            "pv_barrier_option.png", obs_counts, curves,
            "Up-and-out call — Brownian-bridge correction vs monitoring count",
            ylabel="PV",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
