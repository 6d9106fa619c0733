"""Exposure profiles (EPE / ENE / PFE) for a payer swap under Vasicek.

Port of ``examples/ee_pfe_swap_profiles.py`` (the reference demo scripts
in tests/exposure_tests/, e.g. ee_pfe_swap_collateralized.py): prints the
exposure profile table for an uncollateralized vs a collateralized (MPoR)
netting set.  The paths come from K2 (Vasicek exact).

Run: python examples_torch/ee_pfe_swap_profiles.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_risk_engine_tpu_torch import (
    ENEMetric,
    EPEMetric,
    InterestRateSwap,
    IRSType,
    NettingSet,
    PFEMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    VasicekModel,
    resolve_device,
)


def run(margin_period_of_risk=None, num_paths=50_000, device=None):
    model = VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                         volatility=0.012, asset_id="irs")
    swap = InterestRateSwap(0.0, 5.0, notional=100.0, fixed_rate=0.032,
                            tenor_fixed=0.5, tenor_float=0.5,
                            irs_type=IRSType.PAYER, asset_id="irs")
    timeline = np.linspace(0.0, 5.0, 21)
    controller = SimulationController(
        netting_sets=[NettingSet(name="swap_ns", products=[swap],
                                 margin_period_of_risk=margin_period_of_risk)],
        model=model,
        risk_metrics=RiskMetrics(metrics=[EPEMetric(), ENEMetric(), PFEMetric(0.95)],
                                 exposure_timeline=timeline),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=2,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    return timeline, results


def main(num_paths=50_000, device=None):
    device = resolve_device(device)
    profiles = {}
    for label, mpor in (("uncollateralized", None), ("collateralized MPoR=0.25", 0.25)):
        timeline, results = run(mpor, num_paths, device)
        epe = results.get_results("swap_ns", "epe")
        ene = results.get_results("swap_ns", "ene")
        pfe = results.get_results("swap_ns", "pfe[0.95]")
        print(f"\n== {label} ==")
        print(f"{'t':>6} {'EPE':>10} {'ENE':>10} {'PFE95':>10}")
        for t, a, b, c in zip(timeline, epe, ene, pfe):
            print(f"{t:6.2f} {a:10.4f} {b:10.4f} {c:10.4f}")
        profiles[label] = {"epe": np.asarray(epe), "ene": np.asarray(ene),
                           "pfe": np.asarray(pfe)}
    return profiles


if __name__ == "__main__":
    main()
