"""CVA vs inter-asset correlation: a wrong-way-risk sweep.

Port of ``examples/cva_wwr_sweep.py`` (the reference demo
tests/exposure_tests/cva_interest_rate_swap.py, a CVA-vs-rho sweep): prices
the CVA of a payer swap under a hybrid Vasicek (rates) x CIR++ (credit)
model for a grid of rate-credit correlations.  The paths come from K2 (a
ModelConfig of Vasicek and CIR++, Euler).

Run: python examples_torch/cva_wwr_sweep.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_risk_engine_tpu_torch import (
    CIRPPModel,
    CVAMetric,
    InterestRateSwap,
    IRSType,
    ModelConfig,
    NettingSet,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    VasicekModel,
    resolve_device,
)

HAZARDS = {1.0: 0.02, 2.0: 0.022, 3.0: 0.025, 5.0: 0.028, 10.0: 0.02}
CP = "counterparty"
RHOS = (-0.9, -0.5, 0.0, 0.5, 0.9)


def controller(rho: float, num_paths=50_000, device=None):
    """The swap's CVA book at one rate-credit correlation: (controller,
    metric)."""
    rates = VasicekModel(0.0, rate=0.03, mean=0.05, mean_reversion_speed=0.05,
                         volatility=0.015, asset_id="irs")
    credit = CIRPPModel(0.0, asset_id=CP, hazard_rates=HAZARDS, kappa=0.1,
                        theta=0.01, volatility=0.02, y0=0.0001)
    model = ModelConfig([rates, credit],
                        inter_asset_correlation_matrix=[np.array([[rho]])])
    swap = InterestRateSwap(0.0, 5.0, notional=100.0, fixed_rate=0.03,
                            tenor_fixed=0.25, tenor_float=0.25,
                            irs_type=IRSType.PAYER, asset_id="irs")
    metric = CVAMetric(counterparty_id=CP, recovery_rate=0.4)
    return SimulationController(
        netting_sets=[NettingSet(name="ns", products=[swap], counterparty_id=CP)],
        model=model,
        risk_metrics=RiskMetrics(metrics=[metric],
                                 exposure_timeline=np.linspace(0.0, 5.0, 40)),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=2,
        simulation_scheme=SimulationScheme.EULER,
        device=device,
    ), metric


def cva_for_rho(rho: float, num_paths=50_000, device=None):
    c, metric = controller(rho, num_paths, device)
    results = c.run_simulation()
    return (
        float(results.get_results("ns", metric.get_name(), evaluation_idx=0)),
        float(results.get_mc_error("ns", metric.get_name(), evaluation_idx=0)),
    )


def main(num_paths=50_000, rhos=RHOS, device=None):
    device = resolve_device(device)
    print(f"{'rho':>6} {'CVA':>10} {'SE':>8}")
    out = {}
    for rho in rhos:
        cva, se = cva_for_rho(rho, num_paths, device)
        out[rho] = (cva, se)
        print(f"{rho:6.2f} {cva:10.5f} {se:8.5f}")
    return out


if __name__ == "__main__":
    main()
