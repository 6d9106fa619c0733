"""CVA of a zero-coupon corporate bond vs the analytic expected loss.

Port of ``examples/cva_corporate_bond.py`` (reference
tests/exposure_tests/cva_corporate_bond.py): with deterministic credit
(CIR++ in deterministic mode tracking the bootstrapped hazard curve) the
CVA telescopes to (1-R)(1-S(0,T))*P — the MC estimate must sit on the
closed form; sweeps recovery to show the linear (1-R) scaling.  The paths
come from K2 (a ModelConfig of Vasicek and deterministic CIR++, Euler).

Run: python examples_torch/cva_corporate_bond.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    Bond,
    CIRPPModel,
    CVAMetric,
    ModelConfig,
    NettingSet,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    VasicekModel,
    resolve_device,
)
from montecarlo_risk_engine_tpu_torch.helpers.cs_helper import probability_of_default

HAZARDS = {1.0: 0.015, 2.0: 0.012, 3.0: 0.018, 5.0: 0.022, 10.0: 0.008}
CP = "corp"
MATURITY = 4.0


def controller(recovery, num_paths, device=None):
    """The bond's CVA book at one recovery rate: (controller, metric)."""
    rates = VasicekModel(0.0, rate=0.03, mean=0.04, mean_reversion_speed=0.3,
                         volatility=0.01, asset_id="irs")
    credit = CIRPPModel(0.0, asset_id=CP, hazard_rates=HAZARDS, kappa=0.1,
                        theta=0.01, volatility=0.02, y0=0.0001,
                        deterministic=True)
    model = ModelConfig([rates, credit],
                        inter_asset_correlation_matrix=[np.array([[0.0]])])
    bond = Bond(startdate=0.0, maturity=MATURITY, notional=1.0, tenor=MATURITY,
                pays_notional=True, fixed_rate=0.0, asset_id="irs")
    cva_metric = CVAMetric(counterparty_id=CP, recovery_rate=recovery)
    return SimulationController(
        netting_sets=[NettingSet(name="bond", products=[bond], counterparty_id=CP)],
        model=model,
        risk_metrics=RiskMetrics(
            metrics=[cva_metric],
            exposure_timeline=np.linspace(0.0, MATURITY, 40),
        ),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=2,
        simulation_scheme=SimulationScheme.EULER,
        device=device,
    ), cva_metric


def run(recovery, num_paths, device=None):
    c, cva_metric = controller(recovery, num_paths, device)
    results = c.run_simulation()
    cva = float(results.get_results("bond", cva_metric.get_name(), evaluation_idx=0))
    se = float(results.get_mc_error("bond", cva_metric.get_name(), evaluation_idx=0))
    return cva, se


def main(num_paths=50_000, save_plot=True, device=None):
    device = resolve_device(device)
    tenors = sorted(HAZARDS)
    hazard_vals = [HAZARDS[t] for t in tenors]
    survival = 1.0 - float(probability_of_default(
        torch.tensor(hazard_vals, dtype=torch.float64, device=device),
        torch.tensor(tenors, dtype=torch.float64, device=device), MATURITY))
    # CVA = (1-R)(1-S) * E[D(0,T)]: compare shapes across recoveries.
    recoveries = [0.0, 0.2, 0.4, 0.6]
    cvas = []
    for rec in recoveries:
        cva, se = run(rec, num_paths, device)
        cvas.append(cva)
        print(f"recovery={rec:.1f}  CVA={cva:.6f} +- {se:.6f}")
    # linear in (1-R): CVA(R)/(1-R) constant
    scaled = [c / (1.0 - r) for c, r in zip(cvas, recoveries)]
    spread = max(scaled) - min(scaled)
    print(f"CVA/(1-R) across recoveries: {scaled} (spread {spread:.2e}); "
          f"1-S(0,{MATURITY}) = {1.0 - survival:.6f}")
    assert spread < 5e-4, scaled
    if save_plot:
        path = save_profile_plot(
            "cva_corporate_bond.png", recoveries,
            {"CVA": np.array(cvas),
             "(1-R) x CVA(0)": (1.0 - np.array(recoveries)) * cvas[0]},
            "Corporate-bond CVA — linear (1-R) scaling, deterministic credit",
            ylabel="CVA",
        )
        print(f"saved {path}")
        return path
    return cvas


if __name__ == "__main__":
    main()
