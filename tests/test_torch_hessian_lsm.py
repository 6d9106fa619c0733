"""Hessians through the LSM exposure fits against the JAX package: the
CVA book of tests/test_cva.py:118 (a payer swap under Vasicek with a CIR++
counterparty, CVA on 9 dates, EULER) at 512 + 512 paths on the JAX
engine's draws, rtol 1e-9, on the reverse branch (CVA alone, P = 8 > V =
1) and the forward branch (with EPE, V = 10).  The fits carry both tangent
levels."""

import numpy as np
import pytest
import torch

from test_torch_hessian import check_against_jax

torch.set_num_threads(1)

CP = "cp"
HAZARDS = {1.0: 0.02, 2.0: 0.025, 3.0: 0.03, 5.0: 0.035}


def cva_book(pkg):
    """tests/test_cva.py:118-135: a payer swap under Vasicek with a CIR++
    counterparty, CVA on 9 dates, EULER: reverse branch through the LSM
    exposure fits (P = 8 > V = 1)."""
    rates = pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                             volatility=0.012, asset_id="irs")
    credit = pkg.CIRPPModel(0.0, asset_id=CP, hazard_rates=HAZARDS, kappa=0.1, theta=0.01,
                            volatility=0.02, y0=0.0001)
    model = pkg.ModelConfig([rates, credit], inter_asset_correlation_matrix=[np.array([[0.2]])])
    swap = pkg.InterestRateSwap(0.0, 2.0, 1.0, 0.03, 0.5, 0.5, pkg.IRSType.PAYER, asset_id="irs")
    metrics = pkg.RiskMetrics([pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4)],
                              exposure_timeline=np.linspace(0.0, 2.0, 9))
    return [pkg.NettingSet(name="b", products=[swap], counterparty_id=CP)], model, metrics


def cva_epe_book(pkg):
    """The CVA book with EPE on its 9 dates too: the forward branch through
    the LSM fits (P = 8 <= V = 10)."""
    netting_sets, model, metrics = cva_book(pkg)
    metrics = pkg.RiskMetrics(metrics.metrics + [pkg.EPEMetric()],
                              exposure_timeline=np.linspace(0.0, 2.0, 9))
    return netting_sets, model, metrics


# (book, scheme, sub-steps, presim paths, noise dimension, grad mode)
BOOKS = {
    "cva_book_rev": (cva_book, "EULER", 1, 512, 2, "rev"),
    "cva_epe_book_fwd": (cva_epe_book, "EULER", 1, 512, 2, "fwd"),
}


@pytest.mark.parametrize("name", list(BOOKS))
def test_lsm_hessian_matches_jax_on_injected_noise(name):
    # the JAX controller runs per product (JAX_FLAGS), so the port does too:
    # the batched power-sum fit differs from the per-product fit by rounding
    check_against_jax(*BOOKS[name], batch_products=False)
