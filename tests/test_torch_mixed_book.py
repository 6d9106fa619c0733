"""The books of the slice against the JAX package on the same numbers (f64,
the JAX engine's own threefry draws injected for both phases): the mixed PV
book of benchmarks/pv_large_book.py with every family kept, the CVA book of
benchmarks/cva_large_book.py at a small scale, and the swap + Bermudan xVA
book of the multichip dry run (__graft_entry__.py:155-194, without a mesh).
The books come from ``chip_smoke.py``'s builders, run once with the JAX
package's classes and once with the port's."""

import numpy as np
import pytest
import torch

import chip_smoke
import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")


def injected(jc, n, sim_dim, num_steps=1):
    return {phase: jax_engine_normals(0, phase, len(jc.simulation_timeline) * num_steps, n, sim_dim)
            for phase in (jax_rng.PHASE_PRESIM, jax_rng.PHASE_MAINSIM)}


def compare(pr, jr, differentiate, rtol_grads=1e-7):
    assert pr.get_netting_set_names() == jr.get_netting_set_names()
    assert pr.get_metric_names() == jr.get_metric_names()
    for ns in jr.get_netting_set_names():
        for metric in jr.get_metric_names():
            np.testing.assert_allclose(pr.get_results(ns, metric), jr.get_results(ns, metric),
                                       rtol=1e-9, atol=1e-13, err_msg=f"{ns} {metric}")
            np.testing.assert_allclose(pr.get_mc_error(ns, metric), jr.get_mc_error(ns, metric),
                                       rtol=1e-9, atol=1e-13, err_msg=f"{ns} {metric}")
            if differentiate:
                np.testing.assert_allclose(np.asarray(pr.get_derivatives(ns, metric)),
                                           np.asarray(jr.get_derivatives(ns, metric)),
                                           rtol=rtol_grads, atol=1e-10, err_msg=f"{ns} {metric}")


# Every family of the 50,000-product book at 1/2000: 27 products.
MIXED_SCALE = 0.0005


def test_mixed_book_builder_matches_the_benchmark():
    counts = chip_smoke.scaled_counts(chip_smoke.MIXED_COUNTS, MIXED_SCALE)
    assert counts == {"european": 19, "binary": 1, "basket": 1, "asian": 1, "barrier": 2,
                      "american": 1, "flexicall": 1, "storage": 1}
    full = chip_smoke.build_book(list(chip_smoke.ASSETS), chip_smoke.MIXED_COUNTS, mj)
    assert sum(len(v) for v in full.values()) == 50_000
    assert chip_smoke.scaled_counts(chip_smoke.CVA_COUNTS, 1.0) == {
        "european": 3940, "binary": 100, "basket": 100, "asian": 200, "barrier": 400,
        "american": 180, "flexicall": 70, "storage": 10}
    storages = full["storage"]
    assert len({(s.end_date, s.rollout_interval, s.num_states) for s in storages}) == 60


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_mixed_book_matches_jax_controller(differentiate):
    n = 256
    counts = chip_smoke.scaled_counts(chip_smoke.MIXED_COUNTS, MIXED_SCALE)
    jc = mj.SimulationController(*chip_smoke.mixed_book_parts(counts, True, mj), n, n, 1,
                                 mj.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 **JAX_FLAGS)
    jr = jc.run_simulation()
    pc = mt.SimulationController(*chip_smoke.mixed_book_parts(counts, True), n, n, 1,
                                 mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 device="cpu", noise_source=injected(jc, n, 4))
    assert pc.simulation_timeline == jc.simulation_timeline
    assert len(pc.products) == 27 and family_names(pc) == list(counts)
    pr = pc.run_simulation()
    if differentiate:
        assert pc._grad_mode_resolved == "rev"  # P = 9 > V = 8
    compare(pr, jr, differentiate)


def family_names(c):
    return [ns.get_name() for ns in c.netting_sets]


def test_cva_book_matches_jax_controller():
    """The CVA book (ModelConfig of BS-multi and CIR++, EULER, MPoR 10/252,
    CVA) at 1/500 of its 5,000 products (one of each family but 7
    Europeans), forward, on 4 of its 80 dates (7 with the MPoR query dates):
    the JAX program unrolls every product's fit per date, and 80 dates take
    it minutes to compile."""
    n = 256
    jc = mj.SimulationController(*chip_smoke.cva_book_parts(0.002, mj, num_dates=4), n, n, 1,
                                 mj.SimulationScheme.EULER, **JAX_FLAGS)
    jr = jc.run_simulation()
    pc = mt.SimulationController(*chip_smoke.cva_book_parts(0.002, num_dates=4), n, n, 1,
                                 mt.SimulationScheme.EULER, device="cpu",
                                 noise_source=injected(jc, n, 5))
    assert len(pc.products) == 14 and len(pc.exposure_timeline) == len(jc.exposure_timeline) == 7
    pr = pc.run_simulation()
    assert float(pr.get_results("cva_book", f"cva[{chip_smoke.CP}]", evaluation_idx=0)) > 0
    compare(pr, jr, False)


def dry_run_book(pkg):
    """__graft_entry__.py:155-194: a Vasicek payer swap and a Bermudan put on
    a ModelConfig of Vasicek, Black-Scholes and CIR++; MPoR 0.25; CVA, EPE
    and PFE(0.95) on 5 dates."""
    rates = pkg.VasicekModel(0.0, rate=0.03, mean=0.04, mean_reversion_speed=0.5, volatility=0.01,
                             asset_id="irs")
    equity = pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    credit = pkg.CIRPPModel(0.0, asset_id="cp", hazard_rates={1.0: 0.02, 3.0: 0.025, 5.0: 0.03},
                            kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)
    model = pkg.ModelConfig([rates, equity, credit], inter_asset_correlation_matrix=[
        np.array([[0.3]]), np.array([[0.5]]), np.array([[0.2]])])
    swap = pkg.InterestRateSwap(0.0, 2.0, notional=1.0, fixed_rate=0.03, tenor_fixed=0.5,
                                tenor_float=0.5, irs_type=pkg.IRSType.PAYER, asset_id="irs")
    bermudan = pkg.BermudanOption(pkg.Equity("eq"), [0.5, 1.0, 1.5], 100.0, pkg.OptionType.PUT,
                                  asset_id="eq")
    netting_set = pkg.NettingSet(name="book", products=[swap, bermudan], counterparty_id="cp",
                                 margin_period_of_risk=0.25)
    metrics = pkg.RiskMetrics(metrics=[pkg.CVAMetric(counterparty_id="cp", recovery_rate=0.4),
                                       pkg.EPEMetric(), pkg.PFEMetric(0.95)],
                              exposure_timeline=np.linspace(0.0, 2.0, 5))
    return [netting_set], model, metrics


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_dry_run_book_matches_jax_controller(differentiate):
    n = 256
    jc = mj.SimulationController(*dry_run_book(mj), n, n, 1, mj.SimulationScheme.EULER,
                                 differentiate=differentiate, **JAX_FLAGS)
    jr = jc.run_simulation()
    pc = mt.SimulationController(*dry_run_book(mt), n, n, 1, mt.SimulationScheme.EULER,
                                 differentiate=differentiate, device="cpu",
                                 noise_source=injected(jc, n, 3), batch_products=False)
    pr = pc.run_simulation()
    if differentiate:
        assert pc._grad_mode_resolved == "fwd"  # P = 11 <= V = 1 + 5 + 5
    compare(pr, jr, differentiate)
