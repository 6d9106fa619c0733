"""The port's family batches (api/batching.py): the batched controller against
the port's own per-product path (the same paths, the same regression math,
only the evaluation layout changes) and against the JAX controller's batched
path on the JAX engine's injected draws, mirroring tests/test_batching.py on
its two-asset BS-multi book of every batched family in two netting sets."""

import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
from montecarlo_risk_engine_tpu import rng as jax_rng
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch.api import batching
from montecarlo_risk_engine_tpu_torch.api.controller import SimulationController
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

JAX_BATCHED = dict(use_pallas=False, batch_products=True, streaming=False,
                   metric_streaming=False, grad_mode="fwd")
DATES = list(np.linspace(0.0, 2.0, 7))


def book_model(pkg=mt):
    corr = np.array([[1.0, 0.35], [0.35, 1.0]])
    return pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=["a0", "a1"], spots=[95.0, 102.5],
                                 volatilities=[0.18, 0.21], correlation_matrix=corr)


def mixed_book(pkg=mt):
    """tests/test_batching.py's book: every batched family on two assets."""
    O = pkg.OptionType
    a = lambda i: f"a{i % 2}"
    products = [pkg.EuropeanOption(pkg.Equity(a(i)), 0.5 + 0.25 * i, 90.0 + 5 * i,
                                   O.CALL if i % 2 else O.PUT, asset_id=a(i)) for i in range(6)]
    products += [pkg.BinaryOption(0.5 + 0.5 * i, 95.0 + 5 * i, 8.0 + i,
                                  O.CALL if i % 2 else O.PUT, asset_id=a(i)) for i in range(3)]
    products += [pkg.BasketOption(0.75 + 0.5 * i, ["a0", "a1"], [0.6, 0.4], 95.0 + 2 * i, O.CALL,
                                  pkg.BasketOptionType.GEOMETRIC if i == 1
                                  else pkg.BasketOptionType.ARITHMETIC) for i in range(3)]
    products += [pkg.AsianOption(0.0, 1.0 + 0.5 * i, 90.0 + 4 * i, 8, O.CALL,
                                 pkg.AsianAveragingType.GEOMETRIC if i == 2
                                 else pkg.AsianAveragingType.ARITHMETIC, asset_id=a(i))
                 for i in range(3)]
    products += [pkg.BarrierOption(0.0, 1.0 + 0.25 * i, 90.0 + 5 * i, 12,
                                   O.CALL if i % 2 else O.PUT, 125.0 + 5 * i,
                                   pkg.BarrierOptionType.UPANDOUT, asset_id=a(i))
                 for i in range(3)]
    products += [pkg.BermudanOption(pkg.Equity(a(i)), [0.5, 1.0, 1.5], 95.0 + 5 * i,
                                    O.PUT if i % 2 else O.CALL, asset_id=a(i)) for i in range(3)]
    products += [pkg.FlexiCall([pkg.EuropeanOption(pkg.Equity(a(i)), t, 92.0 + 4 * i, O.CALL,
                                                   asset_id=a(i)) for t in (0.5, 1.0, 1.5)],
                               num_exercise_rights=1 + i, asset_id=a(i)) for i in range(2)]
    products += [pkg.AmericanOption(pkg.Equity(a(i)), 1.0, 7, 95.0 + 5 * i, O.PUT, asset_id=a(i))
                 for i in range(2)]
    return products


def netting_sets(pkg=mt, by_family=False):
    products = mixed_book(pkg)
    if by_family:
        names = {}
        for p in products:
            names.setdefault(type(p).__name__, []).append(p)
        return [pkg.NettingSet(name=k, products=v) for k, v in names.items()]
    k = len(products) // 2
    return [pkg.NettingSet(name="book_a", products=products[:k]),
            pkg.NettingSet(name="book_b", products=products[k:])]


def port_run(batch, metrics, n, differentiate=False, by_family=False, hessian=False, **kw):
    c = mt.SimulationController(netting_sets(by_family=by_family), book_model(),
                                mt.RiskMetrics(metrics=metrics, exposure_timeline=kw.pop(
                                    "exposure_timeline", [])), n, n, 1,
                                mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                device="cpu", batch_products=batch, **kw)
    if hessian:
        c.compute_higher_derivatives()
    return c.run_simulation(), c


def assert_results_close(a, b, rtol, atol, jac_rtol=None, hessian=False):
    assert a.get_netting_set_names() == b.get_netting_set_names()
    for ns in b.get_netting_set_names():
        for metric in b.get_metric_names():
            for get in (a.get_results, a.get_mc_error):
                other = getattr(b, get.__name__)
                np.testing.assert_allclose(get(ns, metric), other(ns, metric), rtol=rtol,
                                           atol=atol, err_msg=f"{ns} {metric}")
            if jac_rtol is not None:
                np.testing.assert_allclose(np.asarray(a.get_derivatives(ns, metric)),
                                           np.asarray(b.get_derivatives(ns, metric)),
                                           rtol=jac_rtol, atol=1e-10, err_msg=f"{ns} {metric}")
            if hessian:
                np.testing.assert_allclose(
                    np.asarray(a.get_second_derivatives(ns, metric)),
                    np.asarray(b.get_second_derivatives(ns, metric)),
                    rtol=jac_rtol, atol=1e-10, err_msg=f"{ns} {metric}")


def test_batched_is_the_default_and_matches_per_product():
    batched, c = port_run(True, [mt.PVMetric()], 2048)
    assert c._batches and len(c._batched_ids) == len(c.products)
    per_product, c_plain = port_run(False, [mt.PVMetric()], 2048)
    assert not c_plain._batches and not c_plain._batched_ids
    default = mt.SimulationController(netting_sets(), book_model(), mt.RiskMetrics(
        [mt.PVMetric()]), 8, 8, 1, mt.SimulationScheme.ANALYTICAL, device="cpu")
    assert len(default._batched_ids) == len(default.products)
    for ns in ("book_a", "book_b"):
        pv_b = float(batched.get_results(ns, "pv", evaluation_idx=0))
        assert pv_b == pytest.approx(float(per_product.get_results(ns, "pv", evaluation_idx=0)),
                                     rel=1e-10)


@pytest.mark.parametrize("path", ["regression", "analytic"])
def test_batched_exposures_match_per_product(path, monkeypatch):
    """EPE, PFE and CE at 1,024 paths.  The analytic path: the Europeans take
    the batched closed-form exposures, the rest of the book regresses.  The
    regression path: no product takes a closed form (on a BS-family model
    every exposure metric but CVA would), so the Europeans' batched
    power-sum fit runs against their per-product fit."""
    if path == "regression":
        monkeypatch.setattr(SimulationController, "_can_use_analytic_exposure_for_product",
                            lambda self, product: False)
    metrics = lambda: [mt.EPEMetric(), mt.PFEMetric(0.95), mt.CEMetric()]
    batched, c = port_run(True, metrics(), 1024, exposure_timeline=DATES)
    assert len(c._batched_ids) == len(c.products)
    euro = [b for b in c._batches if isinstance(b, batching.EuropeanEquityBatch)]
    assert [b.use_analytic_exposure for b in euro] == [path == "analytic"]
    per_product, _ = port_run(False, metrics(), 1024, exposure_timeline=DATES)
    for metric in ("epe", "pfe[0.95]", "ce"):
        for ns in ("book_a", "book_b"):
            np.testing.assert_allclose(batched.get_results(ns, metric),
                                       per_product.get_results(ns, metric), rtol=1e-8,
                                       atol=1e-10, err_msg=f"{ns} {metric}")


def injected(jc, n, sim_dim):
    return {phase: jax_engine_normals(0, phase, len(jc.simulation_timeline), n, sim_dim)
            for phase in (jax_rng.PHASE_PRESIM, jax_rng.PHASE_MAINSIM)}


@pytest.mark.parametrize("case", ["pv", "pv-differentiated", "exposures"])
def test_batched_matches_jax_batched_controller(case):
    """The port's batches against the JAX controller's (``batch_products=True,
    use_pallas=False``) on the JAX engine's draws: values and standard errors
    rtol 1e-9, jacobians rtol 1e-8."""
    n, differentiate = 256, case == "pv-differentiated"
    if case == "exposures":
        metrics = lambda pkg: pkg.RiskMetrics([pkg.EPEMetric(), pkg.PFEMetric(0.95)],
                                              exposure_timeline=DATES)
    else:
        metrics = lambda pkg: pkg.RiskMetrics([pkg.PVMetric()])
    jc = mj.SimulationController(netting_sets(mj), book_model(mj), metrics(mj), n, n, 1,
                                 mj.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 **JAX_BATCHED)
    assert len(jc._batched_ids) == len(jc.products)
    jr = jc.run_simulation()
    pc = mt.SimulationController(netting_sets(), book_model(), metrics(mt), n, n, 1,
                                 mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 device="cpu", noise_source=injected(jc, n, 2))
    assert pc.simulation_timeline == jc.simulation_timeline
    assert len(pc._batched_ids) == len(pc.products)
    assert_results_close(pc.run_simulation(), jr, 1e-9, 1e-13,
                         jac_rtol=1e-8 if differentiate else None)


@pytest.mark.parametrize("branch", ["fwd", "rev"])
def test_batched_jacobian_matches_per_product(branch):
    """One netting set per family (V = 8 >= P = 5: forward mode) or two
    (V = 2: reverse mode); batched against per-product on the same paths."""
    kw = dict(differentiate=True, by_family=branch == "fwd")
    batched, c = port_run(True, [mt.PVMetric()], 512, **kw)
    assert c._grad_mode_resolved == branch
    per_product, c_plain = port_run(False, [mt.PVMetric()], 512, **kw)
    assert c_plain._grad_mode_resolved == branch
    assert_results_close(batched, per_product, 1e-10, 1e-12, jac_rtol=1e-9)


@pytest.mark.parametrize("branch", ["fwd", "rev"])
def test_batched_hessian_row_matches_per_product(branch):
    """One Hessian row, d jac / d spot[a1]: forward over forward (one netting
    set per family) and forward over reverse (two netting sets), batched
    against per-product."""
    rows = []
    for batch in (True, False):
        _, c = port_run(batch, [mt.PVMetric()], 256, differentiate=True,
                        by_family=branch == "fwd")
        assert c._grad_mode_resolved == branch
        jacobian = c._jacrev if branch == "rev" else c._jacfwd
        pair = c._pair_fn(None)
        params = c.model.initial_params(device="cpu", dtype=torch.float64)
        rows.append(c._hessian_row(lambda p: jacobian(pair, p)[2], params, 1).numpy())
    assert np.abs(rows[0]).max() > 0
    np.testing.assert_allclose(rows[0], rows[1], rtol=1e-8, atol=1e-10)


def euro_book(num_ns_split, calls_every=3):
    asset_ids = ["a0", "a1"]
    O = mt.OptionType
    prods1 = [mt.EuropeanOption(mt.Equity(asset_ids[i % 2]), 1.0 + 0.25 * (i % 4),
                                85.0 + 2.5 * (i % 12), O.CALL if i % calls_every else O.PUT,
                                asset_id=asset_ids[i % 2]) for i in range(num_ns_split)]
    prods2 = [mt.EuropeanOption(mt.Equity(asset_ids[i % 2]), 1.5, 100.0 + i, O.PUT,
                                asset_id=asset_ids[i % 2]) for i in range(60)]
    model = mt.BlackScholesMulti(0.0, rate=0.03, asset_ids=asset_ids, spots=[100.0, 95.0],
                                 volatilities=[0.2, 0.25],
                                 correlation_matrix=np.array([[1.0, 0.3], [0.3, 1.0]]))
    return [mt.NettingSet(name="b1", products=prods1),
            mt.NettingSet(name="b2", products=prods2)], model


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_european_hinge_sum_equals_dense_payoffs(differentiate, monkeypatch):
    """The sorted-strike hinge sum (O(groups x N)) against the dense [P, N]
    payoff matrix across netting sets, calls and puts and maturities; on the
    differentiated branch its pathwise deltas and vegas too."""
    def run():
        ns, model = euro_book(140)
        c = mt.SimulationController(ns, model, mt.RiskMetrics([mt.PVMetric()]), 8192, 0, 1,
                                    mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                    device="cpu")
        return c.run_simulation()

    dense = run()
    monkeypatch.setattr(batching.EuropeanEquityBatch, "CASHFLOW_CHUNK_BYTES", 0)
    hinge = run()
    assert_results_close(hinge, dense, 1e-9, 1e-9, jac_rtol=1e-9 if differentiate else None)


def test_binary_piecewise_linear_equals_dense_payoffs(monkeypatch):
    """The digital piecewise-linear path (two searchsorteds, payment prefix
    sums) against the dense fuzzy payoff matrix."""
    def run():
        model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.25, asset_id="eq")
        prods = [mt.BinaryOption(1.0 + 0.5 * (i % 3), 80.0 + 0.37 * i, payment_amount=5.0 + (i % 7),
                                 option_type=mt.OptionType.CALL if i % 3 else mt.OptionType.PUT,
                                 asset_id="eq") for i in range(120)]
        c = mt.SimulationController([mt.NettingSet(name="dig", products=prods)], model,
                                    mt.RiskMetrics([mt.PVMetric()]), 8192, 0, 1,
                                    mt.SimulationScheme.ANALYTICAL, device="cpu")
        return float(c.run_simulation().get_results("dig", "pv", evaluation_idx=0))

    dense = run()
    monkeypatch.setattr(batching.BinaryBatch, "CASHFLOW_CHUNK_BYTES", 0)
    piecewise = run()
    assert abs(dense - piecewise) < 1e-9 * max(1.0, abs(dense)), (dense, piecewise)


def test_segmented_cashflows_chunked_equals_dense(monkeypatch):
    """Product-chunked cashflow accumulation equals the dense [P, N] path
    bit for bit: the chunks add into the running total in product order."""
    def run():
        ns, model = euro_book(37, calls_every=2)
        c = mt.SimulationController(ns[:1], model, mt.RiskMetrics([mt.PVMetric()]), 4096, 0, 1,
                                    mt.SimulationScheme.ANALYTICAL, device="cpu")
        return float(c.run_simulation().get_results("b1", "pv", evaluation_idx=0))

    pv_dense = run()
    monkeypatch.setattr(batching.TerminalBatch, "CASHFLOW_CHUNK_BYTES", 4096 * 8 * 5)
    # past the budget a European book of few groups takes the hinge sums
    monkeypatch.setattr(batching.EuropeanEquityBatch, "HINGE_SUM_MIN_RATIO", 10 ** 9)
    assert run() == pv_dense


def test_analytic_exposure_chunked_equals_single_chunk(monkeypatch):
    """The analytic European exposures priced in product chunks of 4 equal
    the one-chunk evaluation."""
    def run():
        model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
        prods = [mt.EuropeanOption(mt.Equity("eq"), 1.5 + 0.25 * (i % 4), 90.0 + 3 * (i % 7),
                                   mt.OptionType.CALL if i % 2 else mt.OptionType.PUT,
                                   asset_id="eq") for i in range(23)]
        c = mt.SimulationController(
            [mt.NettingSet(name="book", products=prods)], model,
            mt.RiskMetrics(metrics=[mt.EPEMetric(), mt.PFEMetric(0.95)],
                           exposure_timeline=[0.5, 1.0, 1.4]),
            8192, 0, 1, mt.SimulationScheme.ANALYTICAL, device="cpu")
        assert c._batches[0].use_analytic_exposure
        r = c.run_simulation()
        return [float(r.get_results("book", m, evaluation_idx=i))
                for m in ("epe", "pfe[0.95]") for i in range(3)]

    base = run()
    monkeypatch.setattr(batching.EuropeanEquityBatch, "CASHFLOW_CHUNK_BYTES", 8192 * 8 * 4)
    for a, b in zip(base, run()):
        assert abs(a - b) < 1e-9 * max(1.0, abs(a)), (a, b)


def coupons():
    return [
        mt.Bond(0.0, 2.0, notional=100.0, tenor=0.5, pays_notional=True, fixed_rate=0.04,
                asset_id="r"),
        mt.Bond(0.0, 1.75, notional=50.0, tenor=0.5, pays_notional=True, fixed_rate=None,
                asset_id="r"),  # an FRN with a stub
        mt.InterestRateSwap(0.0, 2.0, notional=10.0, fixed_rate=0.03, tenor_fixed=0.5,
                            tenor_float=0.25, irs_type=mt.IRSType.PAYER, asset_id="r"),
        mt.InterestRateSwap(0.0, 1.5, notional=10.0, fixed_rate=0.035, tenor_fixed=0.75,
                            tenor_float=0.5, irs_type=mt.IRSType.RECEIVER, asset_id="r"),
    ]


def vasicek():
    return mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012,
                           asset_id="r")


def test_coupon_batch_pv_matches_per_product():
    """Fixed bond, FRN, payer and receiver swaps: the same event amounts,
    LIBOR rows and numeraire deflation as the per-product path."""
    def run(batch):
        c = mt.SimulationController([mt.NettingSet(name="ns", products=coupons())], vasicek(),
                                    mt.RiskMetrics([mt.PVMetric()]), 4096, 0, 1,
                                    mt.SimulationScheme.EULER, device="cpu", batch_products=batch)
        assert any(isinstance(b, batching.CouponBatch) for b in c._batches) == batch
        return c.run_simulation()

    assert_results_close(run(True), run(False), 1e-10, 1e-12)


def test_coupon_batch_exposure_and_cva_match_per_product():
    """The coupon exposure regression (future-cashflow sweep, power-sum Gram)
    against the per-product backward-induction fit (per-column
    equilibration): EPE rtol 2e-5, CVA 1e-4, the JAX package's limits."""
    cp = "cp"

    def run(batch):
        credit = mt.CIRPPModel(0.0, asset_id=cp, hazard_rates={1.0: 0.01, 3.0: 0.015, 5.0: 0.02},
                               kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)
        model = mt.ModelConfig([vasicek(), credit],
                               inter_asset_correlation_matrix=[np.array([[0.25]])])
        swap, bond = coupons()[2], coupons()[0]
        c = mt.SimulationController(
            [mt.NettingSet(name="ns", products=[swap, bond], counterparty_id=cp)], model,
            mt.RiskMetrics(metrics=[mt.CVAMetric(counterparty_id=cp, recovery_rate=0.4),
                                    mt.EPEMetric()], exposure_timeline=np.linspace(0.0, 2.0, 5)),
            16384, 16384, 1, mt.SimulationScheme.EULER, device="cpu", batch_products=batch)
        return c.run_simulation()

    r_b, r_p = run(True), run(False)
    for i in range(5):
        np.testing.assert_allclose(float(r_b.get_results("ns", "epe", evaluation_idx=i)),
                                   float(r_p.get_results("ns", "epe", evaluation_idx=i)),
                                   rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(r_b.get_results("ns", f"cva[{cp}]", evaluation_idx=0)),
                               float(r_p.get_results("ns", f"cva[{cp}]", evaluation_idx=0)),
                               rtol=1e-4, atol=1e-9)
