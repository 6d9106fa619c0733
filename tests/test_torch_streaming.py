"""The port's streaming route against its plane route and the JAX package
(tests/test_streaming_engine.py and tests/test_streaming_metrics.py, case
by case): the engine's emissions against plane resolution, streaming books
through the controller, the streaming metric pipeline (MPoR collateral,
thresholds, several netting sets, every sampler), the refusals, the ring
slots, the "auto" decision, and kernel-streaming AD on K2's plain version
to first and second order.

JAX runs use ``use_pallas=False`` and take their own threefry draws; the
port takes the same draws through ``noise_source`` / ``qmc_shift_source``."""

import numpy as np
import pytest
import torch

import chip_smoke
import montecarlo_risk_engine_tpu as mj
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.api.streaming_metrics import _greedy_slots as jax_greedy_slots
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch.api.streaming_metrics import _greedy_slots
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.metrics import metrics as pm
from montecarlo_risk_engine_tpu_torch.ops import paths_ad
from test_torch_hybrid_models import jax_engine_normals
from test_torch_samplers import jax_half_draws, jax_shift, sobol_dims

torch.set_num_threads(1)

HAZ = {1.0: 0.01, 3.0: 0.015, 5.0: 0.02}
CP = "cp"
PRE, MAIN = jax_rng.PHASE_PRESIM, jax_rng.PHASE_MAINSIM
STREAM_METRICS = ("cva[cp]", "epe", "ene", "ce", "eepe", "eepe[effective]", "pfe[0.95]",
                  "pfe[0.99]")


class _Pkg:
    """The port's classes under the JAX package's names (metrics included)."""

    def __getattr__(self, name):
        return getattr(mt, name, None) or getattr(pm, name)


PORT = _Pkg()


def hybrid(pkg, credit=CP):
    return pkg.ModelConfig(
        [pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012,
                          asset_id="irs"),
         pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq"),
         pkg.CIRPPModel(0.0, asset_id=credit, hazard_rates=HAZ, kappa=0.1, theta=0.01,
                        volatility=0.02, y0=0.0001)],
        inter_asset_correlation_matrix=[np.array([[0.25]]), np.array([[0.4]]),
                                        np.array([[0.15]])])


def swap(pkg, maturity=2.0, fixed=0.03, payer=True, notional=1.0):
    return pkg.InterestRateSwap(0.0, maturity, notional=notional, fixed_rate=fixed, tenor_fixed=0.5,
                                tenor_float=0.5,
                                irs_type=pkg.IRSType.PAYER if payer else pkg.IRSType.RECEIVER,
                                asset_id="irs")


def xva_book(pkg, mpor=10 / 252, threshold=0.0):
    """tests/test_streaming_metrics.py:43-72: a swap and a call, every
    streamable metric."""
    prods = [swap(pkg), pkg.EuropeanOption(pkg.Equity("eq"), 1.5, 100.0, pkg.OptionType.CALL,
                                           asset_id="eq")]
    ns = pkg.NettingSet(name="ns", products=prods, counterparty_id=CP,
                        margin_period_of_risk=mpor, threshold=threshold)
    metrics = [pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4), pkg.EPEMetric(),
               pkg.ENEMetric(), pkg.CEMetric(), pkg.EEPEMetric(), pkg.EEPEMetric(effective=True),
               pkg.PFEMetric(0.95), pkg.PFEMetric(0.99, pfe_se="order-statistic")]
    return [ns], hybrid(pkg), pkg.RiskMetrics(metrics=metrics,
                                              exposure_timeline=np.linspace(0.0, 2.0, 5))


def port(parts, n, presim, steps=1, scheme="EULER", **kw):
    kw.setdefault("device", "cpu")
    return mt.SimulationController(*parts, n, presim, steps, mt.SimulationScheme[scheme], **kw)


def jax_controller(parts, n, presim, steps=1, scheme="EULER", **kw):
    return mj.SimulationController(*parts, n, presim, steps, mj.SimulationScheme[scheme],
                                   use_pallas=False, **kw)


# The PFE's density-difference error divides by the gap between the
# neighbouring order statistics, ~1e-4 of their value at these path counts,
# so it carries the values' rounding differences (plane against fold, port
# against JAX: ~1e-15) amplified by ~1e4; its tolerance says so.
PFE_SE_RTOL = 1e-8


def assert_same(r_a, r_b, names, grads=False, rtol=1e-10, rtol_grads=1e-8, atol=1e-13):
    for ns in r_b.get_netting_set_names():
        for nm in names:
            for get in ("get_results", "get_mc_error"):
                density_se = (get == "get_mc_error" and nm.startswith("pfe")
                              and nm != "pfe[0.99]")
                np.testing.assert_allclose(np.atleast_1d(getattr(r_a, get)(ns, nm)),
                                           np.atleast_1d(getattr(r_b, get)(ns, nm)),
                                           rtol=max(rtol, PFE_SE_RTOL) if density_se else rtol,
                                           atol=atol, err_msg=f"{ns} {nm} {get}")
            if grads:
                for p in r_b.get_model_param_names():
                    np.testing.assert_allclose(
                        np.atleast_1d(r_a.get_derivatives(ns, nm, param=p)),
                        np.atleast_1d(r_b.get_derivatives(ns, nm, param=p)),
                        rtol=rtol_grads, atol=1e-12, err_msg=f"{ns} {nm} d/d{p}")


# -- the engine's emissions against plane resolution ----------------------------------


def emission_books():
    bs_multi = mt.BlackScholesMulti(0.0, rate=0.03, asset_ids=["a1", "a2"], spots=[100.0, 90.0],
                                    volatilities=[0.2, 0.3],
                                    correlation_matrix=np.array([[1.0, 0.4], [0.4, 1.0]]))
    terminal = [
        mt.EuropeanOption(mt.Equity("a1"), 1.0, 100.0, mt.OptionType.CALL, asset_id="a1"),
        mt.BinaryOption(1.0, 100.0, 10.0, mt.OptionType.CALL, asset_id="a1"),
        mt.AsianOption(0.25, 1.0, 95.0, 4, mt.OptionType.CALL, asset_id="a2"),
        mt.BarrierOption(0.0, 1.0, 100.0, 4, mt.OptionType.CALL, 130.0,
                         mt.BarrierOptionType.UPANDOUT, asset_id="a1"),
        mt.BasketOption(1.0, ["a1", "a2"], [0.5, 0.5], 95.0, mt.OptionType.CALL)]
    heston = mt.HestonModel(0.0, asset_id="eq", spot=100.0, rate=0.03, sigma=0.5, rho=-0.7,
                            kappa=2.0, theta=0.06, v0=0.04)
    hw = mt.HullWhiteModel(0.0, chip_smoke.HW_TIMES, chip_smoke.HW_DFS, volatility=0.01,
                           mean_reversion=0.4, asset_id="irs")
    s2f = mt.SchwartzTwoFactorModel(0.0, [0.0, 1.0, 3.0], [50.0, 52.0, 55.0], rate=0.03,
                                    short_term_mean_reversion=1.2, short_term_vol=0.3,
                                    long_term_drift=0.01, long_term_vol=0.15, rho=0.35,
                                    asset_id="gas")
    pv = lambda: mt.RiskMetrics([mt.PVMetric()])
    return {
        "xva": (xva_book(PORT), "EULER", 2),
        "terminal_bs_multi": (([mt.NettingSet(name="book", products=terminal)], bs_multi, pv()),
                              "ANALYTICAL", 1),
        "heston_qe": (([mt.NettingSet(name="book", products=[mt.EuropeanOption(
            mt.Equity("eq"), t, 100.0, mt.OptionType.CALL, asset_id="eq") for t in (0.5, 1.0)])],
            heston, pv()), "QE", 2),
        "hull_white_bond": (([mt.NettingSet(name="book", products=[mt.Bond(
            0.0, 3.0, notional=1.0, tenor=0.5, pays_notional=True, fixed_rate=0.02,
            asset_id="irs")])], hw, pv()), "ANALYTICAL", 2),
        "s2f_call": (([mt.NettingSet(name="book", products=[mt.EuropeanOption(
            mt.Equity("gas"), 2.0, 52.0, mt.OptionType.CALL, asset_id="gas")])], s2f, pv()),
            "EULER", 3),
    }


@pytest.mark.parametrize("book", sorted(emission_books()))
def test_engine_emissions_match_plane_resolution(book):
    parts, scheme, steps = emission_books()[book]
    n = 256
    c = port(parts, n, n, steps, scheme, streaming=True, metric_streaming=False)
    c._ensure_plan()
    plan, schedule = c._plan, c._emission_schedule
    assert schedule is not None and schedule.num_emitted_rows() > 0
    params = c.model.initial_params()
    args = (c.model, params, c.simulation_scheme, c.simulation_timeline, n, steps, MAIN)
    states, emissions = simulate_paths(*args, emit_schedule=schedule)
    plane = simulate_paths(*args)
    assert torch.equal(states, plane)
    assert simulate_paths(*args, emit_schedule=schedule, collect_states=False)[0] is None
    streamed = plan.resolve_from_emissions(schedule, emissions)
    resolved = plan.resolve_requests(params, plane)
    assert len(streamed[0]) == len(resolved[0]) == plan.num_atomic_requests
    for h, (a, b) in enumerate(zip(resolved[0], streamed[0])):
        np.testing.assert_allclose(torch.broadcast_to(b, (n,)).numpy(),
                                   torch.broadcast_to(a, (n,)).numpy(), rtol=1e-13, atol=1e-15,
                                   err_msg=f"handle {h}")
    for a, b in zip(resolved[1], streamed[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13, atol=1e-15)


# -- streaming books through the controller --------------------------------------------


def test_streaming_mixed_terminal_book_pv():
    """The batched terminal families streaming against the plane, PV and AAD
    (tests/test_streaming_engine.py:121-147)."""
    parts, _, _ = emission_books()["terminal_bs_multi"]
    make = lambda streaming: port(parts, 512, 512, 1, "ANALYTICAL", differentiate=True,
                                  streaming=streaming)
    stream = make(True)
    r_s = stream.run_simulation()
    assert stream._emission_schedule is not None and stream._metric_stream is None
    assert_same(r_s, make(False).run_simulation(), ["pv"], grads=True, rtol=1e-12,
                rtol_grads=1e-10)


def exercise_book(pkg):
    model = pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    products = [pkg.EuropeanOption(pkg.Equity("eq"), 2.0, 100.0, pkg.OptionType.CALL,
                                   asset_id="eq"),
                pkg.BermudanOption(pkg.Equity("eq"), [0.5, 1.0, 1.5], 100.0, pkg.OptionType.PUT,
                                   asset_id="eq")]
    ns = pkg.NettingSet(name="book", products=products)
    return [ns], model, pkg.RiskMetrics(metrics=[pkg.PVMetric(), pkg.EPEMetric()],
                                        exposure_timeline=[0.5, 1.0, 1.5])


@pytest.mark.parametrize("batch_products", [True, False], ids=["batched", "per_product"])
def test_streaming_exercise_and_exposure_book(batch_products):
    make = lambda streaming: port(exercise_book(PORT), 1024, 1024, 1, differentiate=True,
                                  streaming=streaming, batch_products=batch_products)
    stream = make(True)
    r_s = stream.run_simulation()
    assert stream._emission_schedule is not None
    assert stream.metric_stream_reason == "PV metric requires pathwise cashflow accumulation"
    assert_same(r_s, make(False).run_simulation(), ["pv", "epe"], grads=True, rtol=1e-12,
                rtol_grads=1e-10)


# -- the streaming metric pipeline ------------------------------------------------------


@pytest.mark.parametrize("mpor,threshold", [(10 / 252, 0.0), (None, 0.02)],
                         ids=["mpor", "threshold"])
def test_metric_streaming_matches_plane_and_jax(mpor, threshold):
    """Against the JAX streaming controller on its draws.  Without MPoR
    dates the JAX package's family batches on its streaming route move this
    book's exposures by ~2 % from its own plane route and from its
    per-product streaming route, which agree with each other and with the
    port (ROADMAP, reference-side facts), so that case is held to the JAX
    per-product streaming route."""
    n, presim, batched = 2048, 1024, mpor is not None
    jc = jax_controller(xva_book(mj, mpor, threshold), n, presim, differentiate=True,
                        streaming=True, metric_streaming=True, grad_mode="fwd",
                        batch_products=batched)
    jr = jc.run_simulation()
    assert jc._metric_stream is not None
    noise = {phase: jax_engine_normals(0, phase, len(jc.simulation_timeline), m, 3)
             for phase, m in ((PRE, presim), (MAIN, n))}
    make = lambda ms: port(xva_book(PORT, mpor, threshold), n, presim, differentiate=True,
                           streaming=True, metric_streaming=ms, noise_source=noise,
                           batch_products=batched)
    fold = make(True)
    r_f = fold.run_simulation()
    assert fold._metric_stream is not None and fold._grad_mode_resolved == "fwd"
    assert_same(r_f, jr, STREAM_METRICS, grads=True)
    assert_same(r_f, make(False).run_simulation(), STREAM_METRICS, grads=True)


def test_streaming_multi_netting_set_mixed_collateral():
    """tests/test_streaming_metrics.py:207-254: an MPoR netting set and a
    threshold netting set; the cpA CVA is gated to zero on the cpB set."""
    def parts():
        ns1 = mt.NettingSet(name="nsA", products=[swap(mt)], counterparty_id="cpA",
                            margin_period_of_risk=10 / 252)
        ns2 = mt.NettingSet(name="nsB", products=[
            mt.EuropeanOption(mt.Equity("eq"), 1.5, 100.0, mt.OptionType.CALL, asset_id="eq"),
            swap(mt, 1.5, 0.028, payer=False, notional=2.0)], counterparty_id="cpB",
            threshold=0.05)
        metrics = [mt.CVAMetric(counterparty_id="cpA", recovery_rate=0.4), mt.EPEMetric(),
                   pm.ENEMetric(), mt.PFEMetric(0.95)]
        return [ns1, ns2], hybrid(mt, "cpA"), mt.RiskMetrics(
            metrics=metrics, exposure_timeline=np.linspace(0.0, 2.0, 5))

    fold = port(parts(), 4096, 2048, streaming=True, metric_streaming=True)
    r_s = fold.run_simulation()
    assert fold._metric_stream.n_slots >= 1
    assert_same(r_s, port(parts(), 4096, 2048, streaming=True,
                          metric_streaming=False).run_simulation(),
                ("cva[cpA]", "epe", "ene", "pfe[0.95]"), rtol=1e-12)
    assert float(r_s.get_results("nsB", "cva[cpA]", evaluation_idx=0)) == 0.0


def frn_book(pkg):
    """tests/test_streaming_metrics.py:257-290: a swap and a floating-rate
    note (LIBOR rows through the coupon batch's event tables)."""
    model = pkg.ModelConfig(
        [pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012,
                          asset_id="irs"),
         pkg.CIRPPModel(0.0, asset_id=CP, hazard_rates=HAZ, kappa=0.1, theta=0.01,
                        volatility=0.02, y0=0.0001)],
        inter_asset_correlation_matrix=[np.array([[0.25]])])
    prods = [swap(pkg), pkg.Bond(0.0, 2.0, notional=1.0, tenor=0.5, pays_notional=True,
                                 fixed_rate=None, asset_id="irs")]
    ns = pkg.NettingSet(name="ns", products=prods, counterparty_id=CP,
                        margin_period_of_risk=10 / 252)
    return [ns], model, pkg.RiskMetrics(
        metrics=[pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4), pkg.EPEMetric(),
                 pkg.PFEMetric(0.95)], exposure_timeline=np.linspace(0.0, 2.0, 5))


@pytest.mark.parametrize("kw", [dict(num_steps=3), dict(num_steps=1, antithetic=True),
                                dict(num_steps=1, sampler="sobol")],
                         ids=["substeps", "antithetic", "sobol"])
def test_streaming_fold_with_samplers_and_substeps_and_frn(kw):
    n, presim = 2048, 1024
    kw = dict(kw)
    steps = kw.pop("num_steps")
    jc = jax_controller(frn_book(mj), n, presim, steps, streaming=True, metric_streaming=True,
                        **kw)
    jr = jc.run_simulation()
    counters = len(jc.simulation_timeline) * steps
    if kw.get("sampler") == "sobol":
        seam = dict(qmc_shift_source={
            phase: jax_shift(phase, sobol_dims(jc.simulation_timeline, steps, 2, False, False))
            for phase in (PRE, MAIN)})
    elif kw.get("antithetic"):
        seam = dict(noise_source={phase: jax_half_draws(phase, counters, m, 2, False)
                                  for phase, m in ((PRE, presim), (MAIN, n))})
    else:
        seam = dict(noise_source={phase: jax_engine_normals(0, phase, counters, m, 2)
                                  for phase, m in ((PRE, presim), (MAIN, n))})
    names = (f"cva[{CP}]", "epe", "pfe[0.95]")
    fold = port(frn_book(PORT), n, presim, steps, streaming=True, metric_streaming=True,
                **kw, **seam)
    r_f = fold.run_simulation()
    assert fold._metric_stream is not None
    assert_same(r_f, jr, names)
    plane = port(frn_book(PORT), n, presim, steps, streaming=False, **kw, **seam)
    assert_same(r_f, plane.run_simulation(), names, rtol=1e-12)


def test_metric_streaming_forced_on_ineligible_book_raises():
    def parts(pkg):
        return ([pkg.NettingSet(name="ns", products=[swap(pkg)])],
                pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                                 volatility=0.012, asset_id="irs"),
                pkg.RiskMetrics(metrics=[pkg.PVMetric(), pkg.EPEMetric()],
                                exposure_timeline=np.linspace(0.0, 2.0, 5)))

    for c in (jax_controller(parts(mj), 256, 256, metric_streaming=True, streaming=True),
              port(parts(PORT), 256, 256, metric_streaming=True, streaming=True)):
        with pytest.raises(ValueError, match="ineligible: PV metric requires pathwise"):
            c.run_simulation()
    auto = port(parts(PORT), 256, 256, streaming=True)
    auto.run_simulation()
    assert auto._metric_stream is None
    assert auto.metric_stream_reason == "PV metric requires pathwise cashflow accumulation"
    kernel = port(xva_book(PORT), 256, 256, differentiate=True, streaming=True)
    kernel._ensure_plan()
    assert kernel._kernel_active and kernel.metric_stream_reason == "fused kernel path active"
    with pytest.raises(ValueError, match="mutually exclusive"):
        port(xva_book(PORT), 256, 256, streaming=True, use_kernel=True)


def test_greedy_slot_assignment():
    assert _greedy_slots([(0, 1, 0), (2, 3, 2), (4, 5, 4)])[0] == 1
    n, slots = _greedy_slots([(0, 4, 0), (1, 5, 1), (2, 3, 2)])
    assert n == 3 and len(set(slots.values())) == 3
    assert _greedy_slots([(0, 2, 0), (1, 3, 1), (3, 5, 3)])[0] == 2
    rs = np.random.default_rng(5)
    for _ in range(20):
        starts = rs.integers(0, 30, size=12)
        iv = [(int(s), int(s + rs.integers(0, 6)), k) for k, s in enumerate(starts)]
        assert _greedy_slots(iv) == jax_greedy_slots(iv)


def test_streaming_auto_decision_follows_jax(monkeypatch):
    """The "auto" rule against budgets set on both packages
    (tests/test_streaming_engine.py:214-340)."""
    def bs_parts(pkg):
        model = pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
        option = pkg.EuropeanOption(pkg.Equity("eq"), 2.0, 100.0, pkg.OptionType.CALL,
                                    asset_id="eq")
        return [pkg.NettingSet(name="book", products=[option])], model, pkg.RiskMetrics(
            [pkg.PVMetric()])

    def decide(pkg, **kw):
        if pkg is mj:
            c = jax_controller(bs_parts(mj), 128, 0, 1, "ANALYTICAL", **kw)
            c._plan = mj.requests.RequestPlan(c.model)
            c._plan.collect_and_index_requests(c.products, c.simulation_timeline,
                                               c._get_requests(), c.metric_exposure_timeline)
            c._decide_streaming()
        else:
            c = port(bs_parts(PORT), 128, 0, 1, "ANALYTICAL", use_kernel=False, **kw)
            c._ensure_plan()
        return c._emission_schedule is not None

    # The book's plane: one point x one state x 128 paths x 8 bytes.
    cases = [dict(), dict(differentiate=True), dict(sampler="sobol", qmc_bridge=True)]
    for budgets, expect in (((2 << 30, 14 << 30), False), ((0, 14 << 30), True),
                            ((2 << 30, 13 * 1024 - 1), None)):
        for cls in (mj.SimulationController, mt.SimulationController):
            monkeypatch.setattr(cls, "STREAMING_AUTO_THRESHOLD_BYTES", budgets[0])
            monkeypatch.setattr(cls, "STREAMING_AUTO_AD_BUDGET_BYTES", budgets[1])
        monkeypatch.setattr(mj.SimulationController, "_device_hbm_bytes", lambda self: None)
        for kw in cases:
            got = decide(mt, **kw)
            assert got == decide(mj, **kw), (budgets, kw)
            if expect is not None:
                assert got == expect, (budgets, kw)
        if expect is None:  # the AD budget: 13x the plane of a differentiated run
            assert decide(mt, differentiate=True) and not decide(mt)
    assert not decide(mt, streaming=False) and decide(mt, streaming=True)


# -- kernel-streaming AD (K2's plain version on the CPU) ----------------------------------


def kernel_book(pkg, exposure=True):
    products = [swap(pkg, 1.5), pkg.EuropeanOption(pkg.Equity("eq"), 1.0, 100.0,
                                                    pkg.OptionType.CALL, asset_id="eq")]
    ns = pkg.NettingSet(name="ns", products=products, counterparty_id=CP,
                        margin_period_of_risk=10 / 252 if exposure else None)
    metrics = ([pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4), pkg.EPEMetric(),
                pkg.PFEMetric(0.95)] if exposure else [pkg.PVMetric()])
    return [ns], hybrid(pkg), pkg.RiskMetrics(metrics=metrics,
                                              exposure_timeline=np.linspace(0.0, 1.5, 4))


def kernel_vs_engine(exposure, hessian, n=512):
    """(kernel-streaming AD results, the engine's streaming results on the
    kernel's draws, the kernel controller)."""
    kernel = port(kernel_book(PORT, exposure), n, n, differentiate=True, streaming=True)
    if hessian:
        kernel.compute_higher_derivatives()
    draws = chip_smoke.capture_draws(kernel)
    r_k = kernel.run_simulation()
    assert kernel._kernel_active and kernel._emission_schedule is not None
    engine = port(kernel_book(PORT, exposure), n, n, differentiate=True, streaming=True,
                  noise_source=chip_smoke.draws_source(kernel, draws))
    if hessian:
        engine.compute_higher_derivatives()
    r_e = engine.run_simulation()
    assert not engine._kernel_active and engine._emission_schedule is not None
    return r_k, r_e, kernel


@pytest.mark.parametrize("order", [1, 2], ids=["first_order", "second_order"])
def test_kernel_streaming_ad_matches_engine_streaming(order):
    exposure = order == 1
    r_k, r_e, _ = kernel_vs_engine(exposure, hessian=order == 2)
    names = [f"cva[{CP}]", "epe", "pfe[0.95]"] if exposure else ["pv"]
    assert_same(r_k, r_e, names, grads=True, rtol=1e-9, rtol_grads=1e-7)
    if order == 2:
        params = r_k.get_model_param_names()
        matrix = lambda r, nm: np.array([[r.get_second_derivatives("ns", nm, param1=a, param2=b,
                                                                   evaluation_idx=0)
                                          for b in params] for a in params], dtype=float)
        for nm in names:
            h_k, h_e = matrix(r_k, nm), matrix(r_e, nm)
            np.testing.assert_allclose(h_k, h_e, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(h_k, h_k.T, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("emit_chunk", [1, 3, 1_000_000])
def test_kernel_streaming_ad_emit_chunk_invariant(monkeypatch, emit_chunk):
    names = [f"cva[{CP}]", "epe", "pfe[0.95]"]
    make = lambda streaming: port(kernel_book(PORT), 256, 256, differentiate=True,
                                  streaming=streaming)
    plane = make(False)
    r_p = plane.run_simulation()
    assert plane._kernel_active and plane._emission_schedule is None
    monkeypatch.setattr(paths_ad, "EMIT_PLANE_CHUNK", emit_chunk)
    assert_same(make(True).run_simulation(), r_p, names, grads=True, rtol=1e-12,
                rtol_grads=1e-10)


def test_rows_from_kernel_plane_match_the_reconstruction():
    """The primal of kernel-streaming AD resolved from the kernel's own plane
    equals the rows-emitting reconstruction on the kernel's draws, to the
    kernel's float32 rounding."""
    c = port(kernel_book(PORT), 256, 256, differentiate=True, streaming=True)
    c._ensure_plan()
    params = c.model.initial_params()
    fwd_rows, noise_fn, recon_rows = c._kernel_ad_fns(256, MAIN, c._emission_schedule)
    primal, rebuilt = fwd_rows(params), recon_rows(params, noise_fn(params))
    assert len(primal) == len(rebuilt) == len(c._emission_schedule.groups)
    for a, b in zip(primal, rebuilt):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.double().numpy(), b.tensor().numpy(), rtol=2e-5, atol=1e-6)


def test_remat_paths_matches_plain_reverse_mode():
    """``remat_paths`` recomputes each point's substeps in the backward pass:
    the reverse-mode jacobian is unchanged."""
    parts = lambda: emission_books()["heston_qe"][0]
    make = lambda remat: port(parts(), 512, 0, 2, "QE", differentiate=True, use_kernel=False,
                              remat_paths=remat, streaming=True)
    plain = make(False)
    r_p = plain.run_simulation()
    assert plain._grad_mode_resolved == "rev"
    assert_same(make(True).run_simulation(), r_p, ["pv"], grads=True, rtol=1e-14,
                rtol_grads=1e-13)
