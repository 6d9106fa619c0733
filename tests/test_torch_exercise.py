"""The port's exercise products (Bermudan, American, FlexiCall, Storage) and
their LSM machinery against the JAX package on the same numbers (f64, the
JAX engine's own threefry draws injected for both phases): values, errors,
jacobians, the pre-simulation coefficients and the realized states; in the
port, the event scan against the per-date unrolled path and a bucket against
its products one by one; the storage configuration, transitions and argmax
ties; and the weighted, ridged and batched least-squares fit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.utils.regression import fit_least_squares as jax_fit
from montecarlo_risk_engine_tpu_torch import tracing
from montecarlo_risk_engine_tpu_torch.ops import exercise_scan, storage_scan
from montecarlo_risk_engine_tpu_torch.utils.regression import fit_least_squares
from gas_books import (compare, compare_coeffs, exposure_book, flexicall, gas_book, pv_book, s2f,
                       scan_storage)
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")
N = 512
PV = lambda pkg: pkg.RiskMetrics([pkg.PVMetric()])


def injected(jc, num_steps, sim_dim):
    n_counters = len(jc.simulation_timeline) * num_steps
    return {phase: jax_engine_normals(0, phase, n_counters, N, sim_dim)
            for phase in (jax_rng.PHASE_PRESIM, jax_rng.PHASE_MAINSIM)}


def jax_presim_coeffs(jc, products):
    """The JAX controller's pre-simulation fits of a run (its
    ``_compute`` regression phase, jitted): each product's
    ``regression_coeffs``."""
    params = tuple(jc.model.initial_params())

    def fits(p):
        resolved_pre, _ = jc._simulate_and_resolve(p, jc.num_paths_presim, jax_rng.PHASE_PRESIM)
        buckets, singles, plain = jc._exercise_scan_groups()
        for bucket in buckets:
            jc._fit_exercise_bucket(bucket, p, resolved_pre)
        for product in singles:
            jc._regression_exercise_scan(product, p, resolved_pre)
        for product in plain:
            jc._perform_regression_for_product(product, p, resolved_pre)
        return [product.regression_coeffs for product in products]

    return [np.asarray(c) for c in jax.jit(fits)(params)]


# -- Bermudan and American ----------------------------------------------------------

def bermudan_book(pkg, itm_only):
    """An American put on 6 dates (its first at t = 0, where the ridge keeps
    the fit solvable), two Bermudan puts of one bucket and a Bermudan call."""
    put, call = pkg.OptionType.PUT, pkg.OptionType.CALL
    american = pkg.AmericanOption(pkg.Equity("eq"), 1.0, 6, 100.0, put, asset_id="eq")
    american.itm_only_regression = itm_only
    bermudans = [pkg.BermudanOption(pkg.Equity("eq"), dates, k, kind, asset_id="eq",
                                    itm_only_regression=itm_only)
                 for dates, k, kind in (([0.3, 0.6, 1.0], 105.0, put), ([0.25, 0.7, 1.0], 95.0, put),
                                        ([0.4, 0.8, 1.2], 100.0, call))]
    return [pkg.NettingSet(name="american", products=[american]),
            pkg.NettingSet(name="bermudans", products=bermudans)]


def bs(pkg):
    return pkg.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq")


@pytest.mark.parametrize("itm_only", [False, True], ids=["all_paths", "itm_only"])
@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_bermudan_and_american_match_jax(differentiate, itm_only):
    jbook = bermudan_book(mj, itm_only)
    jc = mj.SimulationController(jbook, bs(mj), PV(mj), N, N, 2, mj.SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, **JAX_FLAGS)
    jr = jc.run_simulation()
    pbook = bermudan_book(mt, itm_only)
    pc = mt.SimulationController(pbook, bs(mt), PV(mt), N, N, 2, mt.SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, device="cpu",
                                 noise_source=injected(jc, 2, 1), batch_products=False)
    buckets, plain = pc._exercise_scan_groups()
    assert [len(b) for b in buckets] == [1, 2, 1] and not plain
    pr = pc.run_simulation()
    compare(pr, jr, differentiate)
    if not differentiate:
        compare_coeffs([p for ns in pbook for p in ns.products],
                       jax_presim_coeffs(jc, [p for ns in jbook for p in ns.products]), 100.0)


# -- FlexiCall and Storage -----------------------------------------------------------

@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_flexicall_and_storage_match_jax(differentiate):
    jbook = gas_book(mj)
    jc = mj.SimulationController(jbook, s2f(mj), PV(mj), N, N, 1, mj.SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, **JAX_FLAGS)
    jr = jc.run_simulation()
    pbook = gas_book(mt)
    pc = mt.SimulationController(pbook, s2f(mt), PV(mt), N, N, 1, mt.SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, device="cpu",
                                 noise_source=injected(jc, 1, 2), batch_products=False)
    pr = pc.run_simulation()
    compare(pr, jr, differentiate)
    if not differentiate:
        products = [p for ns in pbook for p in ns.products]
        compare_coeffs(products, jax_presim_coeffs(jc, [p for ns in jbook for p in ns.products]),
                       10.0)
        for ported, ref in ((products[1], jbook[0].products[1]), (products[2], jbook[1].products[0])):
            np.testing.assert_allclose(pc.simulate_exercise_states(ported),
                                       jc.simulate_exercise_states(ref), rtol=1e-9, atol=1e-12)


def test_exercise_exposures_in_forward_mode_match_jax():
    """A storage and a FlexiCall with EPE on 7 dates (the exposure rows of
    the event tables, continuation exposures): P = 6 <= V = 7 takes the
    forward-mode jacobian, the scans under torch.func's jvp and vmap."""
    jc = mj.SimulationController(*exposure_book(mj), N, N, 1, mj.SimulationScheme.ANALYTICAL,
                                 differentiate=True, **JAX_FLAGS)
    jr = jc.run_simulation()
    pc = mt.SimulationController(*exposure_book(mt), N, N, 1, mt.SimulationScheme.ANALYTICAL,
                                 differentiate=True, device="cpu", noise_source=injected(jc, 1, 2))
    pr = pc.run_simulation()
    assert pc._grad_mode_resolved == "fwd"
    compare(pr, jr, True)


@pytest.mark.parametrize("book", [pv_book, exposure_book], ids=["pv", "exposures"])
def test_storage_kernel_route_matches_jax(monkeypatch, book):
    """The storage kernel's route on the gas books above (the s2f storages:
    two-point curves, initial amounts 3 and 4; with and without exposure
    rows), with the CPU among the kernel's devices so that its plain
    version stands in for the kernel: the packed tables, observation rows,
    coefficient views and netting.  Values and errors, and every product's
    ``regression_coeffs``, against the JAX package's at the tolerances
    above."""
    monkeypatch.setattr(storage_scan, "_KERNEL_DEVICES", ("cuda", "cpu"))
    jc = mj.SimulationController(*book(mj), N, N, 1, mj.SimulationScheme.ANALYTICAL, **JAX_FLAGS)
    jr = jc.run_simulation()
    pc = mt.SimulationController(*book(mt), N, N, 1, mt.SimulationScheme.ANALYTICAL, device="cpu",
                                 noise_source=injected(jc, 1, 2), batch_products=False)
    tracing.enable()
    try:
        pr = pc.run_simulation()
        spans = [(r.attrs["route"], r.attrs["phase"], r.attrs["products"]) for r in tracing.take()
                 if r.name == "exercise" and r.attrs["kind"] == "Storage"]
    finally:
        tracing.disable()
    storages = sum(isinstance(p, mt.Storage) for p in pc.products)
    assert spans == [("kernel", "fit", storages), ("kernel", "value", storages)]
    compare(pr, jr, False)
    compare_coeffs(pc.products, jax_presim_coeffs(jc, jc.products), 10.0)


@pytest.mark.parametrize("case", ["bermudans_all_paths", "bermudans_itm_only", "flexicalls"])
def test_equity_exercise_kernel_route_matches_jax(monkeypatch, case):
    """The equity exercise kernel's route (ops/exercise_scan.py) on the
    Bermudan and American book above (all paths and in the money) and the
    gas book's FlexiCalls, with the family batches on and the CPU among the
    kernel's devices so that its plain version stands in for the kernel:
    every ExerciseEquityBatch product in one pack, the observation rows,
    coefficient views and netting.  Values and errors against the JAX
    package's batched controller, and each exercise product's
    ``regression_coeffs`` against its per-product fits, at the tolerances
    above.  The batches (in both packages) gate a FlexiCall's exercise, and
    not only its fit, in the money, so the gas book's ITM FlexiCall has
    other coefficients per product: it is left out of that comparison."""
    monkeypatch.setattr(exercise_scan, "_KERNEL_DEVICES", ("cuda", "cpu"))
    if case == "flexicalls":
        book, model, steps, sim_dim, spot0 = gas_book, s2f, 1, 2, 10.0
    else:
        itm_only = case == "bermudans_itm_only"
        book, model, steps, sim_dim, spot0 = (lambda pkg: bermudan_book(pkg, itm_only)), bs, 2, 1, 100.0
    jbook = book(mj)
    jc = mj.SimulationController(jbook, model(mj), PV(mj), N, N, steps,
                                 mj.SimulationScheme.ANALYTICAL, **JAX_FLAGS)
    jc.run_simulation()  # its plan, for the per-product fits
    jr = mj.SimulationController(book(mj), model(mj), PV(mj), N, N, steps,
                                 mj.SimulationScheme.ANALYTICAL,
                                 **dict(JAX_FLAGS, batch_products=True)).run_simulation()
    pbook = book(mt)
    pc = mt.SimulationController(pbook, model(mt), PV(mt), N, N, steps,
                                 mt.SimulationScheme.ANALYTICAL, device="cpu",
                                 noise_source=injected(jc, steps, sim_dim))
    tracing.enable()
    try:
        pr = pc.run_simulation()
        spans = [(r.attrs["route"], r.attrs["phase"], r.attrs["products"]) for r in tracing.take()
                 if r.name == "exercise" and r.attrs["kind"] != "Storage"]
    finally:
        tracing.disable()
    pairs = [(p, q) for pns, jns in zip(pbook, jbook) for p, q in zip(pns.products, jns.products)
             if not isinstance(p, mt.Storage)]
    assert spans == [("kernel", "fit", len(pairs)), ("kernel", "value", len(pairs))]
    compare(pr, jr, False)
    # each product's coefficients on its own dates: the route's fit on the
    # run's pre-simulation
    pc._ensure_plan()
    with torch.no_grad():
        _, pre = pc._simulate_and_resolve(pc.model.initial_params(device=pc.device,
                                                                  dtype=torch.float64),
                                          N, jax_rng.PHASE_PRESIM)
    book = pc._book_options
    views = exercise_scan.product_coefficients(book.packed, book.fit(pre))
    for p, (product, view) in enumerate(zip(book.products, views)):
        first, events = book.packed.options[p, [exercise_scan.FIRST_ROW, exercise_scan.EVENTS]]
        product.regression_coeffs = view[np.flatnonzero(
            book.packed.rows[first:first + events, exercise_scan.IS_PROD])]
    same_fit = [(p, q) for p, q in pairs
                if not (isinstance(p, mt.FlexiCall) and p.itm_only_regression)]
    compare_coeffs([p for p, _ in same_fit], jax_presim_coeffs(jc, [q for _, q in same_fit]),
                   spot0)


def test_exposure_book_walks_regression_and_exposure_dates():
    """A Bermudan on the per-date unrolled path in an EPE book: the fit walks
    its exercise dates and the exposure dates (controller.py:407-477), sets
    its ``regression_coeffs`` and values its exposures; held against the JAX
    package's unrolled path."""
    def book(pkg):
        option = pkg.BermudanOption(pkg.Equity("eq"), [0.3, 0.6, 1.0], 100.0, pkg.OptionType.PUT,
                                    asset_id="eq")
        metrics = pkg.RiskMetrics([pkg.EPEMetric()], exposure_timeline=[0.0, 0.45, 0.6, 0.9])
        return [pkg.NettingSet(name="b", products=[option])], bs(pkg), metrics

    jc = mj.SimulationController(*book(mj), N, N, 1, mj.SimulationScheme.ANALYTICAL, **JAX_FLAGS)
    jc._supports_exercise_scan = lambda p: False
    jr = jc.run_simulation()
    pc = mt.SimulationController(*book(mt), N, N, 1, mt.SimulationScheme.ANALYTICAL, device="cpu",
                                 noise_source=injected(jc, 1, 1), batch_products=False)
    pc._supports_exercise_scan = lambda p: False
    assert pc._exercise_scan_groups()[1] == pc.products
    compare(pc.run_simulation(), jr, False)
    compare_coeffs(pc.products, jax_presim_coeffs(jc, jc.products), 100.0)


def test_scan_matches_unrolled_and_bucket_matches_one_by_one():
    """In the port, on one book (so one timeline and one set of paths): the
    event scans against the per-date unrolled path, and buckets of several
    products against the same products each in a bucket of its own (the
    ``scan_bucket_statics() is None`` opt-out), rel 1e-12."""
    n = 2048

    def products():
        return ([scan_storage(mt, 1.0 + k) for k in range(3)]
                + [flexicall(mt), flexicall(mt, 1)]
                + [mt.AmericanOption(mt.Equity("gas"), 1.5, 4, 10.0 + k, mt.OptionType.PUT,
                                     asset_id="gas") for k in range(2)])

    def pvs(mode):
        netting_sets = [mt.NettingSet(name=f"p{i}", products=[p])
                        for i, p in enumerate(products())]
        c = mt.SimulationController(netting_sets, s2f(mt), PV(mt), n, n, 1,
                                    mt.SimulationScheme.ANALYTICAL, device="cpu",
                                    batch_products=False)
        if mode == "unrolled":
            c._supports_exercise_scan = lambda p: False
        elif mode == "alone":
            for p in c.products:
                p.scan_bucket_statics = lambda: None
        sizes = sorted(len(b) for b in c._exercise_scan_groups()[0])
        values = c.run_simulation()
        return sizes, np.array([float(values.get_results(ns.name, "pv", evaluation_idx=0))
                                for ns in netting_sets])

    (sizes, scan), (no_buckets, unrolled), (ones, alone) = (pvs(m) for m in
                                                            ("bucketed", "unrolled", "alone"))
    assert sizes == [1, 1, 2, 3] and no_buckets == [] and ones == [1] * 7
    np.testing.assert_allclose(scan, unrolled, rtol=1e-12)
    np.testing.assert_allclose(scan, alone, rtol=1e-12)


# -- storage configuration, transitions and ties --------------------------------------

def mixed_book_storage_config(pkg, i):
    """The volume windows, ramps and costs of the i-th storage of the mixed
    book (benchmarks/pv_large_book.py:49-70, :138-143)."""
    maturity, capacity = [1.0, 1.5, 2.0, 2.5][i % 4], [18.0, 26.0, 34.0, 42.0][i % 4]
    inj_cost, wd_cost = 0.10 + 0.02 * (i % 4), 0.08 + 0.015 * (i % 4)
    cfg = pkg.StorageConfig()
    ramp_end, plateau_end = 0.35 * maturity, 0.70 * maturity
    cfg.add_volume_constraint(0.0, ramp_end, 0.0, 0.55 * capacity)
    cfg.add_volume_constraint(ramp_end, plateau_end, 0.10 * capacity, 0.85 * capacity)
    cfg.add_volume_constraint(plateau_end, maturity, 0.0, capacity)
    cfg.add_injection_flexibility(0.0, ramp_end, 0.0, 0.30 * capacity)
    cfg.add_injection_flexibility(0.0, ramp_end, 0.60 * capacity, 0.18 * capacity)
    cfg.add_injection_flexibility(ramp_end, maturity, 0.0, 0.22 * capacity)
    cfg.add_injection_flexibility(ramp_end, maturity, 0.60 * capacity, 0.12 * capacity)
    cfg.add_withdrawal_flexibility(0.0, plateau_end, 0.0, 0.16 * capacity)
    cfg.add_withdrawal_flexibility(0.0, plateau_end, 0.60 * capacity, 0.24 * capacity)
    cfg.add_withdrawal_flexibility(plateau_end, maturity, 0.0, 0.24 * capacity)
    cfg.add_withdrawal_flexibility(plateau_end, maturity, 0.60 * capacity, 0.32 * capacity)
    cfg.add_variable_injection_cost(0.0, inj_cost)
    cfg.add_variable_injection_cost(plateau_end, inj_cost * 1.10)
    cfg.add_variable_withdrawal_cost(0.0, wd_cost)
    cfg.add_variable_withdrawal_cost(plateau_end, wd_cost * 1.10)
    return cfg, maturity, 2.0 + 0.5 * (i % 5), [0.05, 0.10, 0.125][i % 3]


def test_storage_config_optimizer_matches_jax_exactly():
    """``optimize_volume_constraints`` on the 60 distinct storage set-ups of
    the mixed book: the same windows as the JAX package's, bit for bit."""
    for i in range(60):
        (pc, maturity, initial, rollout), (jc, _, _, _) = (mixed_book_storage_config(mt, i),
                                                           mixed_book_storage_config(mj, i))
        for cfg in (pc, jc):
            cfg.optimize_volume_constraints(0.0, maturity, rollout, initial)
        assert len(pc.volume_constraints) == len(jc.volume_constraints) > 8
        for a, b in zip(pc.volume_constraints, jc.volume_constraints):
            assert (a.start_date, a.end_date, a.vmin, a.vmax, a.penalty) == (
                b.start_date, b.end_date, b.vmin, b.vmax, b.penalty)


def constant_window_storage():
    """tests/test_storage.py:24-37."""
    cfg = mt.StorageConfig()
    cfg.add_volume_constraint(0.0, 4.0, 0.0, 12.0, 0.0)
    cfg.add_injection_flexibility(0.0, 4.0, 0.0, 3.0)
    cfg.add_injection_flexibility(0.0, 4.0, 6.0, 1.5)
    cfg.add_withdrawal_flexibility(0.0, 4.0, 0.0, 1.0)
    cfg.add_withdrawal_flexibility(0.0, 4.0, 6.0, 2.5)
    cfg.add_variable_injection_cost(0.0, 1.0)
    cfg.add_variable_withdrawal_cost(0.0, 1.0)
    return mt.Storage(asset_id="thegasprice", start_date=0.0, end_date=4.0, initial_amount=4.0,
                      storage_config=cfg, num_states=4)


def test_storage_transitions():
    """The four cases of tests/test_storage.py on the port."""
    states = torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=torch.float64)
    storage = constant_window_storage()
    current = storage.state_to_volume(1.0, states)
    next_states = storage.compute_next_state(1.0, 2.0, mt.StorageAction.INJECTION)(states)
    next_volumes = storage.state_to_volume(2.0, next_states)
    assert bool((torch.diff(next_states) >= 0).all()) and bool((next_volumes >= current).all())
    np.testing.assert_allclose(next_volumes.numpy(), [4.5, 5.5, 6.5, 7.5], atol=1e-10)

    cfg = mt.StorageConfig()
    cfg.add_volume_constraint(0.0, 2.0, 0.0, 12.0, 0.0)
    cfg.add_volume_constraint(2.0, 3.0, 0.0, 12.0, 0.0)
    cfg.add_volume_constraint(3.0, 4.0, 3.0, 9.0, 0.0)
    cfg.add_injection_flexibility(0.0, 4.0, 0.0, 3.0)
    cfg.add_withdrawal_flexibility(0.0, 4.0, 0.0, 3.0)
    cfg.add_variable_injection_cost(0.0, 0.0)
    cfg.add_variable_withdrawal_cost(0.0, 0.0)
    shifting = mt.Storage(asset_id="thegasprice", start_date=0.0, end_date=4.0, initial_amount=6.0,
                          storage_config=cfg, num_states=4)
    held = shifting.compute_next_state(2.0, 3.0, mt.StorageAction.DO_NOTHING)(states)
    np.testing.assert_allclose(shifting.state_to_volume(3.0, held).numpy(), [3.0, 4.0, 8.0, 9.0],
                               atol=1e-10)
    assert float(held[1]) == 0.5

    for action in mt.StorageAction:
        moved = storage.state_to_volume(2.0, storage.compute_next_state(1.0, 2.0, action)(states))
        delta = storage.compute_volume_difference(1.0, 2.0, action)(states)
        np.testing.assert_allclose(delta.numpy(), (moved - current).numpy(), atol=1e-10)

    cfg = mt.StorageConfig()
    cfg.add_volume_constraint(0.0, 2.0, 0.0, 2.0, 0.0)
    cfg.add_injection_flexibility(0.0, 2.0, 0.0, 1.0)
    cfg.add_withdrawal_flexibility(0.0, 2.0, 0.0, 1.0)
    cfg.add_variable_injection_cost(0.0, 0.0)
    cfg.add_variable_withdrawal_cost(0.0, 0.0)
    product = mt.Storage(asset_id="thegasprice", start_date=0.0, end_date=2.0, initial_amount=1.0,
                         storage_config=cfg, num_states=3)
    model = mt.SchwartzTwoFactorModel(0.0, curve_times=[0.0, 2.0], curve_values=[10.0, 10.0],
                                      rate=0.0, short_term_mean_reversion=1.0, short_term_vol=1e-8,
                                      long_term_drift=0.0, long_term_vol=1e-8, rho=0.0,
                                      asset_id="thegasprice")
    c = mt.SimulationController([mt.NettingSet(name="s", products=[product])], model, PV(mt),
                                2000, 2000, 1, mt.SimulationScheme.ANALYTICAL, device="cpu")
    assert abs(float(c.run_simulation().get_results("s", "pv", evaluation_idx=0)) - 10.0) < 1e-3


def test_storage_step_resolves_ties_like_jax_argmax():
    """Ties between action values go to the first of (inject, hold,
    withdraw), as jnp.argmax resolves them.  At a full store inject and hold
    reach the same volume, at an empty one withdraw and hold do; at a zero
    spot with zero costs and continuation all three actions tie at value 0
    and only the tie rule tells their next states apart."""
    def setup(pkg):
        cfg = pkg.StorageConfig()
        cfg.add_volume_constraint(0.0, 2.0, 0.0, 10.0)
        cfg.add_injection_flexibility(0.0, 2.0, 0.0, 3.0)
        cfg.add_withdrawal_flexibility(0.0, 2.0, 0.0, 3.0)
        cfg.add_variable_injection_cost(0.0, 0.0)
        cfg.add_variable_withdrawal_cost(0.0, 0.0)
        return pkg.Storage(asset_id="gas", start_date=0.0, end_date=2.0, initial_amount=5.0,
                           storage_config=cfg, num_states=5, rollout_interval=0.5)

    ps, js = setup(mt), setup(mj)
    row = 1  # an interior date: the whole window is reachable
    extras = {k: v[row:row + 1] for k, v in ps.scan_event_extras().items()}
    states = np.array([[[0.0], [4.0], [2.0], [0.0], [4.0], [2.0]]])  # empty, full, half
    spot = np.array([[10.0, 10.0, 10.0, 0.0, 0.0, 0.0]])
    coeffs = np.zeros((1, 5, 3))
    pnext, pcf = ps.scan_exercise_step(
        mt.PolynomialRegression(2), torch.tensor(states), None, torch.tensor(spot),
        torch.ones(1, 6, dtype=torch.float64), torch.zeros(1, dtype=torch.float64),
        torch.tensor(coeffs), {k: torch.tensor(v) for k, v in extras.items()})
    jnext, jcf = jax.vmap(lambda s, x, c, e: js.scan_exercise_step(
        mj.PolynomialRegression(2), s, None, x, jnp.ones(6), 0.0, c, e))(
        jnp.asarray(states), jnp.asarray(spot), jnp.asarray(coeffs),
        {k: jnp.asarray(v) for k, v in extras.items()})
    np.testing.assert_array_equal(pnext.numpy(), np.asarray(jnext))
    np.testing.assert_array_equal(pcf.numpy(), np.asarray(jcf))
    # zero spot: every action ties and inject is taken, from the optimized
    # windows of this date (a constant ramp of 3 a year)
    x = {k: float(v[0]) for k, v in extras.items() if v.ndim == 1}
    prev_vol = x["prev_vmin"] + states[0, 3:, 0] * (x["prev_vmax"] - x["prev_vmin"]) / 4.0
    inject = np.minimum(prev_vol + 3.0 * x["period"], x["next_vmax"])
    expected = (inject - x["next_vmin"]) * 4.0 / (x["next_vmax"] - x["next_vmin"])
    hold = (np.clip(prev_vol, x["next_vmin"], x["next_vmax"]) - x["next_vmin"]) * 4.0 / (
        x["next_vmax"] - x["next_vmin"])
    assert (expected > hold).any()
    np.testing.assert_allclose(pnext[0, 3:, 0].numpy(), expected, rtol=1e-12)


# -- the least-squares fit ---------------------------------------------------------

def test_fit_least_squares_matches_jax_with_weights_ridge_and_batch():
    rs = np.random.default_rng(7)
    n = 1000
    x = 100.0 * np.exp(0.2 * rs.standard_normal((3, n)))
    A = np.stack([x ** k for k in range(3)], axis=-1)  # [3, N, 3]
    Y = np.maximum(100.0 - x, 0.0)[..., None] * np.array([1.0, 0.5])  # [3, N, 2]
    w = (x < 100.0).astype(np.float64)
    for weights in (None, w):
        batched = fit_least_squares(torch.tensor(A), torch.tensor(Y),
                                    weights=None if weights is None else torch.tensor(weights))
        assert batched.shape == (3, 2, 3)
        for b in range(3):
            ref = np.asarray(jax_fit(jnp.asarray(A[b]), jnp.asarray(Y[b]),
                                     weights=None if weights is None else jnp.asarray(weights[b])))
            np.testing.assert_allclose(batched[b].numpy(), ref, rtol=1e-8, atol=1e-12)
            one = fit_least_squares(torch.tensor(A[b]), torch.tensor(Y[b]),
                                    weights=None if weights is None else torch.tensor(weights[b]))
            np.testing.assert_allclose(batched[b].numpy(), one.numpy(), rtol=1e-12,
                                       atol=1e-15)
    # rank-deficient basis (a constant explanatory, an American's t = 0
    # date): the ridge keeps it solvable; an explicit ridge_rel is honoured
    const = np.stack([np.full(n, 100.0) ** k for k in range(3)], axis=-1)
    # (its coefficients are set by the ridge alone, ~1e-6 relative rounding:
    # compared by the value they predict at the constant)
    basis = 100.0 ** np.arange(3)
    for ridge in (None, 1e-6):
        ref = np.asarray(jax_fit(jnp.asarray(const), jnp.asarray(Y[0]), ridge_rel=ridge))
        out = fit_least_squares(torch.tensor(const), torch.tensor(Y[0]), ridge_rel=ridge)
        assert bool(torch.isfinite(out).all())
        np.testing.assert_allclose(out.numpy() @ basis, ref @ basis, rtol=1e-9)
    assert not np.allclose(np.asarray(jax_fit(jnp.asarray(const), jnp.asarray(Y[0]))) @ basis,
                           np.asarray(jax_fit(jnp.asarray(const), jnp.asarray(Y[0]),
                                              ridge_rel=0.5)) @ basis, rtol=1e-3)


def test_flexicall_checks_raise_value_error():
    """The JAX package asserts these (flexicall.py:34-45), which python -O
    strips; the port raises."""
    opt = lambda t, kind=mt.OptionType.CALL: mt.EuropeanOption(mt.Equity("eq"), t, 100.0, kind,
                                                               asset_id="eq")
    with pytest.raises(ValueError, match="exceed"):
        mt.FlexiCall([opt(0.5), opt(1.0)], 3, asset_id="eq")
    with pytest.raises(ValueError, match="option type"):
        mt.FlexiCall([opt(0.5), opt(1.0, mt.OptionType.PUT)], 1, asset_id="eq")
    with pytest.raises(ValueError, match="distinct"):
        mt.FlexiCall([opt(0.5), opt(0.5)], 1, asset_id="eq")
