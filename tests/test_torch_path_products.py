"""The port's binary, Asian and barrier options against the JAX package on
the same numbers (f64, the JAX engine's own threefry draws injected through
``noise_source`` and its bridge uniforms through ``bridge_source``), their
closed forms, and the port's refusal of the Brownian bridge off
Black-Scholes.

Two barrier formulas of the JAX package are wrong and the port repairs them,
so there the oracle is a numpy copy of the right formula, not JAX: the
Brownian bridge's interval (maturity - startdate) / (n_obs - 1), where JAX
takes maturity / n_obs, and the down-and-out call's closed form, whose
strike term JAX takes without a factor S/B.  Discretely monitored barriers
stay held against JAX, where the two packages agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu_torch import rng
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")
N = 512


def jax_bridge_uniforms(product_id, barrier_idx, num_paths, num_intervals):
    """The JAX package's bridge stream (barrier_option.py:185-195)."""
    base = jax_rng.phase_key(jax_rng.root_key(0), jax_rng.PHASE_BRIDGE)
    key = jax_rng.step_key(base, product_id, barrier_idx)
    return torch.from_numpy(np.array(jax_rng.uniforms(key, (num_paths, num_intervals),
                                                      jnp.float64)))


def path_book(pkg):
    """Two binaries, both Asian averagings, and barriers of every type, one
    and two barriers, discretely monitored and with the bridge: each product
    its own netting set."""
    B, call, put = pkg.BarrierOptionType, pkg.OptionType.CALL, pkg.OptionType.PUT
    products = [
        pkg.BinaryOption(1.0, 100.0, 10.0, call, asset_id="eq"),
        pkg.BinaryOption(1.5, 95.0, 8.0, put, asset_id="eq"),
        pkg.AsianOption(0.0, 1.0, 100.0, 6, call, pkg.AsianAveragingType.ARITHMETIC, asset_id="eq"),
        pkg.AsianOption(0.0, 1.0, 98.0, 5, put, pkg.AsianAveragingType.GEOMETRIC, asset_id="eq"),
    ]
    barriers = [(B.UPANDOUT, 125.0, None, None), (B.DOWNANDOUT, 85.0, None, None),
                (B.UPANDIN, 120.0, None, None), (B.DOWNANDIN, 90.0, None, None),
                (B.UPANDOUT, 130.0, B.DOWNANDOUT, 80.0)]
    for bridge in (False, True):
        for kind, b1, kind2, b2 in barriers:
            option = pkg.BarrierOption(0.0, 1.0, 100.0, 7, call if b1 > 100 else put, b1, kind,
                                       barrier2=b2, barrier_option_type2=kind2, asset_id="eq")
            if bridge:
                option.set_use_brownian_bridge()
            products.append(option)
    return [pkg.NettingSet(name=f"p{i}", products=[p]) for i, p in enumerate(products)]


def bs(pkg):
    return pkg.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq")


BS_PARAMS = (100.0, 0.25, 0.03)  # spot, volatility, rate of bs()


def numpy_spots(normals, timeline, steps, spot, sigma, rate):
    """[T, N] Black-Scholes spots of the exact scheme on the given standard
    normals (counter = point index x steps + sub-step), in numpy."""
    s, t_prev, out = np.full(normals.shape[1], spot), 0.0, []
    for i, t in enumerate(timeline):
        dt = (t - t_prev) / steps
        for k in range(steps if t > t_prev else 0):
            s = s * np.exp((rate - 0.5 * sigma * sigma) * dt
                           + sigma * np.sqrt(dt) * normals[i * steps + k])
        out.append(s)
        t_prev = t
    return np.array(out)


def ramp(x, fuzzy, eps=0.05):
    return np.clip((x + eps) / (2 * eps), 0.0, 1.0) if fuzzy else (x > 0).astype(float)


def numpy_bridge_pv(option, spots, uniforms, sigma, rate, fuzzy):
    """(PV, SE) of a Brownian-bridge barrier option from its monitored spots
    [N, n_obs]: the crossing probability exp(-2 ln(S_i/B) ln(S_i+1/B) /
    (sigma^2 dt)) over the observation interval dt = (maturity - startdate)
    / (n_obs - 1), compared with the bridge uniforms."""
    dates = option.modeling_timeline
    dt = (dates[-1] - dates[0]) / (len(dates) - 1)
    sign = 1.0 if option.option_type == mt.OptionType.CALL else -1.0
    payoff = np.maximum(sign * (spots[:, -1] - option.strike), 0.0)
    kinds = [(option.barrier1, option.barrier_option_type1)]
    if option.barrier2 is not None:
        kinds.append((option.barrier2, option.barrier_option_type2))
    for (barrier, kind), u in zip(kinds, uniforms):
        below_max = ramp(barrier - spots.max(axis=1), True)
        above_min = ramp(spots.min(axis=1) - barrier, True)
        log_ratio = np.log(spots / barrier)
        crossing = np.exp(-2.0 * log_ratio[:, :-1] * log_ratio[:, 1:] / (sigma * sigma * dt))
        hit = 1.0 - np.prod(1.0 - ramp(crossing - u, fuzzy), axis=1)
        payoff = payoff * {"UPANDOUT": below_max * (1.0 - hit),
                           "DOWNANDOUT": above_min * (1.0 - hit),
                           "UPANDIN": (1.0 - below_max) * hit,
                           "DOWNANDIN": (1.0 - above_min) * hit}[kind.name]
    values = payoff / np.exp(rate * option.maturity)
    return values.mean(), values.std(ddof=1) / np.sqrt(len(values))


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_path_products_match_jax_controller(differentiate):
    """Binaries, Asians and discretely monitored barriers against the JAX
    controller; the bridge barriers against :func:`numpy_bridge_pv` on the
    same draws and uniforms (values, SEs and, differentiated, central
    differences of it in spot, volatility and rate)."""
    jc = mj.SimulationController(path_book(mj), bs(mj), mj.RiskMetrics([mj.PVMetric()]), N, 0, 2,
                                 mj.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 **JAX_FLAGS)
    jr = jc.run_simulation()
    steps = 2
    counters = len(jc.simulation_timeline) * steps
    noise = {jax_rng.PHASE_MAINSIM: jax_engine_normals(0, jax_rng.PHASE_MAINSIM, counters, N, 1)}
    book = path_book(mt)
    pc = mt.SimulationController(book, bs(mt), mt.RiskMetrics([mt.PVMetric()]), N, 0, steps,
                                 mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 device="cpu", noise_source=noise,
                                 bridge_source=jax_bridge_uniforms)
    assert pc.simulation_timeline == jc.simulation_timeline and not pc.requires_regression
    pr = pc.run_simulation()
    bridged = {ns.name: ns.products[0] for ns in book
               if getattr(ns.products[0], "use_brownian_bridge", False)}
    assert len(bridged) == 5
    for ns in jr.get_netting_set_names():
        if ns in bridged:
            continue
        np.testing.assert_allclose(pr.get_results(ns, "pv"), jr.get_results(ns, "pv"), rtol=1e-9,
                                   atol=1e-13, err_msg=ns)
        np.testing.assert_allclose(pr.get_mc_error(ns, "pv"), jr.get_mc_error(ns, "pv"),
                                   rtol=1e-9, atol=1e-13, err_msg=ns)
        if differentiate:
            np.testing.assert_allclose(np.asarray(pr.get_derivatives(ns, "pv")),
                                       np.asarray(jr.get_derivatives(ns, "pv")),
                                       rtol=1e-7, atol=1e-10, err_msg=ns)

    normals = np.stack([noise[jax_rng.PHASE_MAINSIM](c)[0][:, 0].numpy() for c in range(counters)])
    index = {t: i for i, t in enumerate(pc.simulation_timeline)}

    def oracle(option, params):
        spots = numpy_spots(normals, pc.simulation_timeline, steps, *params)
        monitored = spots[[index[t] for t in option.modeling_timeline]].T
        uniforms = [jax_bridge_uniforms(option.product_id, k, N, monitored.shape[1] - 1).numpy()
                    for k in range(1 + (option.barrier2 is not None))]
        return numpy_bridge_pv(option, monitored, uniforms, params[1], params[2], differentiate)

    for ns, option in bridged.items():
        pv, se = oracle(option, BS_PARAMS)
        np.testing.assert_allclose(float(pr.get_results(ns, "pv", evaluation_idx=0)), pv,
                                   rtol=1e-9, atol=1e-13, err_msg=ns)
        np.testing.assert_allclose(float(pr.get_mc_error(ns, "pv", evaluation_idx=0)), se,
                                   rtol=1e-9, atol=1e-13, err_msg=ns)
        if differentiate:
            for j, name in enumerate(("spot", "volatility", "rate")):
                h = 1e-6 * BS_PARAMS[j]
                bump = lambda d: tuple(p + d * h * (k == j) for k, p in enumerate(BS_PARAMS))
                fd = (oracle(option, bump(1))[0] - oracle(option, bump(-1))[0]) / (2 * h)
                np.testing.assert_allclose(
                    pr.get_derivatives(ns, "pv", param=name, evaluation_idx=0), fd, rtol=1e-5,
                    atol=1e-7, err_msg=f"{ns} {name}")


def test_closed_forms_match_jax():
    jm, pm = bs(mj), bs(mt)
    jp, pp = jm.initial_params(), pm.initial_params()
    for kind in ("CALL", "PUT"):
        for maturity, strike in ((0.5, 95.0), (2.0, 110.0)):
            jb = mj.BinaryOption(maturity, strike, 10.0, mj.OptionType[kind], asset_id="eq")
            pb = mt.BinaryOption(maturity, strike, 10.0, mt.OptionType[kind], asset_id="eq")
            assert pb.supports_analytic_pv(pm)
            np.testing.assert_allclose(float(pb.compute_pv_analytically(pm, pp)),
                                       float(jb.compute_pv_analytically(jm, jp)), rtol=1e-12)
    for kind, barrier in (("UPANDOUT", 130.0), ("DOWNANDOUT", 80.0)):
        for maturity, strike in ((1.0, 100.0), (2.5, 90.0)):
            make = lambda pkg: pkg.BarrierOption(0.0, maturity, strike, 12, pkg.OptionType.CALL,
                                                 barrier, pkg.BarrierOptionType[kind],
                                                 asset_id="eq")
            # the JAX down-and-out call is wrong: its oracle is the textbook
            ref = (float(make(mj).compute_pv_analytically(jm, jp)) if kind == "UPANDOUT"
                   else textbook_down_and_out_call(100.0, strike, barrier, 0.03, 0.25, maturity))
            np.testing.assert_allclose(float(make(mt).compute_pv_analytically(pm, pp)), ref,
                                       rtol=1e-12)


def textbook_down_and_out_call(s, k, b, r, sigma, t):
    """Down-and-out call on a non-dividend stock (Hull, Options, Futures and
    Other Derivatives, barrier options; Reiner and Rubinstein 1991), in
    numpy/scipy: the vanilla call less the down-and-in call for K >= B, the
    direct form for K < B."""
    n, vol = scipy.stats.norm.cdf, sigma * np.sqrt(t)
    lam = (r + 0.5 * sigma ** 2) / sigma ** 2
    disc_k = k * np.exp(-r * t)
    if s <= b:
        return 0.0
    if k >= b:
        d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / vol
        call = s * n(d1) - disc_k * n(d1 - vol)
        y = np.log(b * b / (s * k)) / vol + lam * vol
        down_in = s * (b / s) ** (2 * lam) * n(y) - disc_k * (b / s) ** (2 * lam - 2) * n(y - vol)
        return call - down_in
    x1 = np.log(s / b) / vol + lam * vol
    y1 = np.log(b / s) / vol + lam * vol
    return (s * n(x1) - disc_k * n(x1 - vol) - s * (b / s) ** (2 * lam) * n(y1)
            + disc_k * (b / s) ** (2 * lam - 2) * n(y1 - vol))


def test_down_and_out_call_repairs_the_jax_closed_form():
    """S = K = 100, B = 80, r = 5 %, sigma = 20 %, T = 1 (the case of
    tests/test_pv_products.py:94-101): the JAX package's strike term lacks a
    factor S/B and gives 10.0968246; the port gives the textbook 10.3513452
    (a 2,000-step Monte Carlo gives 10.333 +- 0.058)."""
    make = lambda pkg: pkg.BarrierOption(0.0, 1.0, 100.0, 12, pkg.OptionType.CALL, 80.0,
                                         pkg.BarrierOptionType.DOWNANDOUT)
    jm, pm = (pkg.BlackScholesModel(0.0, 100.0, 0.05, 0.2) for pkg in (mj, mt))
    jax_value = float(make(mj).compute_pv_analytically(jm, jm.initial_params()))
    port_value = float(make(mt).compute_pv_analytically(pm, pm.initial_params()))
    assert round(jax_value, 7) == 10.0968246
    assert round(port_value, 7) == 10.3513452
    np.testing.assert_allclose(port_value,
                               textbook_down_and_out_call(100.0, 100.0, 80.0, 0.05, 0.2, 1.0),
                               rtol=1e-12)


@pytest.mark.parametrize("strike,barrier", [(100.0, 80.0), (120.0, 95.0), (90.0, 95.0),
                                            (80.0, 99.0)], ids=["atm", "otm", "k_below_b",
                                                                "b_near_spot"])
def test_down_and_out_call_matches_textbook_formula(strike, barrier):
    for rate, sigma, maturity in ((0.05, 0.2, 1.0), (0.01, 0.35, 2.5), (0.08, 0.15, 0.25)):
        model = mt.BlackScholesModel(0.0, 100.0, rate, sigma)
        option = mt.BarrierOption(0.0, maturity, strike, 12, mt.OptionType.CALL, barrier,
                                  mt.BarrierOptionType.DOWNANDOUT)
        np.testing.assert_allclose(
            float(option.compute_pv_analytically(model, model.initial_params())),
            textbook_down_and_out_call(100.0, strike, barrier, rate, sigma, maturity),
            rtol=1e-12, err_msg=f"{rate} {sigma} {maturity}")


def test_bridge_refused_off_black_scholes():
    """Under BlackScholesMulti the JAX package's bridge reads params[1], the
    second asset's spot, as the volatility (barrier_option.py:146): it
    returns a value, and the port refuses the bridge with ValueError."""
    assets = ["a0", "a1"]

    def setup(pkg):
        model = pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=assets, spots=[100.0, 90.0],
                                      volatilities=[0.2, 0.25],
                                      correlation_matrix=np.array([[1.0, 0.3], [0.3, 1.0]]))
        option = pkg.BarrierOption(0.0, 1.0, 100.0, 5, pkg.OptionType.CALL, 125.0,
                                   pkg.BarrierOptionType.UPANDOUT, asset_id="a0")
        option.set_use_brownian_bridge()
        return [pkg.NettingSet(name="b", products=[option])], model

    jc = mj.SimulationController(*setup(mj), mj.RiskMetrics([mj.PVMetric()]), 256, 0, 1,
                                 mj.SimulationScheme.ANALYTICAL, **JAX_FLAGS)
    assert float(jc.model.initial_params()[1]) == 90.0  # spot[a1], not a volatility
    assert np.isfinite(float(jc.run_simulation().get_results("b", "pv", evaluation_idx=0)))
    pc = mt.SimulationController(*setup(mt), mt.RiskMetrics([mt.PVMetric()]), 256, 0, 1,
                                 mt.SimulationScheme.ANALYTICAL, device="cpu")
    with pytest.raises(ValueError, match="BlackScholesModel"):
        pc.run_simulation()


def test_bridge_uniforms_stream():
    """The port's own bridge stream: uniforms in (0, 1), a counter per
    (product, barrier, path, interval), keyed by seed 0 whatever the run's
    root seed."""
    u = rng.bridge_uniforms(3, 0, 4096, 6, torch.float64, "cpu")
    assert u.shape == (4096, 6) and bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert torch.equal(u, rng.bridge_uniforms(3, 0, 4096, 6, torch.float64, "cpu"))
    assert not torch.equal(u, rng.bridge_uniforms(3, 1, 4096, 6, torch.float64, "cpu"))
    assert not torch.equal(u, rng.bridge_uniforms(4, 0, 4096, 6, torch.float64, "cpu"))
    # a path's uniforms do not depend on how many paths are drawn
    assert torch.equal(u[:100], rng.bridge_uniforms(3, 0, 100, 6, torch.float64, "cpu"))

    def pv(root_seed):
        option = mt.BarrierOption(0.0, 1.0, 100.0, 5, mt.OptionType.CALL, 120.0,
                                  mt.BarrierOptionType.UPANDOUT, asset_id="eq")
        option.set_use_brownian_bridge()
        c = mt.SimulationController([mt.NettingSet(name="b", products=[option])], bs(mt),
                                    mt.RiskMetrics([mt.PVMetric()]), 1024, 0, 1,
                                    mt.SimulationScheme.ANALYTICAL, root_seed=root_seed,
                                    device="cpu")
        return float(c.run_simulation().get_results("b", "pv", evaluation_idx=0))

    assert np.isfinite(pv(0)) and pv(0) != pv(1)
