"""The port's samplers against the JAX package: Sobol words and uniforms
(ops/sobol.py), the Brownian-bridge rotation, antithetic pairs, the engine
and the controller under ``sampler="sobol"`` (with and without
``qmc_bridge``) and ``antithetic=True``, the refusals, ``fixed_tree_sum``,
and the Philox uniform of a Heston model inside a ModelConfig.

Parity runs feed the port the JAX package's own draws: its threefry shift
words through ``qmc_shift`` / ``qmc_shift_source``, its half-size threefry
draws through ``noise_source`` under antithetic sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu.metrics.metrics import fixed_tree_sum as jax_fixed_tree_sum
from montecarlo_risk_engine_tpu.ops import sobol as jax_sobol
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.engine.engine import philox_noise_source, simulate_paths
from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum
from montecarlo_risk_engine_tpu_torch.ops import sobol

torch.set_num_threads(1)

HESTON_KW = dict(spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06, v0=0.04)
JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")
MAIN = jax_rng.PHASE_MAINSIM


def jax_shift(phase, num_dims, root_seed=0):
    """The JAX engine's digital-shift words (rng.py:51-61)."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(root_seed), phase)
    return np.asarray(jax_rng.qmc_shift(phase_k, num_dims)).astype(np.int64)


def sobol_dims(timeline, num_steps, sim_dim, uniform, bridge):
    """Sobol dimensions the engines draw (engine.py:148-238)."""
    counters = len(timeline) * num_steps
    if not bridge:
        return counters * (sim_dim + int(uniform))
    t_prev, live = 0.0, 0
    for t in timeline:
        live += num_steps if t > t_prev else 0
        t_prev = t
    return live * sim_dim + (counters if uniform else 0)


def jax_half_draws(phase, num_counters, num_paths, sim_dim, uniform, root_seed=0):
    """The JAX engine's antithetic half draws (engine.py:260-292)."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(root_seed), phase)

    def draw(c):
        z = jax_rng.normals(jax_rng.step_key(phase_k, c, jax_rng.PURPOSE_NORMAL),
                            (num_paths // 2, sim_dim), jnp.float64)
        u = jax_rng.uniforms(jax_rng.step_key(phase_k, c, jax_rng.PURPOSE_UNIFORM),
                             (num_paths // 2,), jnp.float64)
        return z, u

    z, u = jax.jit(jax.vmap(draw))(jnp.arange(num_counters))
    z, u = torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))
    return lambda c: (z[c], u[c] if uniform else None)


def jax_full_draws(phase, num_counters, num_paths, sim_dim, root_seed=0):
    """The JAX engine's normals [N, sim_dim] and uniform [N] per counter."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(root_seed), phase)

    def draw(c):
        return (jax_rng.normals(jax_rng.step_key(phase_k, c, jax_rng.PURPOSE_NORMAL),
                                (num_paths, sim_dim), jnp.float64),
                jax_rng.uniforms(jax_rng.step_key(phase_k, c, jax_rng.PURPOSE_UNIFORM),
                                 (num_paths,), jnp.float64))

    z, u = jax.jit(jax.vmap(draw))(jnp.arange(num_counters))
    z, u = torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))
    return lambda c: (z[c], u[c])


def params_of(jmodel):
    return mt.params_from_numpy([np.asarray(p) for p in jmodel.initial_params()])


# -- Sobol words, uniforms, the bridge --------------------------------------------


def test_sobol_words_and_uniforms_match_jax_and_scipy():
    import scipy.stats.qmc as qmc

    d, n = 11, 256
    v = sobol.direction_numbers(d)
    np.testing.assert_array_equal(v, jax_sobol.direction_numbers(d))
    words = sobol.sobol_uint32(n, v).numpy()
    np.testing.assert_array_equal(words, np.asarray(jax_sobol.sobol_uint32(n, v)).astype(np.int64))
    np.testing.assert_array_equal(words.astype(np.float64) * 2.0 ** -32,
                                  qmc.Sobol(d=d, scramble=False).random(n))
    shift = jax_shift(MAIN, d)
    u = sobol.sobol_uniforms(n, v, shift, torch.float64).numpy()
    u_jax = np.asarray(jax_sobol.sobol_uniforms(n, v, jnp.asarray(shift.astype(np.uint32)),
                                                jnp.float64))
    np.testing.assert_array_equal(u, u_jax)
    assert 0.0 < u.min() and u.max() < 1.0


def test_direction_table_matches_scipy_over_many_dimensions():
    import scipy.stats.qmc as qmc

    d = 120  # the Heston book's Sobol dimensions under qmc_bridge
    words = sobol.sobol_uint32(64, sobol.direction_numbers(d)).numpy()
    np.testing.assert_array_equal(words.astype(np.float64) * 2.0 ** -32,
                                  qmc.Sobol(d=d, scramble=False).random(64))


def test_sobol_dimension_guard():
    for pkg in (sobol, jax_sobol):
        with pytest.raises(ValueError, match="Joe-Kuo"):
            pkg.direction_numbers(30_000)


def test_qmc_shift_lane_is_phase_keyed():
    pre = rng.qmc_shift(0, rng.PHASE_PRESIM, 64)
    main = rng.qmc_shift(0, rng.PHASE_MAINSIM, 64)
    assert pre.dtype == torch.int64 and int(main.min()) >= 0 and int(main.max()) < 2 ** 32
    assert not torch.equal(pre, main)
    assert torch.equal(rng.qmc_shift(0, rng.PHASE_MAINSIM, 16), main[:16])


@pytest.mark.parametrize("dt", [
    np.full(8, 0.25), np.array([0.1, 0.0, 0.3, 0.2, 0.2, 0.0, 0.05]), np.array([0.7])],
    ids=["uniform", "ragged", "one"])
def test_brownian_bridge_matrix_matches_jax(dt):
    m = sobol.brownian_bridge_matrix(dt)
    np.testing.assert_allclose(m, jax_sobol.brownian_bridge_matrix(dt), rtol=1e-15, atol=1e-15)
    live = dt > 0
    np.testing.assert_allclose(m[live] @ m[live].T, np.eye(int(live.sum())), atol=1e-13)


# -- the engine --------------------------------------------------------------------


ENGINE_CASES = {
    "bs": (lambda pkg: pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq"),
           "EULER", (0.5, 1.0, 1.0, 2.0), 2),
    "heston_qe": (lambda pkg: pkg.HestonModel(0.0, asset_id="eq", **HESTON_KW), "QE",
                  (0.25, 0.5, 1.0), 3),
}


@pytest.mark.parametrize("bridge", [False, True], ids=["sobol", "sobol_bridge"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_sobol_matches_jax_on_its_shift(case, bridge):
    make, scheme, timeline, steps = ENGINE_CASES[case]
    n = 1024
    jmodel, model = make(mj), make(mt)
    ref = np.asarray(jax_simulate_paths(jmodel, jmodel.initial_params(),
                                        mj.SimulationScheme[scheme], timeline, n, steps, MAIN,
                                        sampler="sobol", qmc_bridge=bridge))
    uniform = model.uses_uniforms(mt.SimulationScheme[scheme])
    shift = jax_shift(MAIN, sobol_dims(timeline, steps, model.simulation_dim, uniform, bridge))
    states = simulate_paths(model, params_of(jmodel), mt.SimulationScheme[scheme], timeline, n,
                            steps, MAIN, sampler="sobol", qmc_bridge=bridge, qmc_shift=shift,
                            device="cpu")
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-12)
    default = simulate_paths(model, model.initial_params(), mt.SimulationScheme[scheme], timeline,
                             n, steps, MAIN, sampler="sobol", qmc_bridge=bridge, device="cpu")
    assert torch.isfinite(default).all() and not torch.equal(default, states)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES) + ["north_star"])
def test_engine_antithetic_matches_jax_on_its_half_draws(case):
    from test_torch_hybrid_models import north_star_model, port_pkg

    if case == "north_star":
        jmodel, model, scheme, timeline, steps = (north_star_model(mj), north_star_model(port_pkg()),
                                                  "EULER", (0.5, 1.0, 2.0), 2)
    else:
        make, scheme, timeline, steps = ENGINE_CASES[case]
        jmodel, model = make(mj), make(mt)
    n = 512
    ref = np.asarray(jax_simulate_paths(jmodel, jmodel.initial_params(),
                                        mj.SimulationScheme[scheme], timeline, n, steps, MAIN,
                                        antithetic=True))
    uniform = model.uses_uniforms(mt.SimulationScheme[scheme])
    source = jax_half_draws(MAIN, len(timeline) * steps, n, model.simulation_dim, uniform)
    states = simulate_paths(model, params_of(jmodel), mt.SimulationScheme[scheme], timeline, n,
                            steps, MAIN, antithetic=True, noise_source=source, device="cpu")
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-12)
    default = simulate_paths(model, model.initial_params(), mt.SimulationScheme[scheme], timeline,
                             n, steps, MAIN, antithetic=True, device="cpu")
    z, _ = philox_noise_source(model, mt.SimulationScheme[scheme], n // 2, MAIN, 0,
                               torch.float64, "cpu")(0)
    assert torch.isfinite(default).all() and z.shape == (n // 2, model.simulation_dim)


def test_engine_refusals_match_jax():
    model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2)
    jmodel = mj.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2)
    cases = [(dict(antithetic=True), 7, "even num_paths"),
             (dict(sampler="sobol", antithetic=True), 8, "incompatible with antithetic"),
             (dict(qmc_bridge=True), 8, "requires sampler='sobol'"),
             (dict(sampler="halton"), 8, "unknown sampler")]
    for kw, n, match in cases:
        with pytest.raises(ValueError, match=match):
            simulate_paths(model, model.initial_params(), mt.SimulationScheme.EULER, (1.0,), n, 1,
                           MAIN, **kw)
        with pytest.raises(ValueError, match=match):
            jax_simulate_paths(jmodel, jmodel.initial_params(), mj.SimulationScheme.EULER, (1.0,),
                               n, 1, MAIN, **kw)
    with pytest.raises(ValueError, match="qmc_shift"):
        simulate_paths(model, model.initial_params(), mt.SimulationScheme.EULER, (1.0,), 8, 1,
                       MAIN, sampler="sobol", noise_source=lambda c: None, device="cpu")


# -- a Heston model inside a ModelConfig (the Philox uniform lane) ---------------


def heston_config(pkg):
    return pkg.ModelConfig([pkg.HestonModel(0.0, asset_id="hs", **HESTON_KW),
                            pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22,
                                                  asset_id="eq")],
                           inter_asset_correlation_matrix=[np.array([[0.3], [0.0]])])


def test_heston_model_config_engine_matches_jax():
    n, timeline, steps = 64, (0.5, 1.0), 2
    jmodel, model = heston_config(mj), heston_config(mt)
    ref = np.asarray(jax_simulate_paths(jmodel, jmodel.initial_params(), mj.SimulationScheme.QE,
                                        timeline, n, steps, MAIN))
    assert ref.shape == (2, n, 3) and np.isfinite(ref).all()
    source = jax_full_draws(MAIN, len(timeline) * steps, n, model.simulation_dim)
    states = simulate_paths(model, params_of(jmodel), mt.SimulationScheme.QE, timeline, n, steps,
                            MAIN, noise_source=source, device="cpu")
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-12)
    # The default Philox source: sim_dim 3 normals and a uniform from its own
    # lane, disjoint from the normals' words.
    z, u = philox_noise_source(model, mt.SimulationScheme.QE, n, MAIN, 0, torch.float64, "cpu")(1)
    assert z.shape == (n, 3) and u.shape == (n,)
    assert torch.equal(u, rng.substep_uniform(0, MAIN, 1, n, torch.float64, "cpu"))
    assert not torch.equal(u, rng.substep_draws(0, MAIN, 1, n, torch.float64, "cpu")[2])
    assert torch.isfinite(simulate_paths(model, model.initial_params(), mt.SimulationScheme.QE,
                                         timeline, n, steps, MAIN, device="cpu")).all()
    # K1's stream for Heston alone is unchanged: word 2 of the first call.
    alone = mt.HestonModel(0.0, **HESTON_KW)
    z1, u1 = philox_noise_source(alone, mt.SimulationScheme.QE, n, MAIN, 0, torch.float64, "cpu")(3)
    z_s, z_v, u_k1 = rng.substep_draws(0, MAIN, 3, n, torch.float64, "cpu")
    assert torch.equal(u1, u_k1) and torch.equal(z1, torch.stack([z_s, z_v], -1))


def test_heston_model_config_controller_matches_jax():
    n, steps = 2048, 2

    def book(pkg):
        ns = pkg.NettingSet(name="hs", products=[pkg.EuropeanOption(
            pkg.Equity("hs"), 1.0, 100.0, pkg.OptionType.CALL, asset_id="hs")])
        return [ns], heston_config(pkg), pkg.RiskMetrics([pkg.PVMetric()])

    jc = mj.SimulationController(*book(mj), n, 0, steps, mj.SimulationScheme.QE, **JAX_FLAGS)
    jr = jc.run_simulation()
    source = jax_full_draws(MAIN, len(jc.simulation_timeline) * steps, n, 3)
    pc = mt.SimulationController(*book(mt), n, 0, steps, mt.SimulationScheme.QE, device="cpu",
                                 noise_source={MAIN: source}, batch_products=False)
    pr = pc.run_simulation()
    for get in ("get_results", "get_mc_error"):
        np.testing.assert_allclose(getattr(pr, get)("hs", "pv", evaluation_idx=0),
                                   getattr(jr, get)("hs", "pv", evaluation_idx=0), rtol=1e-10)
    default = mt.SimulationController(*book(mt), n, 0, steps, mt.SimulationScheme.QE,
                                      device="cpu").run_simulation()
    pv, se = (float(f("hs", "pv", evaluation_idx=0)) for f in (default.get_results,
                                                                default.get_mc_error))
    assert abs(pv - float(jr.get_results("hs", "pv", evaluation_idx=0))) < 6 * se


# -- the controller ----------------------------------------------------------------


def bs_book(pkg, differentiate):
    model = pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    products = [pkg.EuropeanOption(pkg.Equity("eq"), t, k, pkg.OptionType.CALL, asset_id="eq")
                for t, k in ((1.0, 100.0), (2.0, 95.0))]
    return ([pkg.NettingSet(name=f"ns{i}", products=[p]) for i, p in enumerate(products)], model,
            pkg.RiskMetrics([pkg.PVMetric()]))


def heston_book(pkg, differentiate):
    model = pkg.HestonModel(0.0, asset_id="eq", **HESTON_KW)
    products = [pkg.EuropeanOption(pkg.Equity("eq"), t, 100.0, pkg.OptionType.CALL, asset_id="eq")
                for t in (0.5, 1.0)]
    return ([pkg.NettingSet(name=f"ns{i}", products=[p]) for i, p in enumerate(products)], model,
            pkg.RiskMetrics([pkg.PVMetric()]))


CONTROLLER_CASES = {
    "bs_antithetic": (bs_book, "EULER", 2, dict(antithetic=True)),
    "bs_sobol": (bs_book, "EULER", 2, dict(sampler="sobol")),
    "heston_sobol_bridge": (heston_book, "QE", 2, dict(sampler="sobol", qmc_bridge=True)),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_matches_jax_controller_on_its_draws(case):
    make, scheme, steps, kw = CONTROLLER_CASES[case]
    n = 4096
    jc = mj.SimulationController(*make(mj, True), n, 0, steps, mj.SimulationScheme[scheme],
                                 differentiate=True, **JAX_FLAGS, **kw)
    jr = jc.run_simulation()
    tl = jc.simulation_timeline
    port_kw = dict(kw)
    model = make(mt, True)[1]
    if kw.get("antithetic"):
        port_kw["noise_source"] = {MAIN: jax_half_draws(
            MAIN, len(tl) * steps, n, model.simulation_dim,
            model.uses_uniforms(mt.SimulationScheme[scheme]))}
    else:
        port_kw["qmc_shift_source"] = {MAIN: jax_shift(MAIN, sobol_dims(
            tl, steps, model.simulation_dim, model.uses_uniforms(mt.SimulationScheme[scheme]),
            kw.get("qmc_bridge", False)))}
    pc = mt.SimulationController(*make(mt, True), n, 0, steps, mt.SimulationScheme[scheme],
                                 differentiate=True, device="cpu", batch_products=False,
                                 **port_kw)
    assert not pc._kernel_active
    pr = pc.run_simulation()
    for ns in ("ns0", "ns1"):
        for get in ("get_results", "get_mc_error"):
            np.testing.assert_allclose(getattr(pr, get)(ns, "pv", evaluation_idx=0),
                                       getattr(jr, get)(ns, "pv", evaluation_idx=0), rtol=1e-10)
        for param in jr.get_model_param_names():
            np.testing.assert_allclose(
                pr.get_derivatives(ns, "pv", param=param, evaluation_idx=0),
                jr.get_derivatives(ns, "pv", param=param, evaluation_idx=0),
                rtol=1e-8, atol=1e-12, err_msg=param)


def test_controller_refusals_match_jax():
    for pkg, kw in ((mj, dict(use_pallas=False)), (mt, dict(device="cpu"))):
        parts = bs_book(pkg, False)
        with pytest.raises(ValueError, match="incompatible with antithetic"):
            pkg.SimulationController(*parts, 64, 0, 1, pkg.SimulationScheme.EULER,
                                     sampler="sobol", antithetic=True, **kw)
        with pytest.raises(ValueError, match="requires sampler='sobol'"):
            pkg.SimulationController(*parts, 64, 0, 1, pkg.SimulationScheme.EULER,
                                     qmc_bridge=True, **kw)
        with pytest.raises(ValueError, match="sampler must be"):
            pkg.SimulationController(*parts, 64, 0, 1, pkg.SimulationScheme.EULER,
                                     sampler="halton", **kw)
    parts = bs_book(mt, False)
    with pytest.raises(ValueError, match="kernel-eligible"):
        mt.SimulationController(*parts, 64, 0, 1, mt.SimulationScheme.ANALYTICAL, device="cpu",
                                use_kernel=True, sampler="sobol")
    with pytest.raises(ValueError, match="qmc_shift_source"):
        mt.SimulationController(*parts, 64, 0, 1, mt.SimulationScheme.EULER, device="cpu",
                                sampler="sobol", noise_source={MAIN: lambda c: None})
    c = mt.SimulationController(*parts, 64, 0, 1, mt.SimulationScheme.ANALYTICAL, device="cpu",
                                antithetic=True)
    assert not c._kernel_active  # the kernels take the pseudo sampler alone
    with pytest.raises(ValueError, match="even num_paths"):
        mt.SimulationController(*bs_book(mt, False), 63, 0, 1, mt.SimulationScheme.EULER,
                                device="cpu", antithetic=True).run_simulation()


# -- fixed_tree_sum -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_fixed_tree_sum_matches_jax_and_torch_sum(n):
    x = np.random.default_rng(n).standard_normal((n, 3)) * 1e3
    ours = fixed_tree_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_fixed_tree_sum(jnp.asarray(x))))
    np.testing.assert_allclose(ours.numpy(), torch.from_numpy(x).sum(0).numpy(), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_array_equal(fixed_tree_sum(torch.from_numpy(x.T.copy()), dim=1).numpy(),
                                  ours.numpy())
    assert fixed_tree_sum(torch.zeros((0, 3), dtype=torch.float64)).shape == (3,)
