"""The port's Hull-White, Schwartz-2F and deterministic CIR++ models held
against the JAX package on the same numbers (f64, numpy-made inputs, the
JAX engine's own threefry draws injected)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu.ops.pallas_hybrid import KernelBlock as JaxKernelBlock
from montecarlo_risk_engine_tpu.requests import AtomicRequestType as JaxReq
from montecarlo_risk_engine_tpu_torch import SimulationScheme
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

HW_TIMES, HW_DFS = [0.0, 1.37, 3.1, 5.0], [1.0, 0.958, 0.901, 0.842]
TIMELINE = (0.0, 0.4, 0.8, 1.3, 2.0, 3.0)
HAZARDS = {1.0: 0.02, 2.0: 0.022, 5.0: 0.028}
JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")
SCHEMES = [SimulationScheme.ANALYTICAL, SimulationScheme.EULER]


def hull_white(pkg):
    return pkg.HullWhiteModel(0.0, HW_TIMES, HW_DFS, volatility=0.01, mean_reversion=0.4,
                              asset_id="irs")


def schwartz(pkg, kappa=1.2):
    return pkg.SchwartzTwoFactorModel(0.0, [0.0, 1.0, 3.0], [50.0, 52.0, 55.0], rate=0.03,
                                      short_term_mean_reversion=kappa, short_term_vol=0.3,
                                      long_term_drift=0.01, long_term_vol=0.15, rho=0.35,
                                      asset_id="gas")


def engines_agree(jm, pm, scheme, sim_dim, n=256, steps=2):
    js = mj.SimulationScheme[scheme.name]
    ref = np.asarray(jax_simulate_paths(jm, jm.initial_params(), js, TIMELINE, n, steps, 43,
                                        root_seed=5))
    states = simulate_paths(pm, pm.initial_params(), scheme, TIMELINE, n, steps, 43,
                            noise_source=jax_engine_normals(5, 43, len(TIMELINE) * steps, n,
                                                            sim_dim), device="cpu")
    assert states.shape == ref.shape
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-14)


def test_hw_segment_forward_table_matches_jax():
    """One table (hull_white.py:52-66): the port's float64 segment forwards
    are bit-equal to JAX's, and the model's lookup, the port's kernel block
    and JAX's kernel block take the same segment, float32 straddles
    included."""
    jm, pm = hull_white(mj), hull_white(mt)
    assert np.array_equal(pm._fwd_segs_host, jm._fwd_segs_host)
    block = pm.kernel_block(SimulationScheme.ANALYTICAL)
    jblock = JaxKernelBlock("hw", "exact", 0, 2, 1, curve_times=tuple(HW_TIMES),
                            curve_vals=tuple(float(f) for f in jm._fwd_segs_host))
    assert (block.kind, block.scheme, block.curve_times, block.curve_vals) == (
        jblock.kind, jblock.scheme, jblock.curve_times, jblock.curve_vals)
    straddle = float(np.nextafter(np.float32(1.37), 0.0))  # f32 rounds it onto the pillar
    ref = torch.zeros((), dtype=torch.float64)
    for t in [0.0, 0.5, 1.37, straddle, 1.37 - 1e-9, 2.0, 3.1, 4.2, 5.0, 7.5]:
        assert block.hw_fwd0(t) == jblock.hw_fwd0(t)
        assert float(pm._fwd0(t, ref)) == block.hw_fwd0(t)
    for t in [0.0, 0.5, 1.37, 2.0, 3.1, 4.2, 5.0, 7.5]:  # away from straddles: JAX's f64 lookup
        assert float(pm._fwd0(t, ref)) == float(jm._fwd0(t))


@pytest.mark.parametrize("scheme", SCHEMES + [SimulationScheme.MILSTEIN])
def test_hw_engine_and_steps_match_jax(scheme):
    jm, pm = hull_white(mj), hull_white(mt)
    engines_agree(jm, pm, scheme, 1)
    jp, pp = jm.initial_params(), pm.initial_params()
    np.testing.assert_allclose(pm.covariance_matrix(pp, 0.3).numpy(),
                               np.asarray(jm.covariance_matrix(jp, 0.3)), rtol=1e-15)
    rs = np.random.default_rng(2)
    state = np.stack([0.03 + 0.01 * rs.standard_normal(64), 0.05 * rs.random(64)], axis=-1)
    nxt = np.asarray(jm.step(jp, mj.SimulationScheme[scheme.name], 0.8, 1.05, jnp.asarray(state),
                             jnp.asarray(0.003 * rs.standard_normal((64, 1)))))
    np.testing.assert_allclose(
        pm.invert_noise(pp, scheme, 0.8, 1.05, torch.from_numpy(state), torch.from_numpy(nxt)).numpy(),
        np.asarray(jm.invert_noise(jp, mj.SimulationScheme[scheme.name], 0.8, 1.05,
                                   jnp.asarray(state), jnp.asarray(nxt))), rtol=1e-9, atol=1e-14)
    assert pm.supports_kernel_paths(scheme) == jm.supports_pallas_paths(mj.SimulationScheme[scheme.name])


@pytest.mark.parametrize("kind,t1,t2", [
    (AtomicRequestType.SPOT, None, None),
    (AtomicRequestType.NUMERAIRE, 1.5, None),
    (AtomicRequestType.DISCOUNT_FACTOR, 1.5, None),
    (AtomicRequestType.FORWARD_RATE, 1.0, 2.5),
    (AtomicRequestType.LIBOR_RATE, 3.0, 5.5),
])
def test_hw_resolve_rows_match_jax(kind, t1, t2):
    rs = np.random.default_rng(8)
    states = np.stack([0.03 + 0.01 * rs.standard_normal((3, 64)), 0.05 * rs.random((3, 64))], -1)
    t1s = np.array([0.0 if t1 is None else t1 + 0.5 * i for i in range(3)])
    t2s = np.array([0.0 if t2 is None else t2 + 0.5 * i for i in range(3)])
    jm, pm = hull_white(mj), hull_white(mt)
    ref = np.asarray(jm.resolve_request_rows(jm.initial_params(), JaxReq[kind.name], "irs",
                                             jnp.asarray(t1s), jnp.asarray(t2s), jnp.asarray(states)))
    out = pm.resolve_request_rows(pm.initial_params(), kind, "irs", torch.from_numpy(t1s),
                                  torch.from_numpy(t2s), torch.from_numpy(states))
    np.testing.assert_allclose(np.broadcast_to(out.numpy(), ref.shape), ref, rtol=1e-12)


def _compare(pr, jr, differentiate, metric="pv"):
    for ns in jr.get_netting_set_names():
        np.testing.assert_allclose(pr.get_results(ns, metric), jr.get_results(ns, metric),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(pr.get_mc_error(ns, metric), jr.get_mc_error(ns, metric),
                                   rtol=1e-10, atol=1e-14)
        if differentiate:
            for param in jr.get_model_param_names():
                np.testing.assert_allclose(pr.get_derivatives(ns, metric, param=param),
                                           jr.get_derivatives(ns, metric, param=param),
                                           rtol=1e-8, atol=1e-12, err_msg=f"{ns} {param}")


def _run_both(book, scheme, num_steps, differentiate, sim_dim, n=1024):
    jc = mj.SimulationController(*book(mj), n, 0, num_steps, mj.SimulationScheme[scheme.name],
                                 differentiate=differentiate, **JAX_FLAGS)
    jr = jc.run_simulation()
    noise = {jax_rng.PHASE_MAINSIM: jax_engine_normals(0, jax_rng.PHASE_MAINSIM,
                                                       len(jc.simulation_timeline) * num_steps,
                                                       n, sim_dim)}
    pc = mt.SimulationController(*book(mt), n, 0, num_steps, scheme, differentiate=differentiate,
                                 device="cpu", noise_source=noise)
    assert pc.simulation_timeline == jc.simulation_timeline and not pc._kernel_active
    return pc.run_simulation(), jr


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_hw_bond_book_matches_jax_controller(differentiate):
    def book(pkg):
        bonds = [pkg.Bond(startdate=0.0, maturity=3.0, notional=1.0, tenor=3.0, pays_notional=True,
                          fixed_rate=0.0, asset_id="irs"),
                 pkg.Bond(startdate=0.0, maturity=2.0, notional=100.0, tenor=0.5,
                          pays_notional=True, fixed_rate=0.03, asset_id="irs")]
        return ([pkg.NettingSet(name=f"bond_{i}", products=[b]) for i, b in enumerate(bonds)],
                hull_white(pkg), pkg.RiskMetrics(metrics=[pkg.PVMetric()]))

    _compare(*_run_both(book, SimulationScheme.ANALYTICAL, 4, differentiate, 1), differentiate)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_s2f_engine_and_closed_forms_match_jax(scheme):
    jm, pm = schwartz(mj), schwartz(mt)
    engines_agree(jm, pm, scheme, 2)
    for kappa in (1.2, 0.0):  # the kappa -> 0 limit of the covariance
        jk, pk = schwartz(mj, kappa), schwartz(mt, kappa)
        np.testing.assert_allclose(pk.covariance_matrix(pk.initial_params(), 0.3).numpy(),
                                   np.asarray(jk.covariance_matrix(jk.initial_params(), 0.3)),
                                   rtol=1e-15)
    jp, pp = jm.initial_params(), pm.initial_params()
    np.testing.assert_array_equal(pm.correlation_matrix(pp, scheme).numpy(),
                                  np.asarray(jm.correlation_matrix(jp, mj.SimulationScheme.EULER)))
    rs = np.random.default_rng(3)
    state = np.stack([np.log(52.0) + 0.1 * rs.standard_normal(64), 0.1 * rs.standard_normal(64),
                      0.1 * rs.standard_normal(64)], axis=-1)
    js = mj.SimulationScheme[scheme.name]
    nxt = np.asarray(jm.step(jp, js, 0.8, 1.3, jnp.asarray(state),
                             jnp.asarray(0.1 * rs.standard_normal((64, 2)))))
    np.testing.assert_allclose(
        pm.invert_noise(pp, scheme, 0.8, 1.3, torch.from_numpy(state), torch.from_numpy(nxt)).numpy(),
        np.asarray(jm.invert_noise(jp, js, 0.8, 1.3, jnp.asarray(state), jnp.asarray(nxt))),
        rtol=1e-9, atol=1e-14)
    for kind in ("SPOT", "NUMERAIRE", "DISCOUNT_FACTOR", "FORWARD_RATE"):
        ref = np.asarray(jm.resolve_obs(jp, JaxReq[kind], "gas", 1.0, 1.5, jnp.asarray(nxt)))
        out = pm.resolve_obs(pp, AtomicRequestType[kind], "gas", 1.0, 1.5, torch.from_numpy(nxt))
        np.testing.assert_allclose(np.broadcast_to(out.numpy(), ref.shape), ref, rtol=1e-14)


def test_s2f_call_matches_jax_controller():
    def book(pkg):
        options = [pkg.EuropeanOption(pkg.Equity("gas"), 2.0, 52.0, pkg.OptionType.CALL,
                                      asset_id="gas"),
                   pkg.EuropeanOption(pkg.Equity("gas"), 0.8, 50.0, pkg.OptionType.PUT,
                                      asset_id="gas")]
        return ([pkg.NettingSet(name="book", products=options)], schwartz(pkg),
                pkg.RiskMetrics(metrics=[pkg.PVMetric()]))

    _compare(*_run_both(book, SimulationScheme.ANALYTICAL, 3, True, 2), True)


def cirpp(pkg, deterministic=True):
    return pkg.CIRPPModel(0.0, "cp", HAZARDS, kappa=0.5, theta=0.03, volatility=0.05, y0=0.02,
                          deterministic=deterministic)


def test_cirpp_deterministic_matches_jax():
    """Deterministic CIR++ (cirpp.py:134-149): y tracks lambda_mkt, log_B
    adds lambda_mkt(t1) dt, no noise is read or recovered."""
    jm, pm = cirpp(mj), cirpp(mt)
    jp, pp = jm.initial_params(), pm.initial_params()
    np.testing.assert_array_equal(pm.init_state(pp, 8).numpy(), np.asarray(jm.init_state(jp, 8)))
    rs = np.random.default_rng(6)
    state = np.stack([0.02 + 0.001 * rs.random(64), 0.05 * rs.random(64)], axis=-1)
    for t1, t2 in ((0.25, 0.75), (0.75, 1.25), (1.9, 2.4), (4.0, 6.0)):
        ref = np.asarray(jm._step_deterministic(t1, t2, jnp.asarray(state)))
        out = pm.step(pp, SimulationScheme.EULER, t1, t2, torch.from_numpy(state),
                      torch.zeros((64, 1), dtype=torch.float64))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-15)
        assert torch.equal(pm.invert_noise(pp, SimulationScheme.EULER, t1, t2,
                                           torch.from_numpy(state), out),
                           torch.zeros((64, 1), dtype=torch.float64))
    y = torch.from_numpy(state[:, 0])
    np.testing.assert_allclose(pm.survival_probability(pp, 1.0, 3.5, y).numpy(),
                               np.asarray(jm.survival_probability(jp, 1.0, 3.5, jnp.asarray(y.numpy()))),
                               rtol=1e-14)
    engines_agree(jm, pm, SimulationScheme.EULER, 1)
    assert pm.kernel_block(SimulationScheme.EULER).kind == "cirpp_det"
    assert cirpp(mt, False).kernel_block(SimulationScheme.EULER).kind == "cirpp"
    assert pm.supports_kernel_paths(SimulationScheme.EULER)
    assert not pm.supports_kernel_paths(SimulationScheme.ANALYTICAL)
