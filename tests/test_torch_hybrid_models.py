"""The port's hybrid models (Black-Scholes, Vasicek, CIR++, ModelConfig), the
widened Philox stream and the hybrid path kernel K2's plain version, held
against the JAX package on the same numbers (f64, numpy-made inputs)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu.helpers.cs_helper import probability_of_default as jax_pd
from montecarlo_risk_engine_tpu.requests import AtomicRequestType as JaxReq
from montecarlo_risk_engine_tpu_torch import SimulationScheme, params_from_numpy, rng
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.helpers.cs_helper import probability_of_default
from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.models.cirpp import CIRPPModel
from montecarlo_risk_engine_tpu_torch.models.hybrid import ModelConfig
from montecarlo_risk_engine_tpu_torch.models.vasicek import VasicekModel
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
    KernelBlock,
    correlate,
    hybrid_paths,
    hybrid_paths_reference,
    hybrid_substep,
    kernel_slots,
    substep_table,
)
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType

torch.set_num_threads(1)

HAZARDS = {1.0: 0.02, 2.0: 0.022, 3.0: 0.025, 5.0: 0.028, 10.0: 0.02}
INTER = [np.array([[0.25]]), np.array([[0.4]]), np.array([[0.15]])]
TIMELINE = (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5)


def north_star_model(pkg, **cp_kw):
    """The north-star ModelConfig (benchmarks/north_star.py:50-60)."""
    kw = dict(kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)
    kw.update(cp_kw)
    return pkg.ModelConfig(
        [pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                          volatility=0.012, asset_id="irs"),
         pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq"),
         pkg.CIRPPModel(0.0, asset_id="counterparty", hazard_rates=HAZARDS, **kw)],
        inter_asset_correlation_matrix=INTER,
    )


def mt_heston():
    from montecarlo_risk_engine_tpu_torch import HestonModel

    return HestonModel(0.0, spot=100, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06,
                       v0=0.04, asset_id="hs")


def port_pkg():
    return types.SimpleNamespace(ModelConfig=ModelConfig, VasicekModel=VasicekModel,
                                 BlackScholesModel=BlackScholesModel, CIRPPModel=CIRPPModel)


def jax_engine_normals(root_seed, phase, num_counters, num_paths, sim_dim):
    """The JAX engine's threefry normals at each counter (engine.py:261-270)."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(root_seed), phase)
    draw = lambda c: jax_rng.normals(jax_rng.step_key(phase_k, c, jax_rng.PURPOSE_NORMAL),
                                     (num_paths, sim_dim), jnp.float64)
    z = torch.from_numpy(np.array(jax.jit(jax.vmap(draw))(jnp.arange(num_counters))))
    return lambda counter: (z[counter], None)


def test_param_names_and_values_match_jax():
    jm, pm = north_star_model(mj), north_star_model(port_pkg())
    assert pm.get_model_param_names() == jm.get_model_param_names()
    assert len(pm.get_model_param_names()) == 11
    ported = params_from_numpy([np.asarray(p) for p in jm.initial_params()])
    assert all(torch.equal(a, b) for a, b in zip(ported, pm.initial_params()))
    np.testing.assert_allclose(pm.correlation_matrix(pm.initial_params(), SimulationScheme.EULER),
                               np.asarray(jm.correlation_matrix(jm.initial_params(), mj.SimulationScheme.EULER)),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(pm.static_joint_correlation(), jm._static_joint_correlation())


def test_kernel_blocks_match_jax():
    jm, pm = north_star_model(mj), north_star_model(port_pkg())
    for jb, pb in zip(jm._kernel_blocks(), pm.kernel_blocks()):
        assert (pb.kind, pb.scheme, pb.param_base, pb.n_state, pb.n_sim) == (
            jb.kind, jb.scheme, jb.param_base, jb.n_state, jb.n_sim)
        assert pb.hazard_tenors == jb.hazard_tenors and pb.hazard_rates == jb.hazard_rates
        for t in (0.0, 0.5, 1.0, 1.0 + 1e-9, 2.0, 4.999, 5.0, 7.0, 12.0):
            if pb.kind == "cirpp":
                assert pb.lambda_market(t) == jb.lambda_market(t)
    assert pm.supports_kernel_paths(SimulationScheme.EULER)
    assert not pm.supports_kernel_paths(SimulationScheme.QE)
    det = ModelConfig([CIRPPModel(0.0, "cp", HAZARDS, 0.1, 0.01, 0.02, 1e-4, deterministic=True)])
    assert [b.kind for b in det.kernel_blocks()] == ["cirpp_det"]
    heston = ModelConfig([BlackScholesModel(0.0, 100.0, 0.03, 0.2, asset_id="eq"),
                          mt_heston()])
    assert heston.kernel_blocks() is None
    assert not heston.supports_kernel_paths(SimulationScheme.EULER)


def test_kernel_hazard_lookup_quantises_to_float32():
    """A time that straddles a tenor only in float64 takes the segment of
    its float32 value in the kernel table (pallas_hybrid.py:75-87), while the
    engine's lookup compares in float64 (cirpp.py:77-82)."""
    model = CIRPPModel(0.0, "cp", HAZARDS, 0.1, 0.01, 0.02, 1e-4)
    (block,) = ModelConfig([model]).kernel_blocks()
    t = 1.0 + 1e-9  # rounds to 1.0 in float32
    assert block.lambda_market(t) == HAZARDS[1.0]
    assert model.lambda_market(t) == HAZARDS[2.0]
    for t in (0.0, 0.99, 1.0, 1.5, 3.0, 9.0, 11.0):
        assert block.lambda_market(t) == model.lambda_market(t)


def test_probability_of_default_matches_jax():
    hz, tn = np.array(list(HAZARDS.values())), np.array(list(HAZARDS.keys()))
    dates = np.array([0.0, 0.3, 1.0, 2.5, 7.0, 10.0, 14.0])
    port = probability_of_default(torch.from_numpy(hz), torch.from_numpy(tn), torch.from_numpy(dates))
    ref = [float(jax_pd(jnp.asarray(hz), jnp.asarray(tn), d)) for d in dates]
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-14)


@pytest.mark.parametrize("kind,t1,t2", [
    (AtomicRequestType.SPOT, None, None),
    (AtomicRequestType.NUMERAIRE, 1.5, None),
    (AtomicRequestType.DISCOUNT_FACTOR, 1.5, None),
    (AtomicRequestType.FORWARD_RATE, 1.0, 2.5),
    (AtomicRequestType.LIBOR_RATE, 1.0, 1.5),
    (AtomicRequestType.SURVIVAL_PROBABILITY, None, None),
    (AtomicRequestType.CONDITIONAL_SURVIVAL_PROBABILITY, 1.25, 1.5),
])
def test_resolve_rows_match_jax(kind, t1, t2):
    """Request rows resolved on the same joint states (vectorised over rows)."""
    rs = np.random.default_rng(5)
    states = np.stack([0.03 + 0.01 * rs.standard_normal((3, 64)), 0.05 * rs.random((3, 64)),
                       100 + 5 * rs.standard_normal((3, 64)), 0.01 * rs.random((3, 64)),
                       0.02 * rs.random((3, 64))], axis=-1)
    t1s = np.array([0.0 if t1 is None else t1 + 0.25 * i for i in range(3)])
    t2s = np.array([0.0 if t2 is None else t2 + 0.25 * i for i in range(3)])
    jm, pm = north_star_model(mj), north_star_model(port_pkg())
    jkind = JaxReq[kind.name]
    assets = {"SPOT": ["irs", "eq"], "NUMERAIRE": ["numeraire"]}.get(
        kind.name, ["counterparty"] if "SURVIVAL" in kind.name else ["irs"])
    for asset in assets:
        ref = np.asarray(jm.resolve_request_rows(jm.initial_params(), jkind, asset, jnp.asarray(t1s),
                                                 jnp.asarray(t2s), jnp.asarray(states)))
        out = pm.resolve_request_rows(pm.initial_params(), kind, asset, torch.from_numpy(t1s),
                                      torch.from_numpy(t2s), torch.from_numpy(states))
        np.testing.assert_allclose(np.broadcast_to(out.numpy(), ref.shape), ref, rtol=1e-12)


def test_engine_matches_jax_engine_on_injected_noise():
    n, phase = 256, jax_rng.PHASE_MAINSIM
    jm, pm = north_star_model(mj), north_star_model(port_pkg())
    ref = np.asarray(jax_simulate_paths(jm, jm.initial_params(), mj.SimulationScheme.EULER,
                                        TIMELINE, n, 2, phase, root_seed=3))
    states = simulate_paths(pm, pm.initial_params(), SimulationScheme.EULER, TIMELINE, n, 2, phase,
                            noise_source=jax_engine_normals(3, phase, len(TIMELINE) * 2, n, 3),
                            device="cpu")
    assert states.shape == ref.shape == (len(TIMELINE), n, 5)
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-15)


def test_kernel_substep_matches_jax_step():
    """K2's plain per-substep block update (f64) against the JAX
    ModelConfig.step(EULER) on the same correlated normals."""
    rs = np.random.default_rng(0)
    n, dt, t1 = 4096, 0.25, 1.5
    jm, pm = north_star_model(mj), north_star_model(port_pkg())
    state = np.stack([0.03 + 0.01 * rs.standard_normal(n), 0.1 * rs.random(n),
                      100.0 * np.exp(0.2 * rs.standard_normal(n)), 0.02 * rs.random(n) + 1e-4,
                      0.05 * rs.random(n)], axis=-1)
    w = rs.standard_normal((n, 3))
    ref = np.asarray(jm.step(jm.initial_params(), mj.SimulationScheme.EULER, t1, t1 + dt,
                             jnp.asarray(state), jnp.asarray(w)))
    slots, _, _ = kernel_slots(pm.kernel_blocks())
    params = pm.initial_params()
    cp = pm.models[2]
    psi = cp.psi(params[7:], t1)  # float64 here; the kernel's table rounds it to float32
    row = torch.stack([torch.tensor(dt, dtype=torch.float64),
                       torch.tensor(np.sqrt(dt), dtype=torch.float64), psi])
    s = torch.from_numpy(state)
    a, b = hybrid_substep(slots, list(params), [s[:, 0], s[:, 2], s[:, 3]],
                          [s[:, 1], None, s[:, 4]], list(torch.from_numpy(w).unbind(1)), row)
    out = torch.stack([a[0], b[0], a[1], a[2], b[2]], dim=-1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-18)


def test_philox_normals_extend_the_k1_stream():
    for dtype in (torch.float32, torch.float64):
        z_s, z_v, _ = rng.substep_draws(4, 43, 7, 1000, dtype, "cpu")
        for sim_dim in (1, 2):
            z = rng.substep_normals(4, 43, 7, 1000, sim_dim, dtype, "cpu")
            assert torch.equal(z, torch.stack([z_s, z_v], -1)[:, :sim_dim])
    z5 = rng.substep_normals(4, 43, 7, 1000, 5, torch.float64, "cpu")
    z3 = rng.substep_normals(4, 43, 7, 1000, 3, torch.float64, "cpu")
    assert torch.equal(z5[:, :3], z3)
    # normals 2 and 3 come from words 2 and 3 of call 0, normal 4 from call 1
    paths = torch.arange(1000, dtype=torch.int64)
    zero, seven = torch.zeros((), dtype=torch.int64), torch.tensor(7)
    w = rng.philox4x32_10((paths, seven, zero, zero), (4, 43))
    u1, u2 = (rng.uniform_from_word(x, torch.float64) for x in (w[2], w[3]))
    r = torch.sqrt(-2.0 * torch.log(u1))
    assert torch.equal(z5[:, 2], r * torch.cos(u2 * 2 * np.pi))
    assert torch.equal(z5[:, 3], r * torch.sin(u2 * 2 * np.pi))
    w1 = rng.philox4x32_10((paths, seven, torch.ones((), dtype=torch.int64), zero), (4, 43))
    u1, u2 = (rng.uniform_from_word(x, torch.float64) for x in (w1[0], w1[1]))
    assert torch.equal(z5[:, 4], torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * 2 * np.pi))
    zs = torch.cat([rng.substep_normals(0, 42, c, 1 << 14, 3, torch.float64, "cpu") for c in range(4)])
    assert torch.all(zs.mean(0).abs() < 5 / 2 ** 8) and torch.all((zs.var(0) - 1).abs() < 0.05)


def test_plain_kernel_trajectory_follows_its_substep():
    """The plain K2 trajectory is its per-substep update on the Philox
    stream: f32 paths with the right shape, first point exactly one
    substep from the initial state."""
    pm = north_star_model(port_pkg())
    params = pm.initial_params(dtype=torch.float32)
    blocks, chol = pm.kernel_blocks(), np.linalg.cholesky(pm.static_joint_correlation())
    out = hybrid_paths_reference(blocks, chol, params, TIMELINE, 500, 2, seed=1, phase=42)
    assert out.shape == (len(TIMELINE), 500, 5) and out.dtype == torch.float32
    assert torch.equal(out[0], out[0, :1].expand(500, 5))  # t = 0: no step
    table = substep_table(blocks, params, TIMELINE, 2)
    slots, _, _ = kernel_slots(blocks)
    prm = list(params)
    a = [p.expand(500) for p in (prm[0], prm[4], prm[10])]
    b = [torch.zeros(500), None, torch.zeros(500)]
    for k in range(2):
        z = rng.substep_normals(1, 42, 2 + k, 500, 3, torch.float32, "cpu")
        a, b = hybrid_substep(slots, prm, a, b, correlate(chol.astype(np.float32), z), table[2 + k])
    assert torch.equal(out[1], torch.stack([a[0], b[0], a[1], a[2], b[2]], -1))
    # Vasicek's left-Riemann accumulator and the CIR++ floor hold.
    assert float(out[..., 3].min()) >= np.float32(1e-12)
    assert torch.all(out[1:, :, 4] > 0)


def test_plain_kernel_matches_engine_on_the_same_stream():
    """Kernel (f32, its own Euler algebra) and engine (f64) draw the same
    Philox normals: paths agree to float32 rounding."""
    n = 400
    pm = north_star_model(port_pkg())
    kernel = pm.kernel_paths(pm.initial_params(dtype=torch.float32), SimulationScheme.EULER,
                             TIMELINE, n, 2, seed=2, phase=43)
    engine = simulate_paths(pm, pm.initial_params(), SimulationScheme.EULER, TIMELINE, n, 2, 43,
                            root_seed=2, device="cpu")
    np.testing.assert_allclose(kernel.double().numpy(), engine.numpy(), rtol=2e-5, atol=1e-6)


def test_dispatcher_runs_plain_on_cpu_and_refuses_other_devices(monkeypatch, tmp_path):
    pm = north_star_model(port_pkg())
    params = pm.initial_params(dtype=torch.float32)
    blocks, chol = pm.kernel_blocks(), np.linalg.cholesky(pm.static_joint_correlation())
    before = hybrid_paths.launches
    a = hybrid_paths(blocks, chol, params, TIMELINE, 300, 1, seed=5, phase=43)
    assert hybrid_paths.launches == before
    assert torch.equal(a, hybrid_paths_reference(blocks, chol, params, TIMELINE, 300, 1, seed=5,
                                                 phase=43))
    meta = tuple(torch.zeros((), device="meta") for _ in params)
    with pytest.raises(ValueError):
        hybrid_paths(blocks, chol, meta, TIMELINE, 300, 1)
    # A CUDA device without a build raises; nothing falls back to the CPU.
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_find_nvcc", no_nvcc)
    on_card = tuple(types.SimpleNamespace(device=torch.device("cuda")) for _ in params)
    with pytest.raises(RuntimeError, match="nvcc"):
        hybrid_paths(blocks, chol, on_card, TIMELINE, 300, 1)
    assert hybrid_paths.launches == before
    with pytest.raises(ValueError):  # an hw block needs its market curve
        hybrid_paths([KernelBlock("hw", "euler", 0, 2, 1)], np.eye(1), params, TIMELINE, 300, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name,scheme", [
    ("north_star", SimulationScheme.EULER), ("bs", SimulationScheme.ANALYTICAL),
    ("bs_multi", SimulationScheme.ANALYTICAL), ("vasicek", SimulationScheme.ANALYTICAL),
    ("cirpp_det", SimulationScheme.EULER), ("hw", SimulationScheme.ANALYTICAL),
    ("hw", SimulationScheme.EULER), ("s2f", SimulationScheme.ANALYTICAL),
    ("s2f", SimulationScheme.EULER), ("mixed", SimulationScheme.EULER)])
def test_cuda_kernel_matches_plain_version(name, scheme):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from test_torch_hybrid_blocks import make, mixed

    pm = {"north_star": lambda: north_star_model(port_pkg()),
          "mixed": lambda: mixed(mt_pkg())}.get(name, lambda: make(name, mt_pkg()))()
    params = pm.initial_params(device="cuda", dtype=torch.float32)
    if isinstance(pm, ModelConfig):
        blocks, corr = pm.kernel_blocks(), pm.static_joint_correlation()
    else:
        blocks, corr = [pm.kernel_block(scheme)], pm.kernel_correlation()
    chol = np.linalg.cholesky(corr)
    before = hybrid_paths.launches
    out = hybrid_paths(blocks, chol, params, TIMELINE, 50_000, 2, seed=9, phase=42)
    torch.cuda.synchronize()
    assert hybrid_paths.launches == before + 1
    ref = hybrid_paths_reference(blocks, chol, params, TIMELINE, 50_000, 2, seed=9, phase=42)
    close = torch.isclose(out, ref, rtol=1e-5, atol=1e-6).all(dim=-1).all(dim=0)
    assert float(close.double().mean()) >= 0.9999


def mt_pkg():
    import montecarlo_risk_engine_tpu_torch

    return montecarlo_risk_engine_tpu_torch
