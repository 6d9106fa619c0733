"""K2's blocks beyond the north star (bs and vasicek exact, bs_multi,
cirpp_det, hw, s2f) and the ANALYTICAL recovered-noise AD, held against
the JAX package and against the port's own engine on the same numbers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import SimulationScheme
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.ops import paths_ad
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
    GBM_EXACT,
    KernelBlock,
    correlate,
    hybrid_paths,
    hybrid_substep,
    kernel_slots,
    substep_table,
)

torch.set_num_threads(1)

A, E, M = SimulationScheme.ANALYTICAL, SimulationScheme.EULER, SimulationScheme.MILSTEIN
HAZARDS = {1.0: 0.02, 2.0: 0.022, 5.0: 0.028}
HW_TIMES, HW_DFS = [0.0, 1.0, 3.0, 5.0], [1.0, 0.97, 0.90, 0.84]
TIMELINE = (0.0, 0.4, 0.8, 1.3, 2.0)


def make(name, pkg):
    """One model of each K2 kind, in either package."""
    corr = np.full((3, 3), 0.35)
    np.fill_diagonal(corr, 1.0)
    if name == "bs":
        return pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq")
    if name == "bs_multi":
        return pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=["a0", "a1", "a2"],
                                     spots=[95.0, 102.5, 110.0], volatilities=[0.18, 0.21, 0.24],
                                     correlation_matrix=corr)
    if name == "vasicek":
        return pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                                volatility=0.012, asset_id="irs")
    if name in ("cirpp", "cirpp_det"):
        return pkg.CIRPPModel(0.0, "cp", HAZARDS, kappa=0.5, theta=0.03, volatility=0.05,
                              y0=0.03, deterministic=name == "cirpp_det")
    if name == "hw":
        return pkg.HullWhiteModel(0.0, HW_TIMES, HW_DFS, volatility=0.01, mean_reversion=0.4,
                                  asset_id="hw")
    return pkg.SchwartzTwoFactorModel(0.0, [0.0, 1.0, 3.0], [50.0, 52.0, 55.0], rate=0.03,
                                      short_term_mean_reversion=1.2, short_term_vol=0.3,
                                      long_term_drift=0.01, long_term_vol=0.15, rho=0.35,
                                      asset_id="gas")


def mixed(pkg, with_bs=True):
    """ModelConfig of BS-multi, Vasicek, Hull-White, deterministic CIR++
    (and Black-Scholes and CIR++): every ModelConfig block kind."""
    models = [make("bs_multi", pkg), make("vasicek", pkg), make("hw", pkg), make("cirpp_det", pkg)]
    if with_bs:
        models += [pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq"),
                   pkg.CIRPPModel(0.0, "cp2", HAZARDS, kappa=0.1, theta=0.01, volatility=0.02,
                                  y0=0.0001)]
    k = len(models)
    inter = []
    for i in range(k):
        for j in range(i + 1, k):
            inter.append(np.full((models[i].simulation_dim, models[j].simulation_dim),
                                 0.02 * ((i + 2 * j) % 5)))
    return pkg.ModelConfig(models, inter_asset_correlation_matrix=inter)


def _state(name, rs, n):
    """A JAX-layout state of the model."""
    if name == "bs":
        return 100.0 * np.exp(0.2 * rs.standard_normal((n, 1)))
    if name == "bs_multi":
        return np.array([95.0, 102.5, 110.0]) * np.exp(0.2 * rs.standard_normal((n, 3)))
    if name == "s2f":
        return np.stack([np.log(52.0) + 0.1 * rs.standard_normal(n), 0.1 * rs.standard_normal(n),
                         0.1 * rs.standard_normal(n)], axis=-1)
    return np.stack([0.03 + 0.005 * rs.standard_normal(n), 0.05 * rs.random(n)], axis=-1)


@pytest.mark.parametrize("name,scheme", [
    ("bs", A), ("bs_multi", A), ("bs_multi", E), ("vasicek", A), ("cirpp_det", E), ("hw", A),
    ("hw", M), ("s2f", A), ("s2f", E)])
def test_new_substeps_match_jax_step(name, scheme):
    """Plain K2's float32 substep of the block against the JAX model's step
    (float64) on the same standard normals: the kernel combines them through
    the block's static factor, JAX through its noise transform."""
    jm, pm = make(name, mj), make(name, mt)
    js = mj.SimulationScheme[scheme.name]
    block = pm.kernel_block(scheme)
    slots, _, _ = kernel_slots([block])
    params32 = pm.initial_params(dtype=torch.float32)
    t1, dt = 1.25, 0.25
    row = substep_table([block], params32, (t1, t1 + dt), 1)[1]
    rs = np.random.default_rng(11)
    n = 4096
    state, z = _state(name, rs, n), rs.standard_normal((n, pm.simulation_dim))
    noise = z @ np.asarray(jm.noise_transform(jm.initial_params(), js, dt)).T
    ref = np.asarray(jm.step(jm.initial_params(), js, t1, t1 + dt, jnp.asarray(state),
                             jnp.asarray(noise)))
    s32 = torch.from_numpy(state).float()
    a = [torch.log(s32[:, sl.oa]) if sl.role == GBM_EXACT else s32[:, sl.oa] for sl in slots]
    b = [s32[:, sl.ob] if sl.ob >= 0 else None for sl in slots]
    w = correlate(np.linalg.cholesky(pm.kernel_correlation()).astype(np.float32),
                  torch.from_numpy(z).float())
    a, b = hybrid_substep(slots, list(params32), a, b, w, row)
    out = np.zeros_like(ref)
    for s, sl in enumerate(slots):
        out[:, sl.oa] = (torch.exp(a[s]) if sl.role == GBM_EXACT else a[s]).numpy()
        if sl.ob >= 0:
            out[:, sl.ob] = b[s].numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,scheme", [
    ("bs", A), ("bs_multi", A), ("vasicek", A), ("cirpp", E), ("cirpp_det", E), ("hw", A),
    ("hw", M), ("s2f", A), ("s2f", E), ("mixed", E)])
def test_plain_kernel_matches_engine_on_one_stream(name, scheme):
    """Plain K2 (float32, its own algebra) and the port's engine (float64)
    draw the same Philox normals: paths agree to float32 rounding."""
    pm = mixed(mt) if name == "mixed" else make(name, mt)
    assert pm.supports_kernel_paths(scheme)
    n = 512
    kernel = pm.kernel_paths(pm.initial_params(dtype=torch.float32), scheme, TIMELINE, n, 3,
                             seed=2, phase=43)
    engine = simulate_paths(pm, pm.initial_params(), scheme, TIMELINE, n, 3, 43, root_seed=2)
    assert kernel.shape == engine.shape == (len(TIMELINE), n, pm.state_dim)
    np.testing.assert_allclose(kernel.double().numpy(), engine.numpy(), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name,scheme", [
    ("bs", A), ("bs_multi", A), ("vasicek", A), ("hw", A), ("s2f", A), ("s2f", E),
    ("mixed", E)])
def test_recovered_noise_jacobian_matches_direct_ad(name, scheme):
    """The recovered-noise reconstruction (ops/paths_ad.py, under ANALYTICAL
    with the per-substep covariance factor) against forward-mode AD straight
    through the port's engine on the same stream."""
    pm = mixed(mt, with_bs=False) if name == "mixed" else make(name, mt)
    params = pm.initial_params()
    n, steps = 256, 2
    timeline = TIMELINE[1:]
    dense, orig_idx = paths_ad.dense_timeline(0.0, timeline, steps)
    forward = lambda p: simulate_paths(pm, p, scheme, dense, n, 1, 43, root_seed=7)
    _, noise_fn, recon_fn = paths_ad.recovered_noise_fns(pm, scheme, timeline, n, steps, forward)
    z = noise_fn(params)
    np.testing.assert_allclose(recon_fn(params, z).numpy(), forward(params)[orig_idx].numpy(),
                               rtol=1e-11, atol=1e-13)
    w = torch.from_numpy(1.0 + 0.1 * np.arange(len(timeline) * n * pm.state_dim)
                         .reshape(len(timeline), n, pm.state_dim) / (n * pm.state_dim))
    argnums = tuple(range(len(params)))
    rec = jacfwd(lambda *p: torch.mean(recon_fn(p, z) * w), argnums=argnums)(*params)
    direct = jacfwd(lambda *p: torch.mean(
        simulate_paths(pm, p, scheme, timeline, n, steps, 43, root_seed=7) * w),
        argnums=argnums)(*params)
    for a, b, pname in zip(rec, direct, pm.get_model_param_names()):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-12, err_msg=pname)


def test_model_config_blocks_and_correlation_match_jax():
    jm, pm = mixed(mj), mixed(mt)
    fields = ("kind", "scheme", "param_base", "n_state", "n_sim", "hazard_tenors",
              "hazard_rates", "curve_times", "curve_vals")
    jb, pb = jm._kernel_blocks(), pm.kernel_blocks()
    assert [b.kind for b in pb] == ["bs_multi", "vasicek", "hw", "cirpp_det", "bs", "cirpp"]
    for j, p in zip(jb, pb):
        assert tuple(getattr(p, f) for f in fields) == tuple(getattr(j, f) for f in fields)
    np.testing.assert_array_equal(pm.static_joint_correlation(), jm._static_joint_correlation())
    np.testing.assert_array_equal(
        pm.correlation_matrix(pm.initial_params(), E).numpy(),
        np.asarray(jm.correlation_matrix(jm.initial_params(), mj.SimulationScheme.EULER)))
    assert pm.supports_kernel_paths(E) and pm.simulation_dim == 8
    assert not pm.supports_kernel_paths(A)
    # ANALYTICAL runs on the engine with the joint covariance of the factor
    # loadings (JAX hybrid.py:152-206)
    np.testing.assert_allclose(pm.covariance_matrix(pm.initial_params(), 0.25).numpy(),
                               np.asarray(jm.covariance_matrix(jm.initial_params(), 0.25)),
                               rtol=1e-12, atol=1e-15)
    s2f_config = mt.ModelConfig([make("s2f", mt), make("bs", mt)])
    assert s2f_config.kernel_blocks() is None and mj.ModelConfig(
        [make("s2f", mj), make("bs", mj)])._kernel_blocks() is None


def test_kernel_refuses_only_what_it_cannot_take():
    params = tuple(torch.tensor(0.1) for _ in range(40))
    wide = KernelBlock("bs_multi", "exact", 0, 9, 9)
    with pytest.raises(ValueError, match="at most 8"):
        hybrid_paths([wide], np.eye(9), params, (1.0,), 64, 1)
    for bad in (KernelBlock("cirpp", "milstein", 0, 2, 1, (1.0,), (0.02,)),
                KernelBlock("heston", "euler", 0, 2, 2),
                KernelBlock("s2f", "exact", 0, 3, 1, curve_times=(0.0, 1.0), curve_vals=(1.0, 2.0)),
                KernelBlock("hw", "euler", 0, 2, 1),
                KernelBlock("cirpp_det", "euler", 0, 2, 1)):
        with pytest.raises(ValueError):
            hybrid_paths([bad], np.eye(bad.n_sim), params, (1.0,), 64, 1)
    # A cirpp block has one step under both schemes (pallas_hybrid.py:335-348).
    cir = [KernelBlock("cirpp", scheme, 0, 2, 1, (1.0, 5.0), (0.02, 0.03))
           for scheme in ("exact", "euler")]
    params = params[:4]
    assert torch.equal(hybrid_paths(cir[:1], np.eye(1), params, (0.5, 1.0), 64, 2, seed=3),
                       hybrid_paths(cir[1:], np.eye(1), params, (0.5, 1.0), 64, 2, seed=3))
    # A ModelConfig wider than the kernel takes the engine, as every
    # ineligible book does.
    nine = mt.ModelConfig([make("bs_multi", mt), make("bs_multi", mt).__class__(
        0.0, rate=0.03, asset_ids=[f"b{i}" for i in range(6)], spots=[100.0] * 6,
        volatilities=[0.2] * 6, correlation_matrix=np.eye(6))])
    assert nine.simulation_dim == 9 and nine.kernel_blocks() is not None
    assert not nine.supports_kernel_paths(E)
