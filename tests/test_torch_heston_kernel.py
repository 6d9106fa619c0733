"""Heston-QE path kernel of the PyTorch port and its emitted-noise AD path.

The JAX kernel draws from the TPU hardware PRNG, which does not run off the
chip, so its CPU oracle is its step math on given draws
(``_heston_qe_substep``) and the engine's ``HestonModel.step_qe``.  Inputs
come from numpy with a fixed seed and go to both packages.  Tests that need
a card take the ``cuda_device`` fixture, which skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_risk_engine_tpu import HestonModel as JaxHeston
from montecarlo_risk_engine_tpu import SimulationScheme as JaxScheme
from montecarlo_risk_engine_tpu.ops import pallas_paths_ad as jax_ad
from montecarlo_risk_engine_tpu.ops.pallas_paths import _heston_qe_substep
from montecarlo_risk_engine_tpu_torch import HestonModel, SimulationScheme, params_from_numpy, rng
from montecarlo_risk_engine_tpu_torch.ops import paths_ad
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import (
    heston_qe_paths,
    heston_qe_paths_reference,
    heston_qe_substep,
)

torch.set_num_threads(1)

MODEL_KW = dict(spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06, v0=0.04)
PARAMS = (100.0, 0.5, 0.03, -0.7, 2.0, 0.06, 0.04)  # JAX order: spot, sigma, r, rho, kappa, theta, v0
SLICE_TIMELINE = tuple(0.1 * (i + 1) for i in range(10))
# A timeline with a point at the calibration date and a repeated date.
EDGE_TIMELINE = (0.0, 0.3, 0.3, 0.7, 1.0)
# The JAX kernel's step math, compiled once per (dt, smoothing) instead of
# dispatched op by op.
jax_substep = jax.jit(_heston_qe_substep, static_argnames=("dt", "smoothing"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _substep_inputs(n=20000, seed=0):
    rs = np.random.default_rng(seed)
    log_s = np.log(100.0) + 0.3 * rs.standard_normal(n)
    v = rs.gamma(2.0, 0.02, n)
    z = rs.standard_normal((n, 2))
    u = rs.uniform(size=n)
    return log_s, v, z, u


def _port_substep(log_s, v, z, u, dt, dtype, smoothing):
    _, sigma, rate, rho, kappa, theta, _ = params_from_numpy(PARAMS, dtype=dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    out = heston_qe_substep(t(log_s), t(v), t(z[:, 0]), t(z[:, 1]), t(u), dt,
                            sigma, rate, rho, kappa, theta, smoothing=smoothing)
    return [o.double().numpy() for o in out]


@pytest.mark.parametrize("smoothing", [False, True])
@pytest.mark.parametrize("dtype,jdtype,rtol", [
    (torch.float64, jnp.float64, 1e-10),
    (torch.float32, jnp.float32, 1e-5),
])
def test_substep_matches_jax_kernel_substep(smoothing, dtype, jdtype, rtol):
    log_s, v, z, u = _substep_inputs()
    dt = 0.025
    port = _port_substep(log_s, v, z, u, dt, dtype, smoothing)
    j = lambda a: jnp.asarray(a, jdtype)
    ref = jax_substep(j(log_s), j(v), j(z[:, 0]), j(z[:, 1]), j(u), dt,
                      *(j(p) for p in PARAMS[1:6]), smoothing=smoothing)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, np.asarray(b, np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("smoothing", [False, True])
@pytest.mark.parametrize("dtype,rtol,atol", [
    # The kernel algebra places the 1e-12 guard as m2 / (s2 + eps) where
    # step_qe has 1 / (psi + eps): inv_psi differs by ~eps / s2 (<= 1.1e-7
    # relative at dt = 0.025), which moves v by up to ~1e-9 absolute.  The
    # absolute term bounds that; everything else agrees to rtol.
    (torch.float64, 1e-10, 1e-8),
    (torch.float32, 1e-5, 1e-7),
])
def test_substep_matches_jax_step_qe(smoothing, dtype, rtol, atol):
    log_s, v, z, u = _substep_inputs(seed=1)
    dt = 0.025
    port = _port_substep(log_s, v, z, u, dt, dtype, smoothing)
    model = JaxHeston(0.0, **MODEL_KW)
    if smoothing:
        model.requires_grad()
    ref = np.asarray(model.step_qe(tuple(jnp.asarray(p) for p in PARAMS), 0.0, dt,
                                   jnp.stack([log_s, v], -1), jnp.asarray(z), jnp.asarray(u)))
    np.testing.assert_allclose(port[0], ref[:, 0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(port[1], ref[:, 1], rtol=rtol, atol=atol)


@pytest.mark.parametrize("smoothing", [False, True])
def test_plain_kernel_trajectory_matches_jax_substep_scan(smoothing):
    """Whole plain-K1 trajectory (f64) against a loop of the JAX kernel's
    substep on the same Philox draws."""
    n, num_steps = 512, 4
    params = params_from_numpy(PARAMS, dtype=torch.float64)
    states = heston_qe_paths_reference(params, SLICE_TIMELINE, n, num_steps, seed=3,
                                       phase=rng.PHASE_MAINSIM, smoothing=smoothing,
                                       dtype=torch.float64)
    log_s = jnp.full((n,), np.log(100.0))
    v = jnp.full((n,), 0.04)
    t_prev = 0.0
    for point, t in enumerate(SLICE_TIMELINE):
        dt = (t - t_prev) / num_steps
        for k in range(num_steps):
            z_s, z_v, u = (x.numpy() for x in rng.substep_draws(
                3, rng.PHASE_MAINSIM, point * num_steps + k, n, torch.float64, "cpu"))
            log_s, v = jax_substep(log_s, v, z_s, z_v, u, dt,
                                   *(jnp.asarray(p) for p in PARAMS[1:6]),
                                   smoothing=smoothing)
        np.testing.assert_allclose(states[point, :, 0].numpy(), np.asarray(log_s), rtol=1e-10)
        np.testing.assert_allclose(states[point, :, 1].numpy(), np.asarray(v), rtol=1e-10, atol=1e-14)
        t_prev = t


def test_dispatcher_runs_plain_version_on_cpu():
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    before = heston_qe_paths.launches
    a = heston_qe_paths(params, SLICE_TIMELINE, 1000, 4, seed=1, phase=43)
    b = heston_qe_paths_reference(params, SLICE_TIMELINE, 1000, 4, seed=1, phase=43)
    assert heston_qe_paths.launches == before
    assert a.shape == (10, 1000, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_emit_variant_draws_and_states():
    """Dense emit run: draws are the Philox words of each counter (zeros at
    zero-dt points) and the states follow the coarse run."""
    n, num_steps = 300, 3
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    dense, idx = paths_ad.dense_timeline(0.0, EDGE_TIMELINE, num_steps)
    states, z, u = heston_qe_paths(params, dense, n, 1, seed=2, phase=43,
                                   smoothing=True, emit_noise=True)
    assert states.shape == (len(dense), n, 2) and z.shape == (len(dense), n, 2)
    assert u.shape == (len(dense), n)
    assert torch.all(z[0] == 0) and torch.all(u[0] == 0)      # t = 0.0: no step
    assert torch.equal(states[0, :, 1], torch.full((n,), 0.04))
    z_s, z_v, u5 = rng.substep_draws(2, 43, 5, n, torch.float32, "cpu")
    assert torch.equal(z[5], torch.stack([z_s, z_v], -1)) and torch.equal(u[5], u5)
    # Without zero-length intervals, the dense run draws the coarse run's counters.
    dense_s, idx_s = paths_ad.dense_timeline(0.0, SLICE_TIMELINE, 4)
    emit_states = heston_qe_paths(params, dense_s, n, 1, seed=2, phase=43, emit_noise=True)[0]
    coarse = heston_qe_paths(params, SLICE_TIMELINE, n, 4, seed=2, phase=43)
    np.testing.assert_allclose(emit_states[idx_s].numpy(), coarse.numpy(), rtol=2e-5, atol=2e-6)


def test_martingale_corrected_model_refuses_kernel():
    model = HestonModel(0.0, martingale_correction=True, **MODEL_KW)
    assert not model.supports_kernel_paths(SimulationScheme.QE)
    assert not HestonModel(0.0, **MODEL_KW).supports_kernel_paths(SimulationScheme.EULER)
    with pytest.raises(ValueError):
        model.kernel_paths(model.initial_params(), SimulationScheme.QE, SLICE_TIMELINE, 16, 4, seed=0)


def test_plain_kernel_discounted_spot_is_martingale():
    n = 1 << 14
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    states = heston_qe_paths(params, SLICE_TIMELINE, n, 4, seed=0, phase=43)
    for point, t in enumerate(SLICE_TIMELINE):
        disc = torch.exp(states[point, :, 0].double()) * np.exp(-0.03 * t)
        se = float(disc.std()) / n ** 0.5
        assert abs(float(disc.mean()) - 100.0) < 5 * se + 0.05   # QE drift bias is O(dt)
    v_t = states[-1, :, 1].double()
    assert float(v_t.min()) >= 0.0
    ev = 0.06 + (0.04 - 0.06) * np.exp(-2.0)
    assert abs(float(v_t.mean()) - ev) < 5 * float(v_t.std()) / n ** 0.5 + 1e-3


# -- emitted-noise AD (ops/paths_ad.py) ----------------------------------------


def test_dense_timeline_and_slots_match_jax():
    for timeline, steps in ((SLICE_TIMELINE, 4), (EDGE_TIMELINE, 3)):
        d_port, i_port = paths_ad.dense_timeline(0.0, timeline, steps)
        d_jax, i_jax = jax_ad.dense_timeline(0.0, timeline, steps)
        assert d_port == d_jax and np.array_equal(i_port, i_jax)
        assert np.array_equal(paths_ad._coarse_slots(len(d_port), i_port),
                              jax_ad._coarse_slots(len(d_jax), i_jax))


def _recon_setup(num_paths=64, num_steps=3):
    rs = np.random.default_rng(11)
    dense, idx = paths_ad.dense_timeline(0.0, EDGE_TIMELINE, num_steps)
    z = rs.standard_normal((len(dense), num_paths, 2))
    u = rs.uniform(size=(len(dense), num_paths))
    return dense, idx, z, u


def test_emitted_noise_reconstruction_matches_direct_autograd():
    """Torch twin of test_pallas_ad.py::test_emitted_noise_tangent_matches_direct_ad."""
    num_paths, num_steps = 64, 3
    dense, idx, z_np, u_np = _recon_setup(num_paths, num_steps)
    z, u = torch.from_numpy(z_np), torch.from_numpy(u_np)
    model = HestonModel(0.0, **MODEL_KW)
    model.requires_grad()

    def run_scan(params):
        t_prev, state, outs = 0.0, model.init_state(params, num_paths), []
        for i, t in enumerate(dense):
            if t > t_prev:
                state = model.step(params, SimulationScheme.QE, t_prev, t, state, z[i], u[i])
            outs.append(state)
            t_prev = t
        return torch.stack(outs)

    _, noise_fn, recon_fn = paths_ad.emitted_noise_fns(
        model, SimulationScheme.QE, EDGE_TIMELINE, num_paths, num_steps,
        lambda p: (run_scan(p), z, u))

    def grads(fn):
        params = tuple(p.requires_grad_(True) for p in model.initial_params())
        out = fn(params)
        return out.detach(), torch.autograd.grad((out ** 2).mean(), params)

    s_w, g_w = grads(lambda p: recon_fn(p, noise_fn(p)))
    s_d, g_d = grads(lambda p: run_scan(p)[torch.as_tensor(idx)])
    np.testing.assert_allclose(s_w.numpy(), s_d.numpy(), rtol=1e-12, atol=1e-12)
    for a, b in zip(g_w, g_d):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-8, atol=1e-10)


def test_emitted_noise_reconstruction_matches_jax():
    """Same frozen draws through the JAX emitted-noise path and the port's."""
    num_paths, num_steps = 64, 3
    dense, idx, z_np, u_np = _recon_setup(num_paths, num_steps)
    jmodel = JaxHeston(0.0, **MODEL_KW)
    jmodel.requires_grad()
    jz, ju = jnp.asarray(z_np), jnp.asarray(u_np)

    def jax_scan(params):
        t_prev, state, outs = 0.0, jmodel.init_state(params, num_paths), []
        for i, t in enumerate(dense):
            if t > t_prev:
                state = jmodel.step(params, JaxScheme.QE, t_prev, t, state, jz[i], uniform=ju[i])
            outs.append(state)
            t_prev = t
        return jnp.stack(outs)

    wrapped = jax_ad.emitted_noise_paths(jmodel, JaxScheme.QE, EDGE_TIMELINE, num_paths,
                                         num_steps, lambda p: (jax_scan(p), jz, ju))
    jparams = jmodel.initial_params()
    j_states = np.asarray(jax.jit(wrapped)(jparams))
    j_grads = jax.jit(jax.grad(lambda p: jnp.mean(wrapped(p) ** 2)))(jparams)

    model = HestonModel(0.0, **MODEL_KW)
    model.requires_grad()
    z, u = torch.from_numpy(z_np), torch.from_numpy(u_np)
    _, noise_fn, recon_fn = paths_ad.emitted_noise_fns(
        model, SimulationScheme.QE, EDGE_TIMELINE, num_paths, num_steps,
        lambda p: (None, z, u))
    params = tuple(p.requires_grad_(True) for p in params_from_numpy([np.asarray(p) for p in jparams]))
    out = recon_fn(params, noise_fn(params))
    grads = torch.autograd.grad((out ** 2).mean(), params)
    np.testing.assert_allclose(out.detach().numpy(), j_states, rtol=1e-12, atol=1e-12)
    for a, b in zip(grads, j_grads):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("sigma", [0.5, 1.0], ids=["surface", "vol_of_vol_1"])
def test_qe_tangents_route_matches_jax(sigma):
    """The forward-mode Heston QE kernel's route (ops/qe_tangents.py, its
    plain version on the CPU) against the JAX package's emitted-noise path
    on the same frozen float32 draws (float64 for JAX, exactly): the primal
    plane and its jacobian by the 7 parameters (one sweep of the unit
    directions) against ``jax.jvp`` / ``jacfwd``, smoothing on, at the
    Heston surface's vol-of-vol and at 1.0, where psi passes 2 and the
    tangents of some paths are nan in both packages; those paths are left
    out, and each package must see the same ones."""
    from montecarlo_risk_engine_tpu_torch.ops import qe_tangents

    num_paths, num_steps = 256, 4
    kw = dict(MODEL_KW, sigma=sigma)
    dense, _ = paths_ad.dense_timeline(0.0, EDGE_TIMELINE, num_steps)
    gen = torch.Generator().manual_seed(21)
    z = torch.randn((len(dense), num_paths, 2), generator=gen)
    u = torch.rand((len(dense), num_paths), generator=gen)

    jmodel = JaxHeston(0.0, **kw)
    jmodel.requires_grad()
    jz, ju = jnp.asarray(z.double().numpy()), jnp.asarray(u.double().numpy())

    def jax_scan(params):
        t_prev, state, outs = 0.0, jmodel.init_state(params, num_paths), []
        for i, t in enumerate(dense):
            if t > t_prev:
                state = jmodel.step(params, JaxScheme.QE, t_prev, t, state, jz[i], uniform=ju[i])
            outs.append(state)
            t_prev = t
        return jnp.stack(outs)

    wrapped = jax_ad.emitted_noise_paths(jmodel, JaxScheme.QE, EDGE_TIMELINE, num_paths,
                                         num_steps, lambda p: (jax_scan(p), jz, ju))
    jparams = jmodel.initial_params()
    j_states = np.asarray(jax.jit(wrapped)(jparams))
    j_jac = np.stack([np.asarray(j) for j in jax.jit(jax.jacfwd(wrapped))(jparams)])

    model = HestonModel(0.0, **kw)
    model.requires_grad()
    recon_fn = qe_tangents.reconstruction(model, SimulationScheme.QE, EDGE_TIMELINE, num_steps,
                                          chunk=7)
    params = params_from_numpy([np.asarray(p) for p in jparams])
    qe_tangents.qe_planes.launches.clear()
    calls = []
    real = qe_tangents.qe_planes_reference

    def counted(*args):
        calls.append(0 if args[6] is None else args[6].shape[0])
        return real(*args)

    qe_tangents.qe_planes_reference = counted
    try:
        states, jac = torch.func.vmap(lambda t: torch.func.jvp(
            lambda p: recon_fn(p, (z, u)), (params,), (tuple(t.unbind(0)),)))(
            torch.eye(7, dtype=torch.float64))
    finally:
        qe_tangents.qe_planes_reference = real
    assert sorted(calls) == [0, 7]  # the route's primal and one sweep of 7 tangents
    np.testing.assert_allclose(states[0].numpy(), j_states, rtol=1e-12, atol=1e-12)
    finite = np.isfinite(j_jac).all(axis=(0, 1, 3))  # by path
    assert np.array_equal(np.isfinite(jac.numpy()).all(axis=(0, 1, 3)), finite)
    assert finite.all() if sigma == 0.5 else 0 < finite.sum() < num_paths
    for got, want in zip(jac.numpy()[:, :, finite], j_jac[:, :, finite]):  # by parameter
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("smoothing,emit", [(False, False), (True, False), (True, True)])
def test_cuda_kernel_matches_plain_version(cuda_device, smoothing, emit):
    n = 50_000
    params = params_from_numpy(PARAMS, device=cuda_device, dtype=torch.float32)
    timeline, steps = SLICE_TIMELINE, 4
    if emit:
        timeline, _ = paths_ad.dense_timeline(0.0, SLICE_TIMELINE, 4)
        steps = 1
    before = heston_qe_paths.launches
    out = heston_qe_paths(params, timeline, n, steps, seed=9, phase=43,
                          smoothing=smoothing, emit_noise=emit)
    torch.cuda.synchronize()
    assert heston_qe_paths.launches == before + 1
    ref = heston_qe_paths_reference(params, timeline, n, steps, seed=9, phase=43,
                                    smoothing=smoothing, emit_noise=emit)
    if emit:
        assert torch.equal(out[2], ref[2])  # uniforms bitwise
        torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=1e-6)
        out, ref = out[0], ref[0]
    close = torch.isclose(out, ref, rtol=1e-5, atol=1e-6).all(dim=-1).all(dim=0)
    assert float(close.double().mean()) >= (1.0 if smoothing else 0.9999)
