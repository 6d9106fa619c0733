"""The PyTorch port's path engine against the JAX engine, f64, on the JAX
engine's own threefry draws fed through the port's ``noise_source`` seam."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_risk_engine_tpu import HestonModel as JaxHeston
from montecarlo_risk_engine_tpu import SimulationScheme as JaxScheme
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu_torch import HestonModel, SimulationScheme, params_from_numpy
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths_reference

torch.set_num_threads(1)

MODEL_KW = dict(spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06, v0=0.04)
SLICE_TIMELINE = tuple(0.1 * (i + 1) for i in range(10))
EDGE_TIMELINE = (0.0, 0.3, 0.3, 0.7, 1.0)


def jax_engine_noise(root_seed, phase, num_counters, num_paths, sim_dim=2):
    """The draws the JAX engine makes at each counter (engine.py:261-297)."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(root_seed), phase)

    def draw(counter):
        z = jax_rng.normals(jax_rng.step_key(phase_k, counter, jax_rng.PURPOSE_NORMAL),
                            (num_paths, sim_dim), jnp.float64)
        u = jax_rng.uniforms(jax_rng.step_key(phase_k, counter, jax_rng.PURPOSE_UNIFORM),
                             (num_paths,), jnp.float64)
        return z, u

    z, u = jax.jit(jax.vmap(draw))(jnp.arange(num_counters))
    z, u = torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))
    return lambda counter: (z[counter], u[counter])


@pytest.mark.parametrize("scheme_name", ["QE", "EULER"])
@pytest.mark.parametrize("timeline", [SLICE_TIMELINE, EDGE_TIMELINE], ids=["slice", "edge"])
@pytest.mark.parametrize("smoothing", [False, True])
def test_engine_matches_jax_engine_on_injected_noise(scheme_name, timeline, smoothing):
    n, num_steps, phase = 512, 4, jax_rng.PHASE_MAINSIM
    jmodel = JaxHeston(0.0, **MODEL_KW)
    model = HestonModel(0.0, **MODEL_KW)
    if smoothing:
        jmodel.requires_grad()
        model.requires_grad()
    jparams = jmodel.initial_params()
    ref = np.asarray(jax_simulate_paths(jmodel, jparams, JaxScheme[scheme_name], timeline,
                                        n, num_steps, phase, root_seed=0))
    states = simulate_paths(
        model, params_from_numpy([np.asarray(p) for p in jparams]),
        SimulationScheme[scheme_name], timeline, n, num_steps, phase,
        noise_source=jax_engine_noise(0, phase, len(timeline) * num_steps, n),
    )
    assert states.shape == ref.shape and states.dtype == torch.float64
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-14)


def test_engine_zero_interval_keeps_state_and_draws_nothing():
    model = HestonModel(0.0, **MODEL_KW)
    calls = []

    def source(counter):
        calls.append(counter)
        return torch.zeros((8, 2), dtype=torch.float64), torch.full((8,), 0.5, dtype=torch.float64)

    states = simulate_paths(model, model.initial_params(), SimulationScheme.QE,
                            EDGE_TIMELINE, 8, 2, 43, noise_source=source)
    assert calls == [2, 3, 6, 7, 8, 9]           # points 0 and 2 have zero length
    assert torch.equal(states[0], model.init_state(model.initial_params(), 8))
    assert torch.equal(states[1], states[2])


def test_engine_default_noise_is_the_kernel_stream():
    """Without a noise source the engine draws the Philox words of the path
    kernel: same paths as the plain kernel up to the step algebra."""
    n, num_steps = 256, 4
    model = HestonModel(0.0, **MODEL_KW)
    params = model.initial_params()
    states = simulate_paths(model, params, SimulationScheme.QE, SLICE_TIMELINE, n,
                            num_steps, 43, root_seed=5)
    kernel = heston_qe_paths_reference(params, SLICE_TIMELINE, n, num_steps, seed=5,
                                       phase=43, dtype=torch.float64)
    # step_qe and the kernel place the 1e-12 guard differently (see
    # test_torch_heston_kernel.test_substep_matches_jax_step_qe).
    np.testing.assert_allclose(states.numpy(), kernel.numpy(), rtol=1e-7, atol=1e-7)


def test_engine_device_argument():
    model = HestonModel(0.0, **MODEL_KW)
    params = model.initial_params()
    on_params = simulate_paths(model, params, SimulationScheme.QE, SLICE_TIMELINE, 64, 2, 43)
    explicit = simulate_paths(model, params, SimulationScheme.QE, SLICE_TIMELINE, 64, 2, 43,
                              device="cpu")
    assert explicit.device == torch.device("cpu") and torch.equal(on_params, explicit)


def test_engine_refuses_unported_samplers():
    # Antithetic pairs and the Sobol sampler are ported
    # (tests/test_torch_samplers.py); what the JAX engine refuses is refused.
    model = HestonModel(0.0, **MODEL_KW)
    for kwargs, n in ((dict(antithetic=True), 7), (dict(sampler="sobol", antithetic=True), 8),
                      (dict(qmc_bridge=True), 8), (dict(sampler="halton"), 8)):
        with pytest.raises(ValueError):
            simulate_paths(model, model.initial_params(), SimulationScheme.QE,
                           SLICE_TIMELINE, n, 1, 43, **kwargs)
    for kwargs in (dict(antithetic=True), dict(sampler="sobol")):
        assert torch.isfinite(simulate_paths(model, model.initial_params(), SimulationScheme.QE,
                                             SLICE_TIMELINE, 8, 1, 43, **kwargs)).all()


@pytest.mark.parametrize("scheme_name", ["QE", "EULER"])
def test_remat_matches_the_recorded_pass_under_every_transform(scheme_name, monkeypatch):
    """``remat`` recomputes each point's substeps in the backward pass: the
    gradient under plain autograd, under ``torch.func.vjp`` with ``vmap``
    over the cotangents (the controller's reverse mode) and forward over it
    (the Hessian rows' reverse branch) equals the recorded pass's, and the
    recomputing Function ran in each."""
    from torch.func import jvp, vjp, vmap

    import montecarlo_risk_engine_tpu_torch.engine.engine as engine

    calls = []
    apply = engine._Remat.apply
    monkeypatch.setattr(engine._Remat, "apply", lambda *a: calls.append(1) or apply(*a))
    model = HestonModel(0.0, **MODEL_KW)
    params = model.initial_params()
    eye = torch.eye(2, dtype=torch.float64)
    tangent = tuple(torch.full_like(p, 0.5) for p in params)

    def values(remat):
        def fn(p):
            s = simulate_paths(model, p, SimulationScheme[scheme_name], SLICE_TIMELINE, 64, 2,
                               43, root_seed=5, remat=remat)
            return torch.stack([s[..., 0].mean(), (s[..., 1] * s[..., 0]).mean()])
        return fn

    def grads(remat):
        p = tuple(x.clone().requires_grad_(True) for x in params)
        return torch.stack(torch.autograd.grad(values(remat)(p)[1], p))

    def jacrev(remat, p=params):
        return torch.stack(vmap(vjp(values(remat), p)[1])(eye)[0])

    def hessian_row(remat):
        return jvp(lambda p: jacrev(remat, p), (params,), (tangent,))[1]

    for check in (grads, jacrev, hessian_row):
        calls.clear()
        plain = check(False)
        assert not calls
        rematted = check(True)
        assert calls, f"{check.__name__}: no point was recomputed"
        np.testing.assert_allclose(rematted.numpy(), plain.numpy(), rtol=1e-13, atol=1e-15,
                                   err_msg=check.__name__)
