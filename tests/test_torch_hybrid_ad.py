"""Recovered-noise AD of the port (ops/paths_ad.recovered_noise_fns) against
the JAX package's (ops/pallas_paths_ad.py) on the same dense engine states.

Both packages take the JAX engine's f64 dense trajectory as the kernel
stand-in (the pattern of tests/test_pallas_ad.py:139-183), recover the
standard normals, rebuild the coarse states and differentiate a weighted
summary in forward mode.  The port rebuilds them twice: in torch ops and by
the forward-mode reconstruction kernel's route (ops/recon_tangents.py, its
plain version on the CPU).

Where CIR++ y lands on its 1e-12 floor the two inversions differ by design
(models/cirpp.py invert_noise): the JAX residual puts the rebuilt pre-floor
value on the kink, so its recovered tangent there is not the pathwise
derivative.  On books that touch the floor the port is therefore held to
direct AD through the JAX engine (the oracle of tests/test_pallas_ad.py),
and its normals to JAX's on every step that did not land on the floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import montecarlo_risk_engine_tpu as mj
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu.ops import pallas_paths_ad as jax_ad
from montecarlo_risk_engine_tpu_torch import SimulationScheme, params_from_numpy
from montecarlo_risk_engine_tpu_torch.models.cirpp import CIRPPModel
from montecarlo_risk_engine_tpu_torch.ops import paths_ad, recon_tangents
from test_torch_hybrid_models import HAZARDS, north_star_model, port_pkg

torch.set_num_threads(1)

TIMELINE = (0.4, 0.8, 1.3, 2.0, 3.0)
NUM_STEPS = 3
NUM_PATHS = 256
NO_FLOOR = dict(kappa=0.4, theta=0.02, volatility=0.05, y0=0.01)  # tests/test_pallas_ad.py:59-61


def _models(name):
    if name == "cirpp_floor":
        kw = dict(asset_id="cp", hazard_rates=HAZARDS, kappa=0.1, theta=0.01, volatility=0.02,
                  y0=0.0001)
        return mj.CIRPPModel(0.0, **kw), CIRPPModel(0.0, **kw)
    if name == "hybrid":
        return north_star_model(mj, **NO_FLOOR), north_star_model(port_pkg(), **NO_FLOOR)
    return north_star_model(mj), north_star_model(port_pkg())


def _summary_weights(shape):
    return 1.0 + 0.1 * np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)


@pytest.mark.parametrize("name", ["hybrid", "north_star_hybrid", "cirpp_floor"])
def test_recovered_noise_matches_jax(name):
    jm, pm = _models(name)
    scheme = mj.SimulationScheme.EULER
    dense, orig_idx = jax_ad.dense_timeline(0.0, TIMELINE, NUM_STEPS)
    jparams = jm.initial_params()

    def jax_forward(p):
        return jax_simulate_paths(jm, p, scheme, dense, NUM_PATHS, 1, jax_rng.PHASE_MAINSIM,
                                  root_seed=7)

    dense_states = np.array(jax_forward(jparams))
    floor = dense_states[..., -2] <= 1e-12  # CIR++ y is the second-last column
    assert bool(floor.any()) == (name != "hybrid")

    # JAX: recovered normals, rebuilt states, and the summary's jacobian.
    _, j_noise, j_recon = jax_ad.recovered_noise_fns(jm, scheme, TIMELINE, NUM_PATHS, NUM_STEPS,
                                                     jax_forward)
    j_z = np.asarray(jax.jit(j_noise)(jparams))
    j_states = np.asarray(jax.jit(lambda p: j_recon(p, j_noise(p)))(jparams))
    w = _summary_weights(j_states.shape)

    def jax_summary(fn):
        return jax.jit(jax.jacfwd(lambda p: jnp.mean(fn(p) * w)))(jparams)

    if name == "hybrid":
        j_grad = jax_summary(jax_ad.recovered_noise_paths(jm, scheme, TIMELINE, NUM_PATHS,
                                                          NUM_STEPS, jax_forward))
    else:
        j_grad = jax_summary(lambda p: jax_forward(p)[np.asarray(orig_idx)])  # direct AD

    # The port on the same dense states.
    params = params_from_numpy([np.asarray(p) for p in jparams])
    _, noise_fn, recon_fn = paths_ad.recovered_noise_fns(
        pm, SimulationScheme.EULER, TIMELINE, NUM_PATHS, NUM_STEPS,
        lambda p: torch.from_numpy(dense_states))
    z = noise_fn(params)
    states = recon_fn(params, z)
    wt = torch.from_numpy(w)
    grad = jacfwd(lambda *p: torch.mean(recon_fn(p, z) * wt), argnums=tuple(range(len(params))))(
        *params)
    # The forward-mode reconstruction kernel's route (its plain version on
    # the CPU) on the same draws.
    kernel_fn = recon_tangents.reconstruction(pm, SimulationScheme.EULER, TIMELINE, NUM_STEPS)
    k_states = kernel_fn(params, z)
    k_grad = jacfwd(lambda *p: torch.mean(kernel_fn(p, z) * wt),
                    argnums=tuple(range(len(params))))(*params)

    live = np.ones_like(j_z, dtype=bool)
    live[..., -1] = ~floor  # a floored CIR++ step changes only the cirpp (last) normal
    np.testing.assert_allclose(z.numpy()[live], j_z[live], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(states.numpy(), j_states, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(states.numpy(), dense_states[orig_idx], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k_states.numpy(), j_states, rtol=1e-12, atol=1e-14)
    for a, k, b, pname in zip(grad, k_grad, j_grad, pm.get_model_param_names()):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-8, atol=1e-12, err_msg=pname)
        np.testing.assert_allclose(float(k), float(b), rtol=1e-8, atol=1e-12, err_msg=pname)


def test_floor_and_zero_diffusion_conventions():
    """invert_noise returns 0 where the diffusion vanishes (y <= 0), and on a
    step that landed on the floor a noise that rebuilds the floor with a
    zero tangent."""
    model = CIRPPModel(0.0, "cp", HAZARDS, kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)
    params = model.initial_params()
    state = torch.tensor([[0.0, 0.0], [-1e-3, 0.0], [5e-5, 0.0], [5e-5, 0.0]], dtype=torch.float64)
    nxt = torch.tensor([[2.5e-4, 0.0], [2.5e-4, 0.0], [1e-12, 0.0], [3e-4, 0.0]],
                       dtype=torch.float64)
    z = model.invert_noise(params, SimulationScheme.EULER, 1.0, 1.25, state, nxt)
    assert float(z[0]) == 0.0 and float(z[1]) == 0.0
    assert torch.all(torch.isfinite(z))

    def rebuilt(*p):
        return model.step(p, SimulationScheme.EULER, 1.0, 1.25, state, z)[:, 0]

    np.testing.assert_allclose(rebuilt(*params)[2:].numpy(), [1e-12, 3e-4], rtol=1e-12)
    tangent = jacfwd(rebuilt, argnums=(0, 1, 2, 3))(*params)
    for t in tangent:
        assert float(t[2]) == 0.0          # on the floor: the pathwise derivative is 0
    assert float(tangent[1][3]) != 0.0     # off the floor: d y' / d theta = kappa dt
