"""Monte Carlo path engine: a Python loop over a static step schedule.

Counterpart of ``montecarlo_risk_engine_tpu/engine/engine.py``
(``simulate_paths`` plain mode: no Sobol, antithetic, streaming emission,
fold or remat yet).  PyTorch runs eagerly, so the JAX ``lax.scan`` over
timeline points becomes a loop over points and substeps; autograd records
it when the parameters require grad.

  * Draws per substep come from ``noise_source(counter) -> (z [N, sim_dim],
    u [N] or None)`` with ``counter = point_idx * num_steps + k``
    (engine.py:256).  The default is the Philox stream of ``rng.py``, the
    same words the CUDA path kernel draws; tests inject the JAX engine's own
    threefry draws through this seam.
  * A zero-length interval (a timeline point at the calibration date or a
    repeated date) draws nothing and keeps its state (engine.py:251-253).
  * Under ANALYTICAL the noise transform is the Cholesky factor of the
    model's one-step covariance over each substep's dt (engine.py:244-245,
    273-275); the other schemes use one factor of the noise-factor correlation.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, real_dtype, resolve_device


def build_step_schedule(calibration_date: float, timeline: Sequence[float]):
    """Per-point (t_prev, interval_dt) lists from a static timeline."""
    t_prev_list, dt_list = [], []
    t_prev = float(calibration_date)
    for t in timeline:
        t = float(t)
        t_prev_list.append(t_prev)
        dt_list.append(t - t_prev)
        t_prev = t
    return t_prev_list, dt_list


def philox_noise_source(model, scheme, num_paths: int, phase: int, root_seed: int,
                        dtype: torch.dtype, device) -> Callable:
    """The default noise source: ``counter -> (z, u)`` from the Philox
    stream keyed (root_seed, phase), the draws of the CUDA path kernels:
    ``sim_dim`` normals per substep (rng.substep_normals) and, for models
    that consume one (Heston QE), the uniform of word 2 (rng.substep_draws)."""
    sim_dim = model.simulation_dim
    if model.uses_uniforms(scheme) and sim_dim > 2:
        raise NotImplementedError(
            "the Philox stream has no uniform beside more than 2 normals per substep")

    def source(counter: int):
        if model.uses_uniforms(scheme):
            z_s, z_v, u = rng.substep_draws(root_seed, phase, counter, num_paths, dtype, device)
            return torch.stack([z_s, z_v][:sim_dim], dim=-1), u
        return rng.substep_normals(root_seed, phase, counter, num_paths, sim_dim, dtype,
                                   device), None

    return source


def simulate_paths(
    model,
    params,
    scheme: SimulationScheme,
    timeline: Sequence[float],
    num_paths: int,
    num_steps: int,
    phase: int,
    root_seed: int = 0,
    noise_source: Optional[Callable] = None,
    antithetic: bool = False,
    sampler: str = "pseudo",
    device=None,
) -> torch.Tensor:
    """States at each timeline point, [num_points, num_paths, state_dim], on
    ``device`` (default: the device of ``params``) in the working dtype.

    ``noise_source``: ``counter -> (z [N, sim_dim] standard normals, u [N]
    or None)``; None draws from the Philox stream."""
    if antithetic:
        raise NotImplementedError("antithetic sampling is not ported yet")
    if sampler != "pseudo":
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
    dtype = real_dtype()
    device = params[0].device if device is None else resolve_device(device)
    params = tuple(p.to(device) for p in params)
    if noise_source is None:
        noise_source = philox_noise_source(model, scheme, num_paths, phase, root_seed,
                                           dtype, device)
    if len(timeline) == 0:
        return torch.zeros((0, num_paths, model.state_dim), dtype=dtype, device=device)

    state = model.init_state(params, num_paths).to(dtype)
    analytical = scheme == SimulationScheme.ANALYTICAL
    if not analytical:
        chol = model.noise_transform(params, scheme).to(dtype)
    t_prev_list, dt_list = build_step_schedule(model.calibration_date, timeline)
    states = []
    for point_idx, (t_prev, dt_interval) in enumerate(zip(t_prev_list, dt_list)):
        if dt_interval > 0.0:
            dt = dt_interval / num_steps
            if analytical:
                chol = model.noise_transform(params, scheme, dt).to(dtype)
            for k in range(num_steps):
                t1 = t_prev + k * dt
                z, u = noise_source(point_idx * num_steps + k)
                noise = z.to(device, dtype) @ chol.mT
                if u is not None:
                    u = u.to(device, dtype)
                state = model.step(params, scheme, t1, t1 + dt, state, noise, u)
        states.append(state)
    return torch.stack(states)
