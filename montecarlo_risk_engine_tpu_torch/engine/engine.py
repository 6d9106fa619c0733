"""Monte Carlo path engine: a Python loop over a static step schedule.

Counterpart of ``montecarlo_risk_engine_tpu/engine/engine.py``
(``simulate_paths`` with every keyword but ``transpose_states``).  PyTorch
runs eagerly, so the JAX ``lax.scan`` over timeline points becomes a loop
over points and substeps; autograd records it when the parameters require
grad.

  * Draws per substep come from a noise source ``counter -> (z [N, sim_dim],
    u [N] or None)`` with ``counter = point_idx * num_steps + k``
    (engine.py:256).  The default is the Philox stream of ``rng.py``, the
    same words the CUDA path kernels draw; tests inject the JAX engine's own
    threefry draws through ``noise_source``.
  * ``antithetic`` (engine.py:260-265, 287-292): the source draws N/2 paths
    and the engine appends their mirror, -z and 1 - u.
  * ``sampler="sobol"`` (engine.py:148-238): a digitally shifted Sobol
    sequence, path p the sequence's point p, one block of dimensions per
    substep (its ``sim_dim`` normals, then the QE uniform when the scheme
    takes one).  ``qmc_bridge`` rotates the normals of all substeps through
    a Brownian bridge (ops/sobol.brownian_bridge_matrix): the [T_sub, N,
    sim_dim] plane is built once, by the same fixed-order accumulation over
    levels as the JAX engine, and the QE uniforms take the dimensions after
    the normal block.
  * A zero-length interval (a timeline point at the calibration date or a
    repeated date) draws nothing and keeps its state (engine.py:251-253).
  * Under ANALYTICAL the noise transform is the Cholesky factor of the
    model's one-step covariance over each substep's dt (engine.py:244-245,
    273-275); the other schemes use one factor of the noise-factor
    correlation.

``path_sharding`` (parallel/mesh.PathSharding; engine.py:191-192,
241-242, 271-272, 309-310): ``num_paths`` is the run's count and this rank
simulates its own share, global paths ``rank + world_size * i``, and returns
them as its own [.., num_paths / R, ..] axis.  Every sampler draws by global
path index (the Philox counter, the Sobol point), so a rank's paths carry
the numbers they carry in a run on one rank; under ``antithetic`` the ranks
divide N / 2, so the mirror i + N/2 of each of a rank's base paths is its
own, and the rank draws its N / (2R) base paths and appends their mirrors.
An injected ``noise_source`` is asked for this rank's paths only: ``counter
-> (z [N / R, sim_dim], u)`` (half of that under ``antithetic``).

Streaming (engine.py:326-381).  With an ``emit_schedule``
(requests.EmissionSchedule) every point's request rows are resolved
against the live [N, D] state right after its substeps, and only those rows
are kept: the [T*K, N] (or [T*K]) rows of each schedule group, as
``requests.EmittedRows`` (the points' pieces, never concatenated).
``collect_states=False`` keeps no state plane at all.  ``fold=(aux0,
update)`` consumes each point's rows at once, ``aux = update(point_idx,
rows, state, aux)``, and returns the final ``aux``: nothing of shape
[rows, N] or [T, N, .] outlives its point.

``remat`` recomputes each point's substeps in the backward pass instead of
keeping their intermediates, the memory-for-compute trade of the JAX
engine's ``jax.checkpoint``.  It acts wherever the pass is recorded for
reverse mode (a plain autograd pass or ``torch.func.vjp``, the controller's
reverse mode, and forward over it for the Hessian rows); forward mode keeps
no intermediates.  A point's draws are drawn again for the recomputation,
so a ``noise_source`` must give the same draws for the same index.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, real_dtype, resolve_device
from montecarlo_risk_engine_tpu_torch.ops.noise import correlate_noise
from montecarlo_risk_engine_tpu_torch.parallel.mesh import local_paths
from montecarlo_risk_engine_tpu_torch.requests import EmittedRows


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
                        dtype: torch.dtype, device, path_offset: int = 0,
                        path_stride: int = 1) -> Callable:
    """The default noise source: ``counter -> (z, u)`` from the Philox
    stream keyed (root_seed, phase), the draws of the CUDA path kernels:
    ``sim_dim`` normals per substep (rng.substep_normals) and, for models
    that consume one (Heston QE), a uniform: word 2 of the first call
    (rng.substep_draws, K1's stream) beside at most 2 normals, else the lane
    of its own of rng.substep_uniform.  Path i is global path
    ``path_offset + path_stride * i``."""
    sim_dim = model.simulation_dim
    uses_uniform = model.uses_uniforms(scheme)
    where = dict(dtype=dtype, device=device, path_offset=path_offset, path_stride=path_stride)

    def source(counter: int):
        if uses_uniform and sim_dim <= 2:
            z_s, z_v, u = rng.substep_draws(root_seed, phase, counter, num_paths, **where)
            return torch.stack([z_s, z_v][:sim_dim], dim=-1), u
        z = rng.substep_normals(root_seed, phase, counter, num_paths, sim_dim, **where)
        u = (rng.substep_uniform(root_seed, phase, counter, num_paths, **where)
             if uses_uniform else None)
        return z, u

    return source


def _antithetic(source: Callable) -> Callable:
    """Each half-size draw followed by its mirror: z -> [z, -z], u -> [u, 1 - u]."""
    def mirrored(counter: int):
        z, u = source(counter)
        return torch.cat([z, -z]), None if u is None else torch.cat([u, 1.0 - u])

    return mirrored


def _substep_dts(calibration_date: float, timeline, num_steps: int):
    """Per substep its dt (0 on a zero-length interval), the bridge grid."""
    out, t_prev = [], float(calibration_date)
    for t in timeline:
        d_sub = (float(t) - t_prev) / num_steps
        out.extend([max(d_sub, 0.0)] * num_steps)
        t_prev = float(t)
    return np.asarray(out)


def sobol_source(model, scheme, timeline, num_paths: int, num_steps: int, phase: int,
                 root_seed: int, dtype, device, qmc_bridge: bool = False,
                 shift=None, path_offset: int = 0, path_stride: int = 1) -> Callable:
    """``counter -> (z, u)`` from the digitally shifted Sobol sequence
    (engine.py:148-238), path i its point ``path_offset + path_stride * i``.
    ``shift``: the [dims] shift words (a test seam for the JAX package's
    threefry words); None draws them from ``rng.qmc_shift``."""
    from montecarlo_risk_engine_tpu_torch.ops.sobol import (
        brownian_bridge_matrix,
        direction_numbers,
        sobol_uniforms,
    )

    sim_dim = model.simulation_dim
    needs_uniform = model.uses_uniforms(scheme)
    num_counters = len(timeline) * num_steps
    points = (path_offset, path_stride)
    as_shift = lambda n: (rng.qmc_shift(root_seed, phase, n, device) if shift is None
                          else torch.as_tensor(np.asarray(shift, dtype=np.int64)[:n],
                                               device=device))
    if not qmc_bridge:
        dims_step = sim_dim + (1 if needs_uniform else 0)
        vtab = direction_numbers(num_counters * dims_step)
        words = as_shift(vtab.shape[0])

        def source(counter: int):
            off = counter * dims_step
            u_all = sobol_uniforms(num_paths, vtab[off:off + dims_step],
                                   words[off:off + dims_step], dtype, device, *points)
            return (torch.special.ndtri(u_all[:, :sim_dim]),
                    u_all[:, sim_dim] if needs_uniform else None)

        return source

    bridge = brownian_bridge_matrix(_substep_dts(model.calibration_date, timeline, num_steps))
    num_levels = bridge.shape[1]
    dims_normal = num_levels * sim_dim
    vtab = direction_numbers(dims_normal + (num_counters if needs_uniform else 0))
    words = as_shift(vtab.shape[0])
    zeta = torch.special.ndtri(sobol_uniforms(
        num_paths, vtab[:dims_normal], words[:dims_normal], dtype, device, *points,
    )).reshape(num_paths, num_levels, sim_dim)
    bm = torch.as_tensor(bridge, dtype=dtype, device=device)
    # Fixed-order accumulation over the levels (engine.py:195-211): each
    # path's plane value is the same sequence of products and adds.
    plane = bm[:, 0, None, None] * zeta[None, :, 0, :]
    for lvl in range(1, num_levels):
        plane = plane + bm[:, lvl, None, None] * zeta[None, :, lvl, :]
    del zeta

    def source(counter: int):
        if not needs_uniform:
            return plane[counter], None
        row = dims_normal + counter
        return plane[counter], sobol_uniforms(num_paths, vtab[row:row + 1], words[row:row + 1],
                                              dtype, device, *points)[:, 0]

    return source


def _records_reverse(params) -> bool:
    """A pass recorded for reverse mode (plain autograd or ``torch.func``)."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in params)


class _Remat(torch.autograd.Function):
    """``step(*inputs)`` whose backward recomputes it, keeping only its
    inputs (``torch.utils.checkpoint`` relies on saved-tensor hooks, which
    ``torch.func`` does not support).  ``step`` depends on nothing that
    needs a gradient but ``inputs``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(step, *inputs):
        return step(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.step = inputs[0]
        ctx.save_for_backward(*inputs[1:])
        ctx.save_for_forward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(torch.func.vjp(ctx.step, *ctx.saved_tensors)[1](grad))

    @staticmethod
    def jvp(ctx, _, *tangents):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents))
        return torch.func.jvp(ctx.step, primals, tangents)[1]


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
    qmc_bridge: bool = False,
    remat: bool = False,
    emit_schedule=None,
    collect_states: bool = True,
    fold=None,
    qmc_shift=None,
    device=None,
    path_sharding=None,
):
    """States at each timeline point, [num_points, num_paths, state_dim], on
    ``device`` (default: the device of ``params``) in the working dtype; with
    an ``emit_schedule`` (states or None, emissions); with ``fold`` the final
    accumulator (see the module docstring).  Under ``path_sharding`` the
    path axis is this rank's num_paths / R paths.

    ``noise_source``: ``counter -> (z [N, sim_dim] standard normals, u [N]
    or None)`` for this rank's N paths (with ``antithetic``, half-size draws
    the engine mirrors); None draws from the Philox stream.  ``qmc_shift``:
    the Sobol shift words (None: ``rng.qmc_shift``)."""
    if antithetic and num_paths % 2:
        raise ValueError("antithetic sampling requires an even num_paths")
    num_paths, path_offset, path_stride = local_paths(num_paths, path_sharding, antithetic)
    if sampler not in ("pseudo", "sobol"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if sampler == "sobol" and antithetic:
        raise ValueError("sampler='sobol' is incompatible with antithetic "
                         "(Sobol points are not negation-symmetric)")
    if qmc_bridge and sampler != "sobol":
        raise ValueError("qmc_bridge requires sampler='sobol' (the bridge is "
                         "a quasi-random dimension-ordering device; pseudo-"
                         "random draws are exchangeable so it would be a no-op)")
    if sampler == "sobol" and noise_source is not None:
        raise ValueError("noise_source replaces the pseudo-random draws; the Sobol sampler "
                         "takes its shift words through qmc_shift")
    if fold is not None and emit_schedule is None:
        raise ValueError("fold needs an emit_schedule")
    dtype = real_dtype()
    device = params[0].device if device is None else resolve_device(device)
    params = tuple(p.to(device) for p in params)
    if len(timeline) == 0:
        empty = torch.zeros((0, num_paths, model.state_dim), dtype=dtype, device=device)
        if emit_schedule is not None:
            return (empty if collect_states else None), []
        return empty

    if sampler == "sobol":
        source = sobol_source(model, scheme, timeline, num_paths, num_steps, phase, root_seed,
                              dtype, device, qmc_bridge, qmc_shift, path_offset, path_stride)
    else:
        draw_paths = num_paths // 2 if antithetic else num_paths
        source = noise_source or philox_noise_source(model, scheme, draw_paths, phase,
                                                     root_seed, dtype, device, path_offset,
                                                     path_stride)
        if antithetic:
            source = _antithetic(source)

    analytical = scheme == SimulationScheme.ANALYTICAL
    chol = None if analytical else model.noise_transform(params, scheme).to(dtype)

    def point_step(point_idx, t_prev, dt_interval, state, *p, chol=None):
        """One point's substeps; ``chol`` None: the transform from ``p``."""
        dt = dt_interval / num_steps
        if analytical:
            transform = model.noise_transform(p, scheme, dt).to(dtype)
        else:
            transform = model.noise_transform(p, scheme).to(dtype) if chol is None else chol
        for k in range(num_steps):
            t1 = t_prev + k * dt
            z, u = source(point_idx * num_steps + k)
            noise = correlate_noise(z.to(device, dtype), transform)
            if u is not None:
                u = u.to(device, dtype)
            state = model.step(p, scheme, t1, t1 + dt, state, noise, u)
        return state

    use_remat = remat and _records_reverse(params)
    emit = None
    if emit_schedule is not None:
        tabs = [(torch.as_tensor(g.t1_tab, dtype=dtype, device=device),
                 torch.as_tensor(g.t2_tab, dtype=dtype, device=device))
                for g in emit_schedule.groups]

        def emit(point_idx, state):
            return tuple(
                model.resolve_request_rows(params, g.kind, g.asset_id, t1[point_idx],
                                           t2[point_idx], state.expand((g.K,) + state.shape))
                for g, (t1, t2) in zip(emit_schedule.groups, tabs))

    state = model.init_state(params, num_paths).to(dtype)
    t_prev_list, dt_list = build_step_schedule(model.calibration_date, timeline)
    states, emitted = [], []
    aux = None if fold is None else fold[0]
    for point_idx, (t_prev, dt_interval) in enumerate(zip(t_prev_list, dt_list)):
        if dt_interval > 0.0:
            if use_remat:  # the transform recomputed from the params inside
                state = _Remat.apply(functools.partial(point_step, point_idx, t_prev,
                                                       dt_interval), state, *params)
            else:
                state = point_step(point_idx, t_prev, dt_interval, state, *params, chol=chol)
        if emit is None:
            states.append(state)
            continue
        rows = emit(point_idx, state)
        if fold is not None:
            aux = fold[1](point_idx, rows, state, aux)
            continue
        emitted.append(rows)
        if collect_states:
            states.append(state)
    if fold is not None:
        return aux
    if emit is None:
        return torch.stack(states)
    emissions = [EmittedRows([rows[g] for rows in emitted])
                 for g in range(len(emit_schedule.groups))]
    return (torch.stack(states) if collect_states else None), emissions
