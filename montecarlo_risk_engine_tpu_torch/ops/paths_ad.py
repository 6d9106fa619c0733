"""Differentiable kernel paths: noise recovery and reconstruction.

Counterpart of ``montecarlo_risk_engine_tpu/ops/pallas_paths_ad.py``
(``dense_timeline``, ``_coarse_slots``, ``rows_from_states``,
``_rows_recon``, ``recovered_noise_fns`` and ``emitted_noise_fns``).

  1. The path kernel runs without grad on the substep-dense timeline (every
     substep boundary an emission point, one substep per point).
  2. The draws of every step are frozen: recovered from consecutive kernel
     states by ``model.invert_noise`` and a triangular solve against the
     noise transform L(params) (:func:`recovered_noise_fns`: every model of
     K2 and their ModelConfig hybrids; under ANALYTICAL L is the Cholesky
     factor of the one-step covariance over each step's dt,
     pallas_paths_ad.py:293-298), or taken from the noise-emitting kernel
     (:func:`emitted_noise_fns`: Heston QE, whose branch mixing is not
     invertible).
  3. ``model.step`` re-runs in plain torch on the frozen draws with
     parameters that carry tangents or require grad.  The draws do not
     depend on the parameters, so AD through this reconstruction is the
     exact pathwise derivative of the kernel's own trajectory.  Only the
     coarse timeline points are returned.

On a rank of a path-sharded run ``num_paths`` is the rank's own count and
the kernel forward the caller passes launches at the rank's path offset and
stride (ops/path_shard.py), so the frozen draws and the rebuilt paths are
the rank's own.

A timeline point at zero distance from its predecessor gets one dense entry
and draws nothing.  The dense run's draw counters are dense indices, so on a
timeline with such points it is a different (equally valid) stream from the
coarse forward run.

Kernel-streaming mode (``emit_schedule``, pallas_paths_ad.py:120-230): the
functions return the streaming engine's emissions (the [T*K, N] or [T*K]
rows of each schedule group) instead of the coarse plane.  The reconstruction
rebuilds ``EMIT_PLANE_CHUNK`` coarse points at a time and resolves only
their request rows before it drops them, so under AD no [T, N, D] plane
carries a tangent; the primal can be resolved from the kernel's plane
(:func:`rows_from_states`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.ops.gather import RowSelection
from montecarlo_risk_engine_tpu_torch.ops.noise import correlate_noise
from montecarlo_risk_engine_tpu_torch.requests import EmittedRows

# Coarse points per mini-plane of the rows-emitting reconstruction
# (pallas_paths_ad.py:147-151); read at call time, so tests can change it.
EMIT_PLANE_CHUNK = 8


def dense_timeline(calibration_date: float, timeline: Sequence[float], num_steps: int):
    """Expand a timeline so every substep boundary is an emission point.

    Returns (dense_points, orig_indices): the dense tuple of floats and, per
    original point, its index in the dense tuple.  A kernel run on
    ``dense_points`` with ``num_steps=1`` draws at the same counters as a run
    on ``timeline`` with ``num_steps`` when no interval has zero length."""
    dense, orig_idx = [], []
    t_prev = float(calibration_date)
    for t in timeline:
        t = float(t)
        dt = t - t_prev
        if dt <= 0.0:
            dense.append(t)
        else:
            for k in range(1, num_steps):
                dense.append(t_prev + dt * k / num_steps)
            dense.append(t)  # exact endpoint, no accumulation drift
        orig_idx.append(len(dense) - 1)
        t_prev = t
    return tuple(dense), np.asarray(orig_idx, dtype=np.int64)


def _coarse_slots(num_dense: int, orig_idx) -> np.ndarray:
    """slot[i] = coarse index whose interval contains dense step i.  Every
    substep writes its state to its interval's slot; the endpoint write is
    the last one in the interval."""
    slots = np.zeros(num_dense, dtype=np.int64)
    k = 0
    for i in range(num_dense):
        slots[i] = min(k, len(orig_idx) - 1)
        if k < len(orig_idx) and i == int(orig_idx[k]):
            k += 1
    return slots


def _schedule(calibration_date: float, dense):
    """Per dense step (t_prev, dt) on the host; dt = 0 for a repeated point."""
    out, t_prev = [], float(calibration_date)
    for t in dense:
        out.append((t_prev, float(t) - t_prev))
        t_prev = float(t)
    return out


class _Transforms:
    """The noise transform L(params) of each step: one factor of the noise
    correlation, or under ANALYTICAL the factor of the one-step covariance
    over the step's dt, computed once per distinct dt."""

    def __init__(self, model, scheme, params):
        self._model, self._scheme, self._params = model, scheme, params
        self._dtype = params[0].dtype
        self._by_dt = {}

    def __call__(self, dt: float) -> torch.Tensor:
        key = dt if self._scheme.name == "ANALYTICAL" else None
        if key not in self._by_dt:
            self._by_dt[key] = self._model.noise_transform(self._params, self._scheme,
                                                           key).to(self._dtype)
        return self._by_dt[key]


def _resolve_rows(model, params, group, states, points: Sequence[int]):
    """Rows [len(points) * K, N] (or [len(points) * K]) of one schedule group
    at the coarse ``points``, from ``states`` (a [T, N, D] tensor or a
    sequence of [N, D] states, indexed like ``points``): every point's K
    request rows in the streaming engine's flat order."""
    dtype = params[0].dtype
    device = (states if isinstance(states, torch.Tensor) else states[points[0]]).device
    tab = lambda t: torch.as_tensor(t[list(points)].ravel(), dtype=dtype, device=device)
    rows = [p for p in points for _ in range(group.K)]
    return model.resolve_request_rows(params, group.kind, group.asset_id, tab(group.t1_tab),
                                      tab(group.t2_tab), RowSelection(states, rows))


def rows_from_states(model, params, schedule, states):
    """The streaming emissions resolved from a coarse [T, N, D] state plane,
    one [T*K, N] (or [T*K]) tensor per schedule group
    (pallas_paths_ad.py:120-144): the primal of kernel-streaming AD from the
    kernel's own plane."""
    points = range(states.shape[0])
    return [_resolve_rows(model, params, g, states, points) for g in schedule.groups]


def _reconstruct(model, scheme, dense, slots, num_coarse, num_paths, params, z, u=None,
                 schedule=None):
    """Coarse states [T, N, D] rebuilt from the frozen standard normals z
    [T', N, sim_dim] (and uniforms u [T', N]) by ``model.step`` in the
    dtype of ``params``.  With a ``schedule``, the streaming emissions
    instead (pallas_paths_ad.py:154-227): each run of ``EMIT_PLANE_CHUNK``
    coarse points is resolved as soon as its last substep is done, and its
    states dropped."""
    dtype = params[0].dtype
    state = model.init_state(params, num_paths).to(dtype)
    transform = _Transforms(model, scheme, params)
    coarse = [None] * num_coarse
    chunk = max(1, int(EMIT_PLANE_CHUNK))
    c0, c1 = 0, min(chunk, num_coarse)
    out = None if schedule is None else [[] for _ in schedule.groups]
    for i, (t_prev, dt) in enumerate(_schedule(model.calibration_date, dense)):
        if dt > 0.0:
            noise = correlate_noise(z[i].to(dtype), transform(dt))
            state = model.step(params, scheme, t_prev, t_prev + dt, state, noise,
                               None if u is None else u[i].to(dtype))
        coarse[slots[i]] = state
        if schedule is not None and (i + 1 == len(slots) or slots[i + 1] >= c1):
            for g, rows in zip(schedule.groups, out):
                rows.append(_resolve_rows(model, params, g, coarse, range(c0, c1)))
            coarse[c0:c1] = [None] * (c1 - c0)
            c0, c1 = c1, min(c1 + chunk, num_coarse)
    if schedule is not None:
        return [EmittedRows(rows) for rows in out]
    return torch.stack(coarse)


def recovered_noise_fns(model, scheme, timeline, num_paths: int, num_steps: int,
                        forward_fn: Callable, emit_schedule=None):
    """(forward_coarse, noise_fn, recon_fn) for invertible transitions.

    ``forward_fn(params) -> [T', N, D]`` runs the path kernel on the
    substep-dense timeline (tests substitute the engine).

      * ``forward_coarse(params)``: kernel states at the original points;
      * ``noise_fn(params)``: the frozen standard normals z [T', N, sim_dim],
        recovered without grad in the dtype of ``params``: the correlated
        noise of each step by ``model.invert_noise`` on consecutive states
        (dt = 1 stands in at zero-length steps, whose noise is unused), then
        z = L^-1 noise by ``torch.linalg.solve_triangular``, one solve per
        step;
      * ``recon_fn(params, z)``: coarse states [T, N, D] rebuilt from z;
        ``recon_fn(p, noise_fn(p))`` is the kernel's trajectory.

    ``emit_schedule``: the kernel-streaming mode; ``forward_coarse`` and
    ``recon_fn`` return the schedule's emissions instead of the plane.
    """
    dense, orig_idx = dense_timeline(model.calibration_date, timeline, num_steps)
    slots = _coarse_slots(len(dense), orig_idx)

    def forward_coarse(params):
        with torch.no_grad():
            states = forward_fn(params)[torch.as_tensor(orig_idx)]
            if emit_schedule is not None:
                return rows_from_states(model, params, emit_schedule, states)
            return states

    def noise_fn(params):
        with torch.no_grad():
            params = tuple(p.detach() for p in params)
            dtype = params[0].dtype
            states = forward_fn(params).to(dtype)
            prev = model.init_state(params, num_paths).to(dtype)
            transform = _Transforms(model, scheme, params)
            z = []
            for i, (t_prev, dt) in enumerate(_schedule(model.calibration_date, dense)):
                dt_safe = dt if dt > 0.0 else 1.0
                corr = model.invert_noise(params, scheme, t_prev, t_prev + dt_safe, prev,
                                          states[i])
                # noise = z L^T row by row, so z = noise L^-T: one solve from
                # the right over the step's N rows, contiguous in and out.
                z.append(torch.linalg.solve_triangular(transform(dt_safe).mT, corr, upper=True,
                                                       left=False))
                prev = states[i]
        return torch.stack(z)  # [T', N, sim_dim]

    def recon_fn(params, z):
        return _reconstruct(model, scheme, dense, slots, len(orig_idx), num_paths, params, z,
                            schedule=emit_schedule)

    return forward_coarse, noise_fn, recon_fn


def emitted_noise_fns(model, scheme, timeline, num_paths: int, num_steps: int,
                      forward_fn: Callable, emit_schedule=None):
    """(forward_coarse, noise_fn, recon_fn) for non-invertible transitions.

    ``forward_fn(params) -> (states [T', N, D], z [T', N, sim_dim],
    u [T', N])`` runs the noise-emitting kernel on the substep-dense
    timeline.

      * ``forward_coarse(params)``: kernel states at the original points;
      * ``noise_fn(params)``: the frozen (z, u), computed without grad;
      * ``recon_fn(params, (z, u))``: coarse states [T, N, D] rebuilt from
        the draws by ``model.step`` in the dtype of ``params``.

    ``emit_schedule``: the kernel-streaming mode, as in
    :func:`recovered_noise_fns`.
    """
    dense, orig_idx = dense_timeline(model.calibration_date, timeline, num_steps)
    slots = _coarse_slots(len(dense), orig_idx)

    def forward_coarse(params):
        with torch.no_grad():
            states = forward_fn(params)[0][torch.as_tensor(orig_idx)]
            if emit_schedule is not None:
                return rows_from_states(model, params, emit_schedule, states)
            return states

    def noise_fn(params):
        with torch.no_grad():
            _, z, u = forward_fn(params)
        return z.detach(), u.detach()

    def recon_fn(params, noise):
        z, u = noise
        return _reconstruct(model, scheme, dense, slots, len(orig_idx), num_paths, params, z, u,
                            schedule=emit_schedule)

    return forward_coarse, noise_fn, recon_fn
