"""Differentiable kernel paths: noise recovery and reconstruction.

Counterpart of ``montecarlo_risk_engine_tpu/ops/pallas_paths_ad.py``
(``dense_timeline``, ``_coarse_slots``, ``recovered_noise_fns`` and
``emitted_noise_fns``).

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

A timeline point at zero distance from its predecessor gets one dense entry
and draws nothing.  The dense run's draw counters are dense indices, so on a
timeline with such points it is a different (equally valid) stream from the
coarse forward run.  The JAX package's streaming mode (``_rows_recon``)
is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.ops.noise import correlate_noise


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


def _reconstruct(model, scheme, dense, slots, num_coarse, num_paths, params, z, u=None):
    """Coarse states [T, N, D] rebuilt from the frozen standard normals z
    [T', N, sim_dim] (and uniforms u [T', N]) by ``model.step`` in the
    dtype of ``params``."""
    dtype = params[0].dtype
    state = model.init_state(params, num_paths).to(dtype)
    transform = _Transforms(model, scheme, params)
    coarse = [None] * num_coarse
    for i, (t_prev, dt) in enumerate(_schedule(model.calibration_date, dense)):
        if dt > 0.0:
            noise = correlate_noise(z[i].to(dtype), transform(dt))
            state = model.step(params, scheme, t_prev, t_prev + dt, state, noise,
                               None if u is None else u[i].to(dtype))
        coarse[slots[i]] = state
    return torch.stack(coarse)


def recovered_noise_fns(model, scheme, timeline, num_paths: int, num_steps: int,
                        forward_fn: Callable):
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
    """
    dense, orig_idx = dense_timeline(model.calibration_date, timeline, num_steps)
    slots = _coarse_slots(len(dense), orig_idx)

    def forward_coarse(params):
        with torch.no_grad():
            return forward_fn(params)[torch.as_tensor(orig_idx)]

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
        return _reconstruct(model, scheme, dense, slots, len(orig_idx), num_paths, params, z)

    return forward_coarse, noise_fn, recon_fn


def emitted_noise_fns(model, scheme, timeline, num_paths: int, num_steps: int,
                      forward_fn: Callable):
    """(forward_coarse, noise_fn, recon_fn) for non-invertible transitions.

    ``forward_fn(params) -> (states [T', N, D], z [T', N, sim_dim],
    u [T', N])`` runs the noise-emitting kernel on the substep-dense
    timeline.

      * ``forward_coarse(params)``: kernel states at the original points;
      * ``noise_fn(params)``: the frozen (z, u), computed without grad;
      * ``recon_fn(params, (z, u))``: coarse states [T, N, D] rebuilt from
        the draws by ``model.step`` in the dtype of ``params``.
    """
    dense, orig_idx = dense_timeline(model.calibration_date, timeline, num_steps)
    slots = _coarse_slots(len(dense), orig_idx)

    def forward_coarse(params):
        with torch.no_grad():
            return forward_fn(params)[0][torch.as_tensor(orig_idx)]

    def noise_fn(params):
        with torch.no_grad():
            _, z, u = forward_fn(params)
        return z.detach(), u.detach()

    def recon_fn(params, noise):
        z, u = noise
        return _reconstruct(model, scheme, dense, slots, len(orig_idx), num_paths, params, z, u)

    return forward_coarse, noise_fn, recon_fn
