"""Differentiable kernel paths: emitted-noise reconstruction (Heston QE).

Counterpart of ``montecarlo_risk_engine_tpu/ops/pallas_paths_ad.py``
(``dense_timeline``, ``_coarse_slots`` and ``emitted_noise_fns``; the
recovered-noise variant for invertible models comes with the hybrid kernel).

  1. The noise-emitting kernel runs under ``torch.no_grad()`` on the
     substep-dense timeline (every substep boundary an emission point, one
     substep per point).  That gives the primal states and the frozen draws
     (z, u).
  2. ``model.step`` re-runs in plain torch on those draws with parameters
     that require grad, ``perform_smoothing`` set.  The draws do not depend
     on the parameters, so autograd through this reconstruction is the exact
     pathwise derivative of the kernel's own trajectory.
  3. Only the coarse timeline points are returned.

A timeline point at zero distance from its predecessor gets one dense entry
and draws nothing.  The dense run's draw counters are dense indices, so on a
timeline with such points it is a different (equally valid) stream from the
coarse forward run.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


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
        dtype = params[0].dtype
        state = model.init_state(params, num_paths).to(dtype)
        chol = model.noise_transform(params, scheme).to(dtype)
        coarse = [None] * len(orig_idx)
        t_prev = float(model.calibration_date)
        for i, t in enumerate(dense):
            if t - t_prev > 0.0:
                noise_i = z[i].to(dtype) @ chol.mT
                state = model.step(params, scheme, t_prev, t_prev + (t - t_prev),
                                   state, noise_i, u[i].to(dtype))
            coarse[slots[i]] = state
            t_prev = t
        return torch.stack(coarse)

    return forward_coarse, noise_fn, recon_fn
