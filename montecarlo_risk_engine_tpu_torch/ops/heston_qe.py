"""Heston-QE path generation: the CUDA kernel K1 and its plain version.

Replaces the TPU kernel ``heston_qe_paths``
(montecarlo_risk_engine_tpu/ops/pallas_paths.py:148).  What it computes:
Andersen-QE Heston trajectories, states (log S, v) at each timeline point,
optionally with the raw draws of every step for the emitted-noise AD path.

Kernel (``csrc/heston_qe.cu``, CUDA C++ for sm_90a, built by ops/cuda_build):

  * One thread per path.  log S and v stay in registers across every point
    and substep — what the TPU kernel kept in VMEM.  Its only device-memory
    traffic is the emission: 8 bytes per path per point (20 with noise).
  * Bound by arithmetic, not bytes: each substep runs one Philox4x32-10 call
    (10 rounds of two 32x32 multiplies), a Box-Muller pair (log, sqrt,
    sin, cos), two or three square roots, a log and six IEEE divisions, in
    float32.  At 1M paths x 40 substeps the emission is 80 MB (~25 us at
    3.35 TB/s), far below the arithmetic time, so the design keeps the
    per-substep work minimal: the per-(params, dt) scalars are computed
    once per point, not per substep (the hoisting of
    ``_heston_qe_substep``), and 256-thread blocks over 1M paths keep every
    SM busy without shared memory.
  * Draws: Philox4x32-10 keyed (seed, phase) at counter (path, point *
    num_steps + k, 0, 0), the stream of ``rng.substep_draws``.  A sharded
    run will pass a global path offset (not needed on one card yet).
  * Built without FMA contraction and without fast math, so on the card it
    rounds op for op like :func:`heston_qe_paths_reference`.

:func:`heston_qe_paths` dispatches on the device of ``params``: CUDA tensors
launch the kernel (or raise), CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.ops import cuda_build

_EPS = 1e-12
# The kernel's constant table of per-point dts (csrc/heston_qe.cu kMaxPoints).
MAX_POINTS = 512


def heston_qe_substep(log_s, v, z_s, z_v, u, dt, sigma, rate, rho, kappa, theta,
                      smoothing: bool = False):
    """One Andersen-QE update with the algebra of the TPU kernel's
    ``_heston_qe_substep`` (pallas_paths.py:79) and of the CUDA kernel, op
    for op: parameters are 0-d tensors, ``dt`` a float.  ``smoothing``
    selects the fuzzy branch indicators (widths 0.3 and 0.5)."""
    # ---- scalars (params x dt only) ----
    ekt = torch.exp(-kappa * dt)
    one_m_ekt = 1.0 - ekt
    sig2 = sigma * sigma
    c_m = theta * one_m_ekt                      # m = c_m + v * ekt
    c1 = sig2 * ekt * one_m_ekt / kappa          # s2 = v * c1 + c2
    c2 = theta * sig2 * one_m_ekt * one_m_ekt / (2.0 * kappa)
    k0 = -rho * kappa * theta / sigma * dt
    k1 = (kappa * rho / sigma - 0.5) * dt - rho / sigma
    k2 = rho / sigma
    k3 = (1.0 - rho * rho) * dt
    drift = rate * dt + k0

    # ---- per-path ops ----
    m = c_m + v * ekt
    s2 = v * c1 + c2
    m2 = m * m + _EPS
    psi = s2 / m2
    inv_psi = m2 / (s2 + _EPS)

    tail = torch.clamp(2.0 * inv_psi - 1.0, min=0.0)
    b2 = torch.clamp(tail + torch.sqrt(2.0 * inv_psi * tail), min=0.0)
    a = m / (1.0 + b2)
    sb2_z = torch.sqrt(b2) + z_v
    v_quad = a * (sb2_z * sb2_z)

    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-6)
    one_m_p = 1.0 - p
    v_tail = (
        torch.log(torch.clamp(one_m_p, min=_EPS) / torch.clamp(1.0 - u, min=_EPS))
        * (m + _EPS) / (one_m_p + _EPS)
    )
    if smoothing:
        # (u - p + 0.3) / 0.6 as a multiply by the reciprocal: the same
        # rounding whether torch or the kernel evaluates it.
        w_mass = torch.clamp((u - p + 0.3) * (1.0 / 0.6), 0.0, 1.0)
        v_exp = w_mass * v_tail
        w = torch.clamp(psi - 1.0, 0.0, 1.0)
        v_next = (1.0 - w) * v_quad + w * v_exp
    else:
        v_exp = torch.where(u > p, v_tail, torch.zeros_like(v_tail))
        v_next = torch.where(psi > 1.5, v_exp, v_quad)

    vol = torch.sqrt(torch.clamp(k3 * v, min=_EPS))
    log_s_next = (log_s + drift) + k1 * v + k2 * v_next + vol * z_s
    return log_s_next, v_next


def _point_dts(timeline: Sequence[float], calibration_date: float, num_steps: int):
    dts, t_prev = [], float(calibration_date)
    for t in timeline:
        dts.append((float(t) - t_prev) / num_steps)
        t_prev = float(t)
    return dts


def _check_args(params, timeline, num_paths, num_steps, emit_noise):
    if len(params) != 7:
        raise ValueError("heston_qe_paths expects the 7 Heston parameters")
    if emit_noise and num_steps != 1:
        raise ValueError("emit_noise requires the substep-dense timeline (num_steps == 1)")
    if num_steps < 1 or not 0 < num_paths < 2 ** 32:
        raise ValueError(f"bad num_steps={num_steps} / num_paths={num_paths}")
    if len(timeline) > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} timeline points, got {len(timeline)}")


def heston_qe_paths_reference(
    params,
    timeline: Sequence[float],
    num_paths: int,
    num_steps: int,
    seed: int = 0,
    phase: int = 0,
    calibration_date: float = 0.0,
    smoothing: bool = False,
    emit_noise: bool = False,
    dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version of the kernel, on the device of ``params``.

    Same Philox words, same Box-Muller, same step algebra.  Returns
    states [T, N, 2]; with ``emit_noise`` also z [T, N, 2] and u [T, N]
    (zeros at zero-dt points)."""
    _check_args(params, timeline, num_paths, num_steps, emit_noise)
    spot, sigma, rate, rho, kappa, theta, v0 = (p.detach().to(dtype) for p in params)
    device = spot.device
    log_s = torch.log(spot).expand(num_paths)
    v = v0.expand(num_paths)
    states, zs, us = [], [], []
    for point, dt in enumerate(_point_dts(timeline, calibration_date, num_steps)):
        if dt > 0.0:
            for k in range(num_steps):
                z_s, z_v, u = rng.substep_draws(
                    seed, phase, point * num_steps + k, num_paths, dtype, device)
                log_s, v = heston_qe_substep(
                    log_s, v, z_s, z_v, u, dt, sigma, rate, rho, kappa, theta,
                    smoothing=smoothing,
                )
            if emit_noise:
                zs.append(torch.stack([z_s, z_v], dim=-1))
                us.append(u)
        elif emit_noise:
            zs.append(torch.zeros((num_paths, 2), dtype=dtype, device=device))
            us.append(torch.zeros((num_paths,), dtype=dtype, device=device))
        states.append(torch.stack([log_s, v], dim=-1))
    out = torch.stack(states)
    if not emit_noise:
        return out
    return out, torch.stack(zs), torch.stack(us)


def _bind(lib: ctypes.CDLL):
    fn = lib.mcre_heston_qe_paths
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # states, z, u
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # dts, points, steps
        ctypes.c_uint32,                                     # num_paths
        *([ctypes.c_float] * 7),                             # params
        ctypes.c_uint32, ctypes.c_uint32,                    # seed, phase
        ctypes.c_int, ctypes.c_int,                          # smoothing, emit
        ctypes.c_void_p,                                     # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(params, timeline, num_paths, num_steps, seed, phase, calibration_date,
            smoothing, emit_noise):
    built = cuda_build.load_library("heston_qe")
    fn = _bind(built.lib)
    device = params[0].device
    dts = _point_dts(timeline, calibration_date, num_steps)
    n_pts = len(dts)
    states = torch.empty((n_pts, num_paths, 2), dtype=torch.float32, device=device)
    z = u = None
    if emit_noise:
        z = torch.empty((n_pts, num_paths, 2), dtype=torch.float32, device=device)
        u = torch.empty((n_pts, num_paths), dtype=torch.float32, device=device)
    if n_pts:
        table = (ctypes.c_float * n_pts)(*dts)
        values = [float(p) for p in params]
        with torch.cuda.device(device):
            rc = fn(
                states.data_ptr(),
                None if z is None else z.data_ptr(),
                None if u is None else u.data_ptr(),
                ctypes.cast(table, ctypes.c_void_p), n_pts, num_steps, num_paths,
                *values,
                seed & 0xFFFFFFFF, phase & 0xFFFFFFFF,
                int(smoothing), int(emit_noise),
                torch.cuda.current_stream(device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"heston_qe_paths: CUDA launch failed with cudaError_t {rc}")
        heston_qe_paths.launches += 1
        if emit_noise:
            heston_qe_paths.emit_launches += 1
    return states if not emit_noise else (states, z, u)


def heston_qe_paths(
    params,
    timeline: Sequence[float],
    num_paths: int,
    num_steps: int,
    seed: int = 0,
    phase: int = 0,
    calibration_date: float = 0.0,
    smoothing: bool = False,
    emit_noise: bool = False,
):
    """Heston QE states at timeline points: [T, N, 2] float32 (log S, v).

    ``emit_noise=True`` (requires ``num_steps == 1``, the AD path's
    substep-dense timeline) also returns the draws z [T, N, 2] and u [T, N].
    CUDA ``params`` launch the kernel; CPU ``params`` run
    :func:`heston_qe_paths_reference`."""
    _check_args(params, timeline, num_paths, num_steps, emit_noise)
    device = params[0].device
    if device.type == "cpu":
        return heston_qe_paths_reference(
            params, timeline, num_paths, num_steps, seed=seed, phase=phase,
            calibration_date=calibration_date, smoothing=smoothing,
            emit_noise=emit_noise,
        )
    if device.type != "cuda":
        raise ValueError(f"heston_qe_paths: unsupported device {device}")
    return _launch(params, timeline, num_paths, num_steps, seed, phase,
                   calibration_date, smoothing, emit_noise)


heston_qe_paths.launches = 0       # kernel launches (all variants)
heston_qe_paths.emit_launches = 0  # launches of the noise-emitting variant
