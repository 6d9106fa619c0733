"""The Heston-QE substep ladder (K3): nine CUDA rungs over K1's stages and
their plain versions.

Replaces the TPU kernel of ``benchmarks/kernel_decomposition.py`` (``build``
:226 -> ``make_kernel`` :240, ``pallas_call`` :262).  What it computes:
Heston path generations at K1's shapes, [T, N, 2] float32 (log S, v), each
through one of nine substep variants (:281-291), whose differences split
K1's cost per substep by stage (``tools/kernel_decomposition.py`` runs
them).

Kernel (``csrc/heston_ladder.cu``, CUDA C++ for sm_90a, built by
ops/cuda_build), with K1's launch geometry and its own device code
(``csrc/random.cuh``, ``csrc/heston_qe_step.cuh``):

  * One thread per path, 256-thread blocks, state in registers, the
    per-point dts a host table passed by value, the parameters a device
    float32 vector (K1's :func:`~.heston_qe.kernel_inputs`), no host sync.
  * Bound by issue slots (the draws, the transcendentals, the divisions),
    but ``no-draws``, which is bound by its 8 bytes per path and point.
  * Draws: Philox4x32-10 keyed (seed + generation, phase).  The rungs but
    the batched ones take three words of the call at K1's counter (path,
    point * num_steps + k, 0, 0); ``qe-batched-prng`` and ``qe-combined``
    take a point's 3 * num_steps words from ceil(3 * num_steps / 4) calls
    at counter (path, point, call, :data:`LANE_BATCHED`), substep k the
    words 3k .. 3k+2.
  * ``generation`` stands for the TPU script's per-program seed offset
    (``make_kernel(seed_off)``): back-to-back launches draw different
    streams, so the k launches of ``tools/kernel_decomposition.py``
    repeat no work.
  * Built without FMA contraction and without fast math, so on the card it
    rounds op for op like :func:`heston_ladder_paths_reference`.

:func:`heston_ladder_paths` dispatches on the device of ``params``: CUDA
tensors launch the kernel (or raise), CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import (
    MAX_POINTS,
    _point_dts,
    heston_qe_substep,
    kernel_inputs,
)

# The JAX script's variant names (benchmarks/kernel_decomposition.py:281-291),
# in the kernel's rung order.
RUNGS = ("no-draws", "raw-bits-x3", "box-muller", "icdf", "qe-full", "qe-icdf",
         "qe-batched-prng", "qe-algebra", "qe-combined")
BATCHED = ("qe-batched-prng", "qe-combined")
# Counter word 3 of the batched rungs' calls: a lane no other stream uses.
LANE_BATCHED = 3

# Giles' single-precision erfinv polynomials (kernel_decomposition.py:92-102),
# highest degree first.
_ICDF_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 2.1858087e-04, -1.25372503e-03, -4.17768164e-03, 2.46640727e-01,
                 1.50140941e+00)
_ICDF_TAIL = (-2.00214257e-04, 1.00950558e-04, 1.34934322e-03, -3.67342844e-03,
              5.73950773e-03, -7.62246130e-03, 9.43887047e-03, 1.00167406e+00,
              2.83297682e+00)


def _horner(coeffs, t):
    p = torch.full_like(t, coeffs[0])
    for c in coeffs[1:]:
        p = p * t + c
    return p


def normal_icdf(u):
    """N(0, 1) quantile of ``u`` through Giles' single-precision erfinv
    polynomial, z = sqrt(2) erfinv(2u - 1), op for op as ``_normal_icdf``
    (kernel_decomposition.py:82) and the kernel, which evaluates only the
    branch its thread takes."""
    x = 2.0 * u - 1.0
    w = -torch.log((1.0 - x) * (1.0 + x))
    central = _horner(_ICDF_CENTRAL, w - 2.5)
    tail = _horner(_ICDF_TAIL, torch.sqrt(w) - 3.0)
    return torch.where(w < 5.0, central, tail) * math.sqrt(2.0) * x


def heston_qe_substep_algebra(log_s, v, z_s, z_v, u, dt, sigma, rate, rho, kappa, theta):
    """The division-reduced QE update of ``_heston_qe_substep_algebra``
    (kernel_decomposition.py:160): p = (s2 - m2) / (s2 + m2) and the branch
    s2 > 1.5 m2, no psi = s2 / m2; hard branches.  The same map as
    :func:`~.heston_qe.heston_qe_substep` up to where the psi test rounds."""
    return heston_qe_substep(log_s, v, z_s, z_v, u, dt, sigma, rate, rho, kappa, theta,
                             algebra=True)


def ladder_substep(rung: str, log_s, v, words, dt, sigma, rate, rho, kappa, theta):
    """One substep of ``rung`` on its three draw words ``words`` (int64
    tensors holding uint32; unused by ``no-draws``): the kernel's
    ``substep<kRung>``, op for op."""
    if rung == "no-draws":
        return log_s * 0.9999 + 1e-6, v * 0.9999 + 1e-6
    w0, w1, w2 = words
    if rung == "raw-bits-x3":
        x = w0 ^ w1 ^ w2
        step = (x - ((x >> 31) << 32)).to(log_s.dtype) * 1e-12  # the xor read as int32
        return log_s + step, v + step
    u1, u2, u = (rng.uniform_from_word(w, log_s.dtype) for w in words)
    if rung in ("icdf", "qe-icdf"):
        z1, z2 = normal_icdf(u1), normal_icdf(u2)
    else:
        z1, z2 = rng.box_muller(u1, u2)
    if rung in ("box-muller", "icdf"):
        return log_s + (z1 + z2) * 1e-3, v + u * 1e-3
    return heston_qe_substep(log_s, v, z1, z2, u, dt, sigma, rate, rho, kappa, theta,
                             algebra=rung in ("qe-algebra", "qe-combined"))


def point_words(rung: str, seed: int, phase: int, generation: int, point: int,
                num_steps: int, num_paths: int, device):
    """The three draw words of each of the ``num_steps`` substeps of one
    point, [(w0, w1, w2)] of [num_paths] int64 tensors; [] for ``no-draws``."""
    if rung == "no-draws":
        return []
    key = ((seed + generation) & 0xFFFFFFFF, phase)
    paths = torch.arange(num_paths, dtype=torch.int64, device=device)
    word = lambda x: torch.full((), int(x) & 0xFFFFFFFF, dtype=torch.int64, device=device)
    if rung not in BATCHED:
        return [rng.philox4x32_10((paths, word(point * num_steps + k), word(0), word(0)),
                                  key)[:3] for k in range(num_steps)]
    flat = []
    for call in range(-(-3 * num_steps // 4)):
        flat.extend(rng.philox4x32_10((paths, word(point), word(call), word(LANE_BATCHED)),
                                      key))
    return [tuple(flat[3 * k:3 * k + 3]) for k in range(num_steps)]


def _check_args(rung, params, timeline, num_paths, num_steps, generation):
    if rung not in RUNGS:
        raise ValueError(f"unknown rung {rung!r}; the rungs are {RUNGS}")
    if len(params) != 7:
        raise ValueError("heston_ladder_paths expects the 7 Heston parameters")
    if num_steps < 1 or not 0 < num_paths < 2 ** 32 or generation < 0:
        raise ValueError(f"bad num_steps={num_steps} / num_paths={num_paths} / "
                         f"generation={generation}")
    if len(timeline) > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} timeline points, got {len(timeline)}")


def heston_ladder_paths_reference(rung: str, params, timeline: Sequence[float], num_paths: int,
                                  num_steps: int, seed: int = 0, phase: int = 0,
                                  generation: int = 0):
    """Plain PyTorch version of the kernel's ``rung``, float32, on the device
    of ``params`` (spot, sigma, rate, rho, kappa, theta, v0): states
    [T, N, 2] (log S, v).  Same Philox words, same stages, same order of
    operations; points with a zero dt repeat the state, as K1's do."""
    _check_args(rung, params, timeline, num_paths, num_steps, generation)
    spot, sigma, rate, rho, kappa, theta, v0 = (p.detach().to(torch.float32) for p in params)
    log_s = torch.log(spot).expand(num_paths)
    v = v0.expand(num_paths)
    states = []
    for point, dt in enumerate(_point_dts(timeline, 0.0, num_steps)):
        if dt > 0.0:
            words = point_words(rung, seed, phase, generation, point, num_steps, num_paths,
                                spot.device)
            for k in range(num_steps):
                log_s, v = ladder_substep(rung, log_s, v, words[k] if words else None, dt,
                                          sigma, rate, rho, kappa, theta)
        states.append(torch.stack([log_s, v], dim=-1))
    return torch.stack(states)


# mcre_heston_ladder's arguments.
_ARGS = (
    ctypes.c_int, ctypes.c_void_p,                       # rung, states
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # dts, points, steps
    ctypes.c_uint32,                                     # num_paths
    ctypes.c_void_p,                                     # params [7] f32
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,   # seed, phase, generation
    ctypes.c_void_p,                                     # stream
)


def _launch(rung, params, timeline, num_paths, num_steps, seed, phase, generation):
    fn = cuda_build.bind(cuda_build.load_library("heston_ladder").lib, "mcre_heston_ladder", _ARGS)
    device = params[0].device
    n_pts = len(timeline)
    states = torch.empty((n_pts, num_paths, 2), dtype=torch.float32, device=device)
    if n_pts:
        prm, table = kernel_inputs(params, timeline, num_steps)
        with torch.cuda.device(device):
            rc = fn(RUNGS.index(rung), states.data_ptr(), ctypes.cast(table, ctypes.c_void_p),
                    n_pts, num_steps, num_paths, prm.data_ptr(), seed & 0xFFFFFFFF,
                    phase & 0xFFFFFFFF, generation & 0xFFFFFFFF,
                    torch.cuda.current_stream(device).cuda_stream)
        cuda_build.check(rc, "heston_ladder_paths")
        heston_ladder_paths.rung_launches[rung] += 1
    return states


def heston_ladder_paths(rung: str, params, timeline: Sequence[float], num_paths: int,
                        num_steps: int, seed: int = 0, phase: int = 0, generation: int = 0):
    """Heston states of one ladder rung at timeline points: [T, N, 2] float32
    (log S, v).  CUDA ``params`` launch the kernel; CPU ``params`` run
    :func:`heston_ladder_paths_reference`."""
    _check_args(rung, params, timeline, num_paths, num_steps, generation)
    device = params[0].device
    if device.type == "cpu":
        return heston_ladder_paths_reference(rung, params, timeline, num_paths, num_steps,
                                             seed=seed, phase=phase, generation=generation)
    if device.type != "cuda":
        raise ValueError(f"heston_ladder_paths: unsupported device {device}")
    return _launch(rung, params, timeline, num_paths, num_steps, seed, phase, generation)


heston_ladder_paths.rung_launches = dict.fromkeys(RUNGS, 0)  # kernel launches by rung
