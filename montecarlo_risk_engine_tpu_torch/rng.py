"""Counter-based random streams: Philox4x32-10 in plain torch.

Counterpart of ``montecarlo_risk_engine_tpu/rng.py``.  The JAX package folds
a threefry key per (phase, step, purpose); the port uses Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11), the
generator the CUDA path kernel (``csrc/heston_qe.cu``) runs in registers, so
the plain version and the kernel draw the same words:

  * key     = (seed, phase)
  * counter = (path index, point_idx * num_steps + substep, 0, 0)

One Philox call per path-substep gives four 32-bit words: words 0 and 1 feed
a Box-Muller pair (the correlated driver normals), word 2 the QE uniform.
Models with more noise factors (``sim_dim > 2``, the hybrid books) make call
number ``c`` at counter (path, substep, c, 0) for normals ``4c .. 4c+3``:
words 0/1 and 2/3 each feed one Box-Muller pair (:func:`substep_normals`).
For ``sim_dim <= 2`` those are exactly the normals of :func:`substep_draws`.
A model with a uniform beside more than 2 normals (Heston QE in a
ModelConfig) takes it from word 0 of the call at counter (path, substep, 0,
1) (:func:`substep_uniform`): the normals only ever use counter word 3 = 0,
so the lanes never meet.  The Sobol sampler's digital shift is word 0 at
(dimension, 0, 0, 2) (:func:`qmc_shift`), once per phase.
Every draw is a pure function of (seed, phase, path, substep), so pre-sim and
main-sim streams never collide and a path's draws do not depend on how many
paths the run has.  The path-indexed draws take a ``path_offset`` and a
``path_stride``: local path i is global path ``path_offset + path_stride *
i`` (a rank of a path-sharded run, parallel/mesh.py), so a rank draws its
own paths' numbers; (0, 1) is the whole run.

Torch has no 32x32->64 multiply-high and int64 products of two 32-bit words
overflow, so :func:`_mulhilo` splits one factor into 16-bit limbs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# Phase identifiers (the key's second word).
PHASE_PRESIM = 42       # reference pre-simulation seed (engine.py:25)
PHASE_MAINSIM = 43      # reference main-simulation seed (engine.py:25)
PHASE_BRIDGE = 12345    # barrier Brownian-bridge stream (barrier_option.py:50)

# Purpose identifiers: which output words of the per-substep Philox call
# carry the draw.
PURPOSE_NORMAL = 0      # words 0 and 1 -> Box-Muller pair
PURPOSE_UNIFORM = 1     # word 2 -> QE exp-mixture uniform (heston.py:192)
PURPOSE_QMC_SHIFT = 2   # counter word 3 of the Sobol digital-shift lane
# Counter word 3 of the uniform beside more than 2 normals.
LANE_UNIFORM = 1

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_TWO_PI = 2.0 * math.pi
# Largest float32 below 1: the top uniform code (2^24 - 0.5) / 2^24 rounds to
# 1.0 in float32, so every dtype clamps it here and u stays inside (0, 1).
U_MAX = 1.0 - 2.0 ** -24


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of constant ``a`` and
    int64 tensor ``b`` holding uint32 values, without int64 overflow."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    p_lo = a * b_lo                     # < 2^48
    p_hi = a * b_hi                     # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    lo = mid & _MASK32
    hi = ((p_hi >> 16) + (mid >> 32)) & _MASK32
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 words.

    ``counter``: 4 broadcastable int64 tensors; ``key``: 2 Python ints.
    Returns the 4 output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_word(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U(0,1) from a 32-bit word: ((w >> 8) + 0.5) / 2^24, the mapping of the
    TPU kernel's ``_uniforms`` (pallas_paths.py:61), clamped below 1."""
    top24 = (word >> 8).to(dtype)
    return torch.clamp(top24 * 2.0 ** -24 + 2.0 ** -25, max=U_MAX)


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """Two independent N(0,1) draws (pallas_paths.py:70)."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = u2 * _TWO_PI
    return r * torch.cos(theta), r * torch.sin(theta)


def path_index(num_paths: int, path_offset: int, path_stride: int, device) -> torch.Tensor:
    """Global indices ``path_offset + path_stride * i`` of local paths
    0 .. num_paths - 1, int64 [num_paths]."""
    return torch.arange(num_paths, dtype=torch.int64, device=device) * path_stride + path_offset


def check_path_stride(num_paths: int, path_offset: int, path_stride: int) -> None:
    """Local paths 0 .. num_paths - 1 are global paths ``path_offset +
    path_stride * i``, each a 32-bit Philox counter word."""
    if path_stride < 1 or path_offset < 0 or (
            path_offset + path_stride * (num_paths - 1) >= 2 ** 32):
        raise ValueError(f"bad path_offset={path_offset} / path_stride={path_stride} for "
                         f"{num_paths} paths")


def substep_draws(seed: int, phase: int, counter: int, num_paths: int,
                  dtype: torch.dtype, device, path_offset: int = 0, path_stride: int = 1):
    """(z_s, z_v, u) for one substep of every path, each [num_paths].

    The stream of the CUDA path kernel: Philox words at counter
    (path, counter, 0, 0) under key (seed, phase)."""
    paths = path_index(num_paths, path_offset, path_stride, device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    step = torch.full((), int(counter) & _MASK32, dtype=torch.int64, device=device)
    w0, w1, w2, _ = philox4x32_10((paths, step, zero, zero), (seed, phase))
    z_s, z_v = box_muller(uniform_from_word(w0, dtype), uniform_from_word(w1, dtype))
    return z_s, z_v, uniform_from_word(w2, dtype)


def bridge_uniforms(product_id: int, barrier_idx: int, num_paths: int, num_intervals: int,
                    dtype: torch.dtype, device, path_offset: int = 0,
                    path_stride: int = 1) -> torch.Tensor:
    """[num_paths, num_intervals] uniforms of a barrier's Brownian-bridge
    crossing test: word 0 of the Philox call at counter (product id, barrier
    index, path, interval) under key (0, PHASE_BRIDGE).  The stream is
    keyed by seed 0, not by the run's root seed, as the JAX package keys its
    bridge stream by ``root_key(0)`` (barrier_option.py:189)."""
    paths = path_index(num_paths, path_offset, path_stride, device)[:, None]
    intervals = torch.arange(num_intervals, dtype=torch.int64, device=device)[None, :]
    word = lambda v: torch.full((), int(v) & _MASK32, dtype=torch.int64, device=device)
    w0, _, _, _ = philox4x32_10((word(product_id), word(barrier_idx), paths, intervals),
                                (0, PHASE_BRIDGE))
    return uniform_from_word(w0.expand(num_paths, num_intervals), dtype)


def substep_normals(seed: int, phase: int, counter: int, num_paths: int, sim_dim: int,
                    dtype: torch.dtype, device, path_offset: int = 0,
                    path_stride: int = 1) -> torch.Tensor:
    """``sim_dim`` standard normals for one substep of every path, [N, sim_dim].

    Call ``c`` at counter (path, counter, c, 0) gives normals 4c .. 4c+3:
    (w0, w1) -> (r cos, r sin), then (w2, w3) likewise; the stream of the
    hybrid path kernel (csrc/hybrid_paths.cu).  Only the normals asked for
    are computed, so an odd ``sim_dim`` takes the cosine half of its last
    pair."""
    paths = path_index(num_paths, path_offset, path_stride, device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    step = torch.full((), int(counter) & _MASK32, dtype=torch.int64, device=device)
    cols = []
    for call in range(-(-sim_dim // 4)):
        words = philox4x32_10(
            (paths, step, torch.full((), call, dtype=torch.int64, device=device), zero),
            (seed, phase))
        for pair in range(2):
            if len(cols) >= sim_dim:
                break
            u1 = uniform_from_word(words[2 * pair], dtype)
            u2 = uniform_from_word(words[2 * pair + 1], dtype)
            r = torch.sqrt(-2.0 * torch.log(u1))
            theta = u2 * _TWO_PI
            cols.append(r * torch.cos(theta))
            if len(cols) < sim_dim:
                cols.append(r * torch.sin(theta))
    return torch.stack(cols, dim=-1)


def substep_uniform(seed: int, phase: int, counter: int, num_paths: int,
                    dtype: torch.dtype, device, path_offset: int = 0,
                    path_stride: int = 1) -> torch.Tensor:
    """[num_paths] uniforms for one substep from a lane of their own: word 0
    of the Philox call at counter (path, counter, 0, LANE_UNIFORM).  The
    normals of :func:`substep_normals` take counter word 3 = 0, so this
    stream is disjoint from them for any ``sim_dim``."""
    paths = path_index(num_paths, path_offset, path_stride, device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    step = torch.full((), int(counter) & _MASK32, dtype=torch.int64, device=device)
    lane = torch.full((), LANE_UNIFORM, dtype=torch.int64, device=device)
    w0, _, _, _ = philox4x32_10((paths, step, zero, lane), (seed, phase))
    return uniform_from_word(w0, dtype)


def qmc_shift(seed: int, phase: int, num_dims: int, device="cpu") -> torch.Tensor:
    """[num_dims] 32-bit digital-shift words of the Sobol sampler (int64 in
    [0, 2^32)): word 0 of the Philox call at counter (dimension, 0, 0,
    PURPOSE_QMC_SHIFT) under key (seed, phase), so the pre-simulation and
    main-simulation shifts differ and no path draw shares the lane (the JAX
    package draws them from threefry, rng.py:51-61)."""
    dims = torch.arange(num_dims, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    lane = torch.full((), PURPOSE_QMC_SHIFT, dtype=torch.int64, device=device)
    w0, _, _, _ = philox4x32_10((dims, zero, zero, lane), (seed, phase))
    return w0
