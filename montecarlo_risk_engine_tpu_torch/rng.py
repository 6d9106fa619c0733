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
Every draw is a pure function of (seed, phase, path, substep), so pre-sim and
main-sim streams never collide and a path's draws do not depend on how many
paths the run has.

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


def substep_draws(seed: int, phase: int, counter: int, num_paths: int,
                  dtype: torch.dtype, device):
    """(z_s, z_v, u) for one substep of every path, each [num_paths].

    The stream of the CUDA path kernel: Philox words at counter
    (path, counter, 0, 0) under key (seed, phase)."""
    paths = torch.arange(num_paths, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    step = torch.full((), int(counter) & _MASK32, dtype=torch.int64, device=device)
    w0, w1, w2, _ = philox4x32_10((paths, step, zero, zero), (seed, phase))
    z_s, z_v = box_muller(uniform_from_word(w0, dtype), uniform_from_word(w1, dtype))
    return z_s, z_v, uniform_from_word(w2, dtype)
