"""Philox4x32-10 and the normals of one substep, in plain torch.

A frozen copy of the stream the port's path kernel documents
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11):
key (seed, phase); call ``c`` of a substep at counter (path, substep, c, 0)
gives four words, each pair of words one Box-Muller pair; a word's uniform
is ((w >> 8) + 0.5) / 2^24, clamped below 1.  Phases: 42 the
pre-simulation, 43 the main simulation.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

PHASE_PRESIM = 42
PHASE_MAINSIM = 43

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
TWO_PI = 2.0 * math.pi
U_MAX = 1.0 - 2.0 ** -24


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low words of a * b for uint32 values held in int64 (b split
    into 16-bit halves so no product overflows)."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo, p_hi = a * b_lo, a * b_hi
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & _MASK32, mid & _MASK32


def philox(counter, key):
    """Philox4x32-10 of four int64 counter words under a key of two ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.clamp((word >> 8).to(dtype) * 2.0 ** -24 + 2.0 ** -25, max=U_MAX)


def normals(seed: int, phase: int, substep: int, paths: torch.Tensor, count: int,
            dtype: torch.dtype) -> torch.Tensor:
    """[len(paths), count] standard normals of one substep for the given
    global path indices (int64), computed in ``dtype``; an odd count takes
    the cosine half of its last pair."""
    dev = paths.device
    word = lambda v: torch.full((), int(v) & _MASK32, dtype=torch.int64, device=dev)
    cols = []
    for call in range(-(-count // 4)):
        w = philox((paths, word(substep), word(call), word(0)), (seed, phase))
        for pair in range(2):
            if len(cols) >= count:
                break
            r = torch.sqrt(-2.0 * torch.log(uniform(w[2 * pair], dtype)))
            theta = uniform(w[2 * pair + 1], dtype) * TWO_PI
            cols.append(r * torch.cos(theta))
            if len(cols) < count:
                cols.append(r * torch.sin(theta))
    return torch.stack(cols, dim=-1)
