"""Work and peaks of the path kernel, counted from a launch's shapes.

The least time a launch could take is the larger of its bytes over the
card's memory rate and its operations over the card's float32 rate.  Both
counts come from what the launch is asked for (its blocks, its correlation,
its timeline, substeps and paths), never from a kernel's source, so they
read the same work whatever implements path generation.

Frozen from the bring-up smoke's ``bound()`` and ``k2_ops()``: one
operation per float or integer add, multiply, compare, select, conversion,
division or transcendental call.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Per path-substep: one Philox4x32-10 call gives four words (10 rounds of
# 2 mul.hi, 2 mul.lo and 4 xor, 9 key bumps of 2 adds); a uniform from a
# word 5; a Box-Muller pair 8, its cosine half alone 6.
PHILOX_OPS, UNIFORM_OPS, BM_PAIR_OPS, BM_COS_OPS = 98, 5, 8, 6
# One noise factor's state update per substep, by (block kind, scheme):
# exact GBM adds (r - s^2/2) dt + s sqrt(dt) w to log S; Euler GBM
# S (1 + r dt) + s S sqrt(dt) w; Vasicek exact and Euler with the bank
# account; CIR++ (one scheme) with psi and the floor; deterministic CIR++;
# Hull-White; the two Schwartz factors.
ROLE_OPS = {
    ("gbm", "exact"): 8, ("gbm", "euler"): 7,
    ("vasicek", "exact"): 7, ("vasicek", "euler"): 9,
    ("cirpp", "exact"): 14, ("cirpp", "euler"): 14,
    ("cirpp_det", "exact"): 2, ("cirpp_det", "euler"): 2,
    ("hw", "exact"): 7, ("hw", "euler"): 10,
    ("s2f_x", "exact"): 3, ("s2f_x", "euler"): 6,
    ("s2f_y", "exact"): 9, ("s2f_y", "euler"): 10,
}
# State columns and noise factors of each block kind (bs_multi: one of each
# per asset).
WIDTHS = {"bs": (1, 1), "vasicek": (2, 1), "cirpp": (2, 1), "cirpp_det": (2, 1), "hw": (2, 1),
          "s2f": (3, 2)}


class Block(NamedTuple):
    """One sub-model of a path launch: kind, "exact" or "euler", assets."""

    kind: str
    scheme: str
    assets: int = 1


class Launch(NamedTuple):
    """One path-generation launch: its blocks, the [F, F] lower Cholesky
    factor of its F noise factors, its timeline (no calibration date),
    substeps per point and paths."""

    blocks: Tuple[Block, ...]
    chol: np.ndarray
    timeline: Tuple[float, ...]
    num_steps: int
    num_paths: int


def roles(blocks: Sequence[Block]) -> List[Tuple[str, str]]:
    """One (role, scheme) per noise factor, in block order."""
    out = []
    for b in blocks:
        if b.kind in ("bs", "bs_multi"):
            out += [("gbm", b.scheme)] * (b.assets if b.kind == "bs_multi" else 1)
        elif b.kind == "s2f":
            out += [("s2f_x", b.scheme), ("s2f_y", b.scheme)]
        else:
            out.append((b.kind, b.scheme))
    return out


def state_dim(blocks: Sequence[Block]) -> int:
    return sum(b.assets if b.kind == "bs_multi" else WIDTHS[b.kind][0] for b in blocks)


def live_substeps(timeline: Sequence[float], num_steps: int, calibration_date: float = 0.0) -> int:
    """Substeps that move: ``num_steps`` for each point after the one before."""
    t_prev, n = calibration_date, 0
    for t in timeline:
        n += num_steps if t > t_prev else 0
        t_prev = t
    return n


def path_ops(launch: Launch) -> float:
    """Operations of one launch: per path-substep the Philox calls, the
    uniforms and Box-Muller pairs of its noise factors, the non-zero
    Cholesky products and their sums, the state updates; per emitted point
    one exp for each exact GBM factor (its state is log S)."""
    rs = roles(launch.blocks)
    n = len(rs)
    nnz = int(np.count_nonzero(np.tril(np.asarray(launch.chol))))
    per_substep = (PHILOX_OPS * -(-n // 4) + UNIFORM_OPS * 2 * -(-n // 2)
                   + BM_PAIR_OPS * (n // 2) + BM_COS_OPS * (n % 2) + nnz + (nnz - n)
                   + sum(ROLE_OPS[r] for r in rs))
    per_point = sum(r == ("gbm", "exact") for r in rs)
    return float(launch.num_paths) * (live_substeps(launch.timeline, launch.num_steps) * per_substep
                                      + len(launch.timeline) * per_point)


def path_bytes(launch: Launch) -> float:
    """Bytes of one launch: its [T, N, D] float32 states written once (the
    parameters and the per-substep table are a few kilobytes)."""
    return float(len(launch.timeline)) * launch.num_paths * state_dim(launch.blocks) * 4


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def least_seconds(launch: Launch) -> Tuple[float, str]:
    return bound(path_bytes(launch), path_ops(launch))
