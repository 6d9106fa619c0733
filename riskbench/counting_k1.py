"""Work of the Heston QE path kernel K1, counted from a launch's shapes.

As in ``counting.py``: the least time a launch could take is the larger of
its bytes over the card's memory rate and its operations over its float32
rate, both from what the launch is asked for (its timeline, substeps and
paths, and whether it writes its draws), never from the kernel's source.

Operations per path-substep, frozen from the bring-up smoke's count: one
Philox4x32-10 call (98), three uniforms from its words (3 x 5), one
Box-Muller pair (8) and the QE update (52), one operation per float or
integer add, multiply, compare, select, conversion, division or
transcendental call.  Bytes: the [T, N, 2] float32 states (log S, v)
written once; the noise-emitting build, run on the substep-dense timeline,
also writes its draws z [T, N, 2] and u [T, N].
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

from riskbench import book, counting

QE_UPDATE_OPS = 52
OPS_PER_SUBSTEP = (counting.PHILOX_OPS + 3 * counting.UNIFORM_OPS + counting.BM_PAIR_OPS
                   + QE_UPDATE_OPS)
STATE_BYTES = 2 * 4   # (log S, v) float32 per path and point
NOISE_BYTES = 3 * 4   # (z_s, z_v, u) float32 per path and point


class Launch(NamedTuple):
    """One K1 launch: its timeline (no calibration date), substeps per
    point, paths, and whether it writes its draws."""

    timeline: Tuple[float, ...]
    num_steps: int
    num_paths: int
    emit: bool = False


def ops(launch: Launch) -> float:
    return float(launch.num_paths) * counting.live_substeps(launch.timeline, launch.num_steps) \
        * OPS_PER_SUBSTEP


def nbytes(launch: Launch) -> float:
    per_point = STATE_BYTES + (NOISE_BYTES if launch.emit else 0)
    return float(len(launch.timeline)) * launch.num_paths * per_point


def least_seconds(launch: Launch) -> Tuple[float, str]:
    return counting.bound(nbytes(launch), ops(launch))


def dense(timeline: Tuple[float, ...], num_steps: int) -> Tuple[float, ...]:
    """Every substep boundary of the timeline a point (the noise-emitting
    launch's timeline, one substep a point)."""
    out, t_prev = [], 0.0
    for t in timeline:
        if t > t_prev:
            out += [t_prev + (t - t_prev) * k / num_steps for k in range(1, num_steps)]
        out.append(t)
        t_prev = t
    return tuple(out)


def launches(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> List[Launch]:
    """K1's launches of one run of a European book (no pre-simulation): the
    forward launch at the book's dates, or, differentiated, the emitting
    launch on the substep-dense timeline."""
    dates = tuple(sorted({float(p["exercise_date"]) for ns in book.netting_set_products(cfg)
                          for p in ns}))
    n, steps = int(traffic["num_paths"]), int(cfg["num_steps"])
    if traffic["differentiate"]:
        return [Launch(dense(dates, steps), 1, n, True)]
    return [Launch(dates, steps, n)]
