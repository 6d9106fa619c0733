"""Order statistics over path vectors.

Counterpart of ``montecarlo_risk_engine_tpu/ops/quantile.py``:

  * :func:`quantile_order_statistic`, the reference convention
    ``sorted[ceil(q N) - 1]`` (pfe_metric.py:59-66), by a sort;
  * :func:`order_statistics_bisect`, the same order statistics by bisection
    on the value range: only comparisons and count reductions, no sort.  The
    PFE metric takes it above ``PFE_BISECT_THRESHOLD`` paths, as the JAX
    package does;
  * :func:`quantile_bisect`, the reference convention by that bisection.

Both are plain torch ops; neither needs a kernel of its own.  Under a
path sharding the bisection counts every rank's samples (integer sums, exact
in any order) and takes the extrema and the final snap across the ranks
(exact selections), so each rank finds the order statistic of the whole run.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from montecarlo_risk_engine_tpu_torch.parallel.collectives import rank_max, rank_min, rank_sum


def quantile_order_statistic(values: torch.Tensor, q: float) -> torch.Tensor:
    """``sorted(values)[ceil(q N) - 1]`` over the last axis."""
    idx = int(math.ceil(q * values.shape[-1])) - 1
    return torch.sort(values, dim=-1).values[..., idx]


def order_statistics_bisect(values: torch.Tensor, ks: Sequence[int], iters: int = 96,
                            sharding=None) -> torch.Tensor:
    """Exact k-th order statistics (0-indexed) of ``values`` [..., N] along
    the last axis for every k in ``ks``: returns [K, ...].  With a
    ``sharding`` the last axis is this rank's share of the paths and k
    indexes the whole run's.

    Bisection keeps ``lo < x_(k) <= hi`` with "count of samples <= mid"
    reductions, then snaps to the smallest sample above ``lo``, which is
    x_(k) once the bracket is tighter than the sample spacing (quantile.py:
    30-85).  The search runs on detached values; derivatives flow through
    the final snap, the selection gradient of a sort."""
    values_ng = values.detach()
    k_plus_1 = torch.as_tensor([k + 1 for k in ks], device=values.device).reshape(
        (-1,) + (1,) * (values.dim() - 1))
    lo0 = rank_min(values_ng.amin(dim=-1), sharding)
    hi0 = rank_max(values_ng.amax(dim=-1), sharding)
    eps = torch.finfo(values.dtype).eps
    span = torch.clamp(hi0 - lo0, min=1.0)
    lo0 = lo0 - torch.maximum(span, lo0.abs()) * eps
    shape = (len(ks),) + tuple(lo0.shape)
    lo, hi = lo0.expand(shape), hi0.expand(shape)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        count = rank_sum((values_ng[None] <= mid[..., None]).sum(dim=-1), sharding)
        go_left = count >= k_plus_1
        lo, hi = torch.where(go_left, lo, mid), torch.where(go_left, mid, hi)
    inf = torch.full((), math.inf, dtype=values.dtype, device=values.device)
    return rank_min(torch.where(values[None] > lo[..., None], values[None], inf).amin(dim=-1),
                    sharding)


def quantile_bisect(values: torch.Tensor, q: float, iters: int = 96) -> torch.Tensor:
    """``sorted(values)[ceil(q N) - 1]`` over the last axis by
    :func:`order_statistics_bisect` (JAX quantile.py:88-96): the convention
    of :func:`quantile_order_statistic` without a sort."""
    k = int(math.ceil(q * values.shape[-1])) - 1
    return order_statistics_bisect(values, [k], iters=iters)[0]
