"""The path-axis collectives of a sharded run, under every transform.

A helper of the port (the JAX package lets XLA insert psums).  Every
reduction over the paths axis of a sharded run is a rank-local reduction
followed by one of these, so that its result is the same on every rank and,
for the fixed-order tree sums of ``metrics.fixed_tree_sum``, the same bits as
on one rank (parallel/mesh.py says why the cyclic layout makes that so).

One primitive moves data: :func:`gather` stacks every rank's tensor into an
[R, ...] tensor in rank order.  It is an ``all_reduce(SUM)`` of a tensor in
which this rank fills only its own slot and the others hold -0.0: x + (-0.0)
is x for every x, -0.0 included (a +0.0 fill would turn a -0.0 into +0.0), and
``all_reduce`` is the one collective that both gloo (CUDA tensors of ranks
that share a card, or CPU tensors) and NCCL provide.  Its adjoint,
:func:`_Scatter`, sums an [R, ...] tensor over the ranks and keeps this
rank's slot.  Sums over ranks (:func:`sum_over_ranks`) are tree sums of the
gathered rows; counts and extrema (:func:`rank_sum`, :func:`rank_min`,
:func:`rank_max`) reduce the gathered rows in any order, exactly.

Differentiation.  Parameters are replicated; a path's share of a result is
rank-local.  Forward mode needs nothing more: a tangent is gathered like its
primal (``jvp``), so every rank holds the whole tangent.  In reverse mode the
cotangent of a replicated value is held as *partials* that add up over the
ranks (the controller seeds the values' cotangent on rank 0 and zeros on the
others), so the backward of :func:`gather` sums the cotangent over the ranks
before it takes this rank's slot, and the parameters' gradient is summed over
the ranks at the end (``SimulationController``).  This holds where a
replicated value (a regression fit) feeds every rank's paths again, where a
rank's own slot of a replicated cotangent would not.  Both Functions have a
``vmap`` rule (the collective runs on the batched tensor), a ``jvp`` rule and
``setup_context``, so they compose under ``torch.func.jvp``, ``vmap``,
``vjp`` and ``torch.autograd.grad`` to every order the controller uses.

:data:`stats` counts the calls and the host seconds spent in them.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathSharding

# Collective calls of this process and the host seconds they took (reset by
# the caller).
stats = {"calls": 0, "seconds": 0.0}


def reset_stats() -> None:
    stats["calls"], stats["seconds"] = 0, 0.0


def _all_reduce_sum(buf: torch.Tensor, sharding: PathSharding) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=sharding.group)
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return buf


class _Gather(torch.autograd.Function):
    """x [...] on every rank -> [R, ...], rank r's x in row r."""

    @staticmethod
    def forward(x, sharding):
        # -0.0 (0 for integers) in the other ranks' slots: no bit of x moves
        buf = x.new_full((sharding.world_size,) + tuple(x.shape), -0.0)
        buf[sharding.rank] = x
        return _all_reduce_sum(buf, sharding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sharding = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _Scatter.apply(grad, ctx.sharding), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return _Gather.apply(x_t, ctx.sharding)

    @staticmethod
    def vmap(info, in_dims, x, sharding):
        if in_dims[0] is None:
            return _Gather.apply(x, sharding), None
        return _Gather.apply(x.movedim(in_dims[0], 0), sharding), 1


class _Scatter(torch.autograd.Function):
    """g [R, ...] on every rank -> (sum over ranks of g)[rank], the adjoint
    of :class:`_Gather`."""

    @staticmethod
    def forward(g, sharding):
        buf = _all_reduce_sum(g.contiguous().clone(), sharding)
        return buf[sharding.rank].clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sharding = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.sharding), None

    @staticmethod
    def jvp(ctx, g_t, _):
        return _Scatter.apply(g_t, ctx.sharding)

    @staticmethod
    def vmap(info, in_dims, g, sharding):
        if in_dims[0] is None:
            return _Scatter.apply(g, sharding), None
        return _Scatter.apply(g.movedim(in_dims[0], 1), sharding), 0


def gather(x: torch.Tensor, sharding: PathSharding) -> torch.Tensor:
    """[R, *x.shape]: every rank's ``x`` in rank order, differentiable."""
    return _Gather.apply(x, sharding)


def sum_over_ranks(partial: torch.Tensor, sharding: Optional[PathSharding]) -> torch.Tensor:
    """The tree sum of every rank's ``partial`` (R a power of two: row i + R/2
    onto row i until one is left); ``partial`` itself without a sharding."""
    if sharding is None:
        return partial
    rows = gather(partial, sharding)
    while rows.shape[0] > 1:
        half = rows.shape[0] // 2
        rows = rows[:half] + rows[half:]
    return rows[0]


def rank_sum(x: torch.Tensor, sharding: Optional[PathSharding]) -> torch.Tensor:
    """Sum over ranks of an integer tensor (exact in any order)."""
    return x if sharding is None else gather(x, sharding).sum(0)


def rank_min(x: torch.Tensor, sharding: Optional[PathSharding]) -> torch.Tensor:
    """Elementwise minimum over ranks (exact; the selection's gradient)."""
    return x if sharding is None else gather(x, sharding).amin(0)


def rank_max(x: torch.Tensor, sharding: Optional[PathSharding]) -> torch.Tensor:
    """Elementwise maximum over ranks."""
    return x if sharding is None else gather(x, sharding).amax(0)
