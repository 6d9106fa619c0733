"""The path kernels on one rank of a path-sharded run.

Counterpart of ``montecarlo_risk_engine_tpu/ops/pallas_shard.py``.  The JAX
package runs its Pallas kernels per device under ``shard_map`` at a global
block offset and reassembles the sharded plane.  Here each rank launches K1
or K2 once, for its own paths: row i of its launch draws global path ``rank +
world_size * i`` (the cyclic layout of parallel/mesh.py), and its output is
its own [T, num_paths / R, D] plane.  Nothing is reassembled: every later
reduction over the paths goes through parallel/collectives.py.

:func:`shard_paths` is generic over the per-rank path function, so the
layout is testable with a deterministic stand-in for a kernel on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathSharding, local_paths


def shard_paths(path_fn: Callable, params, sharding: Optional[PathSharding], num_paths: int):
    """``path_fn(params, local_paths, path_offset, path_stride)`` for this
    rank: its share of ``num_paths`` (all of them without a sharding)."""
    n, offset, stride = local_paths(num_paths, sharding)
    return path_fn(params, n, offset, stride)


def sharded_kernel_paths(model, params, scheme, timeline, num_paths: int, num_steps: int,
                         seed: int, phase: int, sharding: Optional[PathSharding]):
    """This rank's kernel states, [T, num_paths / R, D] float32."""
    return shard_paths(
        lambda p, n, offset, stride: model.kernel_paths(
            p, scheme, timeline, n, num_steps, seed=seed, phase=phase, path_offset=offset,
            path_stride=stride),
        params, sharding, num_paths)


def sharded_kernel_paths_with_noise(model, params, scheme, timeline, num_paths: int, seed: int,
                                    phase: int, sharding: Optional[PathSharding]):
    """This rank's noise-emitting kernel forward (states [T, n, D], z [T, n,
    sim_dim], u [T, n]) for the emitted-noise AD route, n = num_paths / R."""
    return shard_paths(
        lambda p, n, offset, stride: model.kernel_paths_with_noise(
            p, scheme, timeline, n, seed=seed, phase=phase, path_offset=offset,
            path_stride=stride),
        params, sharding, num_paths)
