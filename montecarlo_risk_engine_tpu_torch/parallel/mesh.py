"""The path mesh: which rank owns which Monte Carlo paths.

Counterpart of ``montecarlo_risk_engine_tpu/parallel/mesh.py``.  The JAX
package shards the path axis of every [num_paths, ...] array over a 1-D
device mesh and lets XLA insert the collectives.  Here each
``torch.distributed`` rank runs the whole program on its own share of the
paths, and every path-axis reduction goes through ``parallel/collectives.py``.

The layout is cyclic: rank r of R owns the global paths r, r + R, r + 2R, ...
(``offset + stride * local`` with offset r and stride R), and holds them in
that order as its own contiguous [num_paths / R] axis.  Two facts make it the
layout of this port, not the JAX package's contiguous blocks:

  * every draw is a pure function of the global path index (the Philox
    counter of ``rng.py`` and of the path kernels, the Sobol point index), so
    a rank draws its paths' numbers by their global indices;
  * ``metrics.fixed_tree_sum`` halves the (zero-padded, power-of-two p) path
    axis from the top, adding index i + p/2 onto i.  Its first log2(p / R)
    halvings pair indices that differ by a multiple of R, which lie on one
    rank: a rank's own tree sum over its paths, padded to p / R, is exactly
    the subtree of the global tree that holds them, and a tree sum of the R
    partials in rank order is the global sum, bit for bit.  Contiguous blocks
    do not have this property.

So R must be a power of two that divides the path count; under antithetic
sampling it must divide half of it (the mirror of path i is i + N/2, on the
same rank).

Usage (every rank, after ``parallel.distributed.initialize``):

    sharding = path_sharding(make_path_mesh())
    sc = SimulationController(..., path_sharding=sharding)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

PATH_AXIS = "paths"


def pad_to_multiple(n: int, devices: int) -> int:
    """Smallest path count >= n divisible by the device count."""
    return ((n + devices - 1) // devices) * devices


@dataclass(frozen=True)
class PathMesh:
    """A 1-D mesh of ranks over the paths axis: this process's rank in
    ``group``, the group's size and the device its tensors live on."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None  # None: the default process group


def make_path_mesh(group=None, device: Union[None, str, torch.device] = None) -> PathMesh:
    """The mesh of ``group`` (the default process group when None), which
    must be initialised.  ``device``: where this rank's tensors live (the
    current card when None)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.distributed.initialize first")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return PathMesh(rank=dist.get_rank(group), world_size=dist.get_world_size(group),
                    device=torch.device(device), group=group)


@dataclass(frozen=True)
class PathSharding:
    """This rank's share of every path axis: global path ``rank + world_size
    * i`` is its local path i (see the module docstring)."""

    mesh: PathMesh

    def __post_init__(self):
        w = self.mesh.world_size
        if w < 1 or w & (w - 1):
            raise ValueError(f"the path mesh needs a power-of-two number of ranks, got {w}")

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def world_size(self) -> int:
        return self.mesh.world_size

    @property
    def group(self):
        return self.mesh.group

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def local_count(self, num_paths: int, antithetic: bool = False) -> int:
        """This rank's path count; raises unless the ranks divide
        ``num_paths`` (half of it under antithetic pairs)."""
        num_paths = int(num_paths)
        w = self.world_size
        if num_paths % w:
            raise ValueError(f"num_paths {num_paths} not divisible by {w} devices")
        if antithetic and (num_paths // 2) % w:
            raise ValueError(f"num_paths / 2 = {num_paths // 2} (antithetic pairs) not "
                             f"divisible by {w} devices")
        return num_paths // w

    def global_indices(self, num_paths: int, device=None) -> torch.Tensor:
        """The global indices of this rank's paths, [num_paths / world_size]."""
        return torch.arange(self.rank, int(num_paths), self.world_size, dtype=torch.int64,
                            device=device)


def path_sharding(mesh: PathMesh) -> PathSharding:
    """The sharding that places the paths axis cyclically across ``mesh``."""
    return PathSharding(mesh)


def local_paths(num_paths: int, sharding: Optional[PathSharding], antithetic: bool = False):
    """(local count, global path offset, global path stride) of this rank;
    (num_paths, 0, 1) without a sharding."""
    if sharding is None:
        return int(num_paths), 0, 1
    return sharding.local_count(num_paths, antithetic), sharding.rank, sharding.world_size
