"""Process-group set-up for a path-sharded run.

Counterpart of ``montecarlo_risk_engine_tpu/parallel/distributed.py``: the
same script runs on every rank, initialises the group, builds the global path
mesh and hands its sharding to ``SimulationController(path_sharding=...)``:

    from montecarlo_risk_engine_tpu_torch.parallel import distributed
    sharding = distributed.initialize_and_make_sharding(
        rank=r, world_size=R, init_method="tcp://host:port", device=f"cuda:{r}")
    controller = SimulationController(..., path_sharding=sharding)

The backend follows from the arguments alone: NCCL for ranks on distinct
cards, gloo for CPU ranks and for ranks that share one card (NCCL refuses
two ranks on one device; gloo reduces CUDA tensors through the host).
Nothing here reads a launcher's environment: every rank is given its rank,
the world size and either an ``init_method`` URL or a ``store``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from montecarlo_risk_engine_tpu_torch.parallel.mesh import (
    PathMesh,
    PathSharding,
    make_path_mesh,
    path_sharding,
)


def backend_for(device: torch.device, shared_device: bool) -> str:
    """``"nccl"`` for ranks each on a card of its own, else ``"gloo"``."""
    return "nccl" if device.type == "cuda" and not shared_device else "gloo"


def initialize(rank: int, world_size: int, init_method: Optional[str] = None,
               store: Optional[dist.Store] = None,
               device: Union[str, torch.device] = "cuda", shared_device: bool = False) -> str:
    """Initialise the default process group for this rank and return its
    backend.  ``device``: this rank's device (a CUDA rank's card becomes the
    current device); ``shared_device``: several ranks run on that one card.
    A group that is already initialised is kept if it has this rank and
    world size, and refused otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    backend = backend_for(device, shared_device)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise RuntimeError(
                f"torch.distributed is already initialised as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not rank {rank} of {world_size}")
        return dist.get_backend()
    if (init_method is None) == (store is None):
        raise ValueError("give exactly one of init_method and store")
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(init_method=init_method, store=store, **kw)
    return backend


def global_path_mesh(device: Union[None, str, torch.device] = None) -> PathMesh:
    """The path mesh over every rank of the default process group."""
    return make_path_mesh(device=device)


def initialize_and_make_sharding(rank: int, world_size: int, device="cuda", **kwargs) -> PathSharding:
    """:func:`initialize`, then the sharding of the global path mesh."""
    initialize(rank, world_size, device=device, **kwargs)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return path_sharding(global_path_mesh(device))
