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
Every rank is given its rank, the world size and either an ``init_method``
URL or a ``store``; or, with no rank given, the launcher's environment gives
them, as ``torchrun`` sets it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``; ``init_method="env://"``):

    sharding = distributed.initialize_and_make_sharding()   # under torchrun

With none of those variables set the process is a world of one:
:func:`initialize` does nothing and the sharding is None (an unsharded
run), as the JAX package's ``initialize()`` does for a single process.
"""

from __future__ import annotations

import os
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


LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _launcher_rank() -> Optional[tuple]:
    """(rank, world size, local rank) from the launcher's environment, or
    None when it sets none of :data:`LAUNCHER_VARIABLES` (one process)."""
    if not any(v in os.environ for v in LAUNCHER_VARIABLES):
        return None
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if v not in os.environ]
    if missing:
        raise ValueError(f"the launcher's environment lacks {', '.join(missing)}")
    rank = int(os.environ["RANK"])
    return rank, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", rank))


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, store: Optional[dist.Store] = None,
               device: Union[str, torch.device] = "cuda",
               shared_device: bool = False) -> Optional[str]:
    """Initialise the default process group for this rank and return its
    backend.  ``device``: this rank's device (a CUDA rank's card becomes the
    current device); ``shared_device``: several ranks run on that one card.
    A group that is already initialised is kept if it has this rank and
    world size, and refused otherwise.

    With no ``rank`` the launcher's environment gives the rank, the world
    size and the address (``env://``), and a CUDA ``device`` without an
    index is the card ``LOCAL_RANK``; without that environment this is a
    world of one, nothing is initialised and None is returned."""
    if rank is None:
        if world_size is not None or init_method is not None or store is not None:
            raise ValueError("give the rank with the world size, init_method or store")
        launched = _launcher_rank()
        if launched is None:
            return None
        rank, world_size, local_rank = launched
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", local_rank)
        init_method = "env://"
    elif world_size is None:
        raise ValueError("give the world size with the rank")
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


def initialize_and_make_sharding(rank: Optional[int] = None, world_size: Optional[int] = None,
                                 device="cuda", **kwargs) -> Optional[PathSharding]:
    """:func:`initialize`, then the sharding of the global path mesh; None
    (an unsharded run) for a world of one that no launcher started."""
    if initialize(rank, world_size, device=device, **kwargs) is None:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return path_sharding(global_path_mesh(device))
