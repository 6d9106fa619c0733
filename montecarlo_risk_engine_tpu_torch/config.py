"""Global configuration: dtype policy, device choice and simulation-scheme enum.

PyTorch counterpart of ``montecarlo_risk_engine_tpu/config.py``.

  * The working dtype defaults to float64, the precision the JAX package runs
    with under ``jax_enable_x64`` (its tests and the reference's contract);
    :func:`set_real_dtype` changes it for every later call (``None`` restores
    float64).  Every module asks :func:`real_dtype` when it creates a tensor,
    none caches it.  The path kernels themselves are float32
    (``ops/heston_qe.py``, ``ops/hybrid_paths.py``); their outputs are cast to
    the working dtype, as the JAX controller does.
  * Placement is an explicit ``torch.device``: the controller and the engine
    take a ``device`` argument.  The default is the card: :func:`resolve_device`
    maps ``None`` to CUDA and raises when CUDA is absent, so a run takes the
    CPU only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import enum
from typing import Union

import torch


_dtype_override = None


def set_real_dtype(dtype) -> None:
    """Force the working float dtype (e.g. ``torch.float32``); ``None``
    restores float64 (JAX config.py:27)."""
    global _dtype_override
    _dtype_override = None if dtype is None else torch.empty((), dtype=dtype).dtype


def real_dtype() -> torch.dtype:
    """The working float dtype of the engine and the controller."""
    return torch.float64 if _dtype_override is None else _dtype_override


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` means the card.  A CUDA request (explicit or by default)
    without a usable card raises; the CPU is used only when asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class SimulationScheme(enum.Enum):
    """Discretisation schemes (reference: src/common/enums.py:4-9)."""

    EULER = 0
    MILSTEIN = 1
    ANALYTICAL = 2
    QE = 3
