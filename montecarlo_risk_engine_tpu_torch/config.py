"""Global configuration: dtype policy, device choice and simulation-scheme enum.

PyTorch counterpart of ``montecarlo_risk_engine_tpu/config.py``.

  * The working dtype defaults to float64, the precision the JAX package runs
    with under ``jax_enable_x64`` (its tests and the reference's contract).
    The path kernel itself is float32 (``ops/heston_qe.py``); its outputs are
    cast to the working dtype, as the JAX controller does.
  * Placement is an explicit ``torch.device``: the controller and the engine
    take a ``device`` argument.  :func:`resolve_device` raises when CUDA is
    asked for and absent — a run never falls back to the CPU silently.
"""

from __future__ import annotations

import enum
from typing import Union

import torch


def real_dtype() -> torch.dtype:
    """The working float dtype of the engine and the controller."""
    return torch.float64


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` picks CUDA when present, else the CPU; an explicit CUDA
    request without a usable card raises."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class SimulationScheme(enum.Enum):
    """Discretisation schemes (reference: src/common/enums.py:4-9)."""

    EULER = 0
    MILSTEIN = 1
    ANALYTICAL = 2
    QE = 3
