"""Time-row gathers for the observable-resolution plane.

Counterpart of ``montecarlo_risk_engine_tpu/ops/gather.py``.  The JAX
version expresses the gather as a one-hot matmul to dodge TPU lowering
pathologies; on a GPU a plain index select on the leading axis of the
[T, N, D] plane is the right op, and autograd scatters its gradient back
with no padded intermediates.
"""

from __future__ import annotations

from typing import Sequence

import torch


def take_time_rows(states: torch.Tensor, tidx: Sequence[int]) -> torch.Tensor:
    """states [T, N, D] -> [len(tidx), N, D]."""
    index = torch.as_tensor(list(tidx), dtype=torch.long, device=states.device)
    return states.index_select(0, index)


def gather_rows(states: torch.Tensor, tidx) -> torch.Tensor:
    """Convenience wrapper accepting any integer sequence or numpy array."""
    return take_time_rows(states, [int(i) for i in tidx])
