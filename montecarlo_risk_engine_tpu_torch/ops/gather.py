"""Time-row gathers for the observable-resolution plane.

Counterpart of ``montecarlo_risk_engine_tpu/ops/gather.py``.  The JAX
version expresses the gather as a one-hot matmul to dodge TPU lowering
pathologies.  Here a request group reads its rows of the state plane one
column at a time: a closed form reads one or two of the D state columns, so
gathering whole [n, N, D] rows would copy (and, under forward-mode AD,
carry tangents for) columns nobody reads.
"""

from __future__ import annotations

from typing import Sequence

import torch


class RowSelection:
    """Rows ``tidx`` of a state plane — a [T, N, D] tensor or a sequence of
    [N, D] states — that acts as the [n, N, D] gathered rows for column
    reads ``sel[..., k]`` (all a model's ``resolve_obs`` does): each column
    is gathered once, on first read, as an [n, N] tensor."""

    def __init__(self, states, tidx: Sequence[int]):
        self._states = states
        self._tidx = [int(i) for i in tidx]
        self._cols = {}

    def __getitem__(self, key):
        if not (isinstance(key, tuple) and len(key) == 2 and key[0] is Ellipsis):
            raise TypeError("RowSelection supports column reads sel[..., k] only")
        col = int(key[1])
        if col not in self._cols:
            if isinstance(self._states, torch.Tensor):
                index = torch.as_tensor(self._tidx, device=self._states.device)
                self._cols[col] = self._states[..., col].index_select(0, index)
            else:
                self._cols[col] = torch.stack([self._states[i][..., col] for i in self._tidx])
        return self._cols[col]
