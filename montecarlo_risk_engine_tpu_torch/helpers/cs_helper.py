"""Cumulative default probabilities under piecewise-constant hazards.

Counterpart of ``montecarlo_risk_engine_tpu/helpers/cs_helper.py``
(``probability_of_default``, used by the CIR++ model's market survival
curve).  The host-side CDS bootstrap of that module is not ported yet.
"""

from __future__ import annotations

import torch


def probability_of_default(hazards: torch.Tensor, tenors: torch.Tensor, date) -> torch.Tensor:
    """Cumulative PD up to ``date`` (a float or a tensor of any shape).

    ``hazards[i]`` applies on (tenors[i-1], tenors[i]]; the last hazard is
    flat-extended beyond the final tenor (reference cs_helper.py:80-108):
    integral = sum_i hazards[i] * overlap(bucket_i, [0, date])
    + last_hazard * max(date - tenors[-1], 0)."""
    date = torch.as_tensor(date, dtype=hazards.dtype, device=hazards.device)
    prev = torch.cat([torch.zeros((1,), dtype=tenors.dtype, device=tenors.device), tenors[:-1]])
    d = date[..., None]
    overlap = torch.clamp(torch.minimum(tenors, d) - prev, min=0.0)
    integral = torch.sum(hazards * overlap, dim=-1) + hazards[-1] * torch.clamp(
        date - tenors[-1], min=0.0)
    return 1.0 - torch.exp(-integral)
