"""CDS hazard-rate bootstrap and cumulative default probabilities.

Counterpart of ``montecarlo_risk_engine_tpu/helpers/cs_helper.py``:

  * :func:`probability_of_default`, in torch ops on the device: the CIR++
    model's market survival curve;
  * :meth:`CSHelper.bootstrap_hazards`, the CDS bootstrap: control-flow
    heavy root finding on the host at set-up time, plain numpy floats, as in
    the JAX package.  Where JAX asserts (cs_helper.py:91, stripped under
    ``python -O``) the port raises ``ValueError``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.utils.maths import bisection_search


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


class CSHelper:
    """Host-side CDS bootstrap (premium and protection legs with
    accrual-on-default)."""

    def _compute_cds_legs(self, maturities: Sequence[float], payment_days: np.ndarray,
                          discount_factors_payment_days: np.ndarray, recovery_rate: float,
                          hazard_rates: Sequence[float]) -> Tuple[float, float]:
        """(premium leg, protection leg) under piecewise-constant hazards per
        maturity bucket (JAX cs_helper.py:43-79): premium = sum delta_k DF_k
        S(t_k) + 0.5 delta_k DF_k (S_k-1 - S_k), protection = (1 - R) sum DF_k
        (S_k-1 - S_k)."""
        payment_days = np.asarray(payment_days, dtype=float)
        dfs = np.asarray(discount_factors_payment_days, dtype=float)
        deltas = np.diff(np.concatenate([[0.0], payment_days]))
        bucket_end_idx = np.searchsorted(payment_days, maturities)
        premium = protection = 0.0
        s_prev, k_start = 1.0, 0
        for i, _ in enumerate(maturities):
            lam = hazard_rates[i]
            t_anchor = maturities[i - 1] if i > 0 else 0.0
            s_anchor = s_prev
            for k in range(k_start, bucket_end_idx[i] + 1):
                s_k = s_anchor * np.exp(-lam * (payment_days[k] - t_anchor))
                premium += deltas[k] * dfs[k] * s_k + 0.5 * deltas[k] * dfs[k] * (s_prev - s_k)
                protection += (1.0 - recovery_rate) * dfs[k] * (s_prev - s_k)
                s_prev = s_k
            # the next bucket starts strictly after this maturity's payment
            k_start = bucket_end_idx[i] + 1
        return premium, protection

    def bootstrap_hazards(self, credit_spreads: Sequence[float], maturities: np.ndarray,
                          payment_days: np.ndarray, discount_factors_payment_days: np.ndarray,
                          recovery_rate: float) -> List[float]:
        """One hazard per maturity, bootstrapped in order by bisection so that
        spread x premium leg = protection leg (JAX cs_helper.py:81-105)."""
        if len(payment_days) != len(discount_factors_payment_days):
            raise ValueError(
                f"{len(payment_days)} payment days but {len(discount_factors_payment_days)} "
                "discount factors: give one discount factor per payment day")
        hazards: List[float] = []
        for i, spread in enumerate(credit_spreads):
            def objective(lam: float) -> float:
                prem, prot = self._compute_cds_legs(
                    list(maturities[: i + 1]), payment_days, discount_factors_payment_days,
                    recovery_rate, hazards + [lam])
                return spread * prem - prot

            hazards.append(bisection_search(objective))
        return hazards

    def probability_of_default(self, hazards, tenors, date):
        return probability_of_default(hazards, tenors, date)
