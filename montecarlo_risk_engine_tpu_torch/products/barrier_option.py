"""Barrier options (one or two barriers) with an optional Brownian-bridge
crossing correction.

Counterpart of ``montecarlo_risk_engine_tpu/products/barrier_option.py``:
discrete monitoring over a linspace timeline with fuzzy max/min-vs-barrier
indicators (barrier_option.py:118-123); in bridge mode a per-interval hit
probability ``exp(-2 ln(S_i/B) ln(S_{i+1}/B) / (sigma^2 dt))`` compared
against a uniform of the bridge stream (hard unless the model smooths,
barrier_option.py:125-141); closed forms for up-and-out and down-and-out
calls (barrier_option.py:201-242).  Payoffs are deflated by the numeraire at
maturity, as in the JAX package.

Two formulas differ from the JAX package's, which are wrong:

  * the bridge's dt is the observation interval (maturity - startdate) /
    (n_obs - 1); JAX takes maturity / n_obs (barrier_option.py:136-137),
    which lowers every crossing probability and overprices knock-outs;
  * the down-and-out call is the vanilla call less the textbook down-and-in
    call, whose strike term carries (B/S)^(2 lambda - 2) with lambda = r /
    sigma^2 + 1/2; JAX's (barrier_option.py:229-238) lacks a factor S/B
    there (10.0968 against 10.3513 at S = K = 100, B = 80, r = 5 %, sigma =
    20 %, T = 1).  A strike below the barrier takes the textbook's other
    case, where JAX has no formula of its own.

Bridge uniforms come from ``rng.bridge_uniforms`` (Philox under
``PHASE_BRIDGE``, seed 0, counter (product id, barrier index, path,
interval), path the global index: under the controller's path sharding,
``path_sharding``, a rank draws its own paths'); ``bridge_source``, set by
the controller, replaces that stream (the seam the parity tests feed the JAX
package's threefry uniforms through; it is asked for this rank's paths).

The bridge needs the volatility, which the JAX package reads as
``params[1]`` (barrier_option.py:146): the Black-Scholes volatility under
``BlackScholesModel``, but a spot under ``BlackScholesMulti``.  The port
keeps JAX's result under ``BlackScholesModel`` and refuses bridge mode under
any other model.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import compute_degree_of_truth


class BarrierOptionType(enum.Enum):
    DOWNANDOUT = "Down-And-Out"
    UPANDOUT = "Up-And-Out"
    DOWNANDIN = "Down-And-In"
    UPANDIN = "Up-And-In"


def _survival_weight(barrier_type: BarrierOptionType, below_max, above_min, hit_prob=None):
    """Multiplicative payoff weight of one barrier (barrier_option.py:43-63)."""
    if barrier_type == BarrierOptionType.UPANDOUT:
        w = below_max if hit_prob is None else below_max * (1.0 - hit_prob)
    elif barrier_type == BarrierOptionType.DOWNANDOUT:
        w = above_min if hit_prob is None else above_min * (1.0 - hit_prob)
    elif barrier_type == BarrierOptionType.UPANDIN:
        w = 1.0 - below_max if hit_prob is None else (1.0 - below_max) * hit_prob
    elif barrier_type == BarrierOptionType.DOWNANDIN:
        w = 1.0 - above_min if hit_prob is None else (1.0 - above_min) * hit_prob
    else:
        raise NotImplementedError(f"Barrier type {barrier_type} not supported.")
    return w


class BarrierOption(Product):
    def __init__(self, startdate: float, maturity: float, strike: float,
                 num_observation_timepoints: int, option_type: OptionType, barrier1: float,
                 barrier_option_type1: BarrierOptionType, barrier2: Optional[float] = None,
                 barrier_option_type2: Optional[BarrierOptionType] = None,
                 asset_id: Optional[str] = None):
        super().__init__(asset_ids=[asset_id], product_family=ProductFamily.BARRIER_PATH_TERMINAL)
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.option_type = option_type
        self.barrier1 = float(barrier1)
        self.barrier_option_type1 = barrier_option_type1
        self.barrier2 = None if barrier2 is None else float(barrier2)
        self.barrier_option_type2 = barrier_option_type2
        self.use_brownian_bridge = False
        # (product id, barrier index, num paths, num intervals) -> uniforms
        # [num paths, num intervals]; None draws rng.bridge_uniforms.
        self.bridge_source: Optional[Callable] = None
        self.path_sharding = None  # set by the controller

        self.product_timeline = (self.maturity,)
        self.modeling_timeline = tuple(
            float(t) for t in np.linspace(startdate, maturity, num_observation_timepoints))
        self.regression_timeline = ()

        self.numeraire_requests = {idx: AtomicRequest(AtomicRequestType.NUMERAIRE, t)
                                   for idx, t in enumerate(self.modeling_timeline)}
        asset = self.get_asset_id()
        self.spot_requests = {(idx, asset): AtomicRequest(AtomicRequestType.SPOT)
                              for idx in range(len(self.modeling_timeline))}

    def set_use_brownian_bridge(self):
        self.use_brownian_bridge = True

    # -- payoffs ---------------------------------------------------------------

    def _barriers(self):
        out = [(self.barrier1, self.barrier_option_type1)]
        if self.barrier2 is not None and self.barrier_option_type2 is not None:
            out.append((self.barrier2, self.barrier_option_type2))
        return out

    def _vanilla_payoff(self, terminal_spots):
        sign = 1.0 if self.option_type == OptionType.CALL else -1.0
        return torch.clamp(sign * (terminal_spots - self.strike), min=0.0)

    def _bridge_hit_prob(self, spots, barrier, sigma, uniforms, is_fuzzy):
        """1 - prod(1 - p_i) over the intervals (barrier_option.py:125-141)."""
        dates = self.modeling_timeline
        dt = (dates[-1] - dates[0]) / (len(dates) - 1)
        log_ratio = torch.log(spots / barrier)
        bridge = torch.exp(-2.0 * log_ratio[:, :-1] * log_ratio[:, 1:] / (sigma * sigma * dt))
        hit_probs = compute_degree_of_truth(bridge - uniforms, is_fuzzy)
        return 1.0 - torch.prod(1.0 - hit_probs, dim=1)

    def _bridge_sigma(self, model, params):
        if not isinstance(model, BlackScholesModel):
            raise ValueError(
                "the Brownian-bridge barrier needs the volatility of a BlackScholesModel; under "
                f"{type(model).__name__} the JAX package reads params[1], which is not one")
        return params[1]

    def payoff(self, spots, model, params, bridge_uniforms=None):
        payoff = self._vanilla_payoff(spots[:, -1])
        max_spot = torch.max(spots, dim=1).values
        min_spot = torch.min(spots, dim=1).values
        sigma = self._bridge_sigma(model, params) if self.use_brownian_bridge else None
        for k, (barrier, kind) in enumerate(self._barriers()):
            below_max = compute_degree_of_truth(barrier - max_spot, True)
            above_min = compute_degree_of_truth(min_spot - barrier, True)
            hit = None
            if self.use_brownian_bridge:
                hit = self._bridge_hit_prob(spots, barrier, sigma, bridge_uniforms[k],
                                            bool(model.perform_smoothing))
            payoff = payoff * _survival_weight(kind, below_max, above_min, hit)
        return payoff

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        asset = self.get_asset_id()
        monitored = torch.stack([resolved_requests[0][self.spot_requests[(idx, asset)].handle]
                                 for idx in range(len(self.modeling_timeline))], dim=1)
        numeraire = resolved_requests[0][
            self.numeraire_requests[len(self.modeling_timeline) - 1].handle]
        uniforms = None
        if self.use_brownian_bridge:
            n, n_int = monitored.shape[0], len(self.modeling_timeline) - 1
            sh = self.path_sharding
            where = {} if sh is None else dict(path_offset=sh.rank, path_stride=sh.world_size)
            draw = self.bridge_source or (
                lambda pid, k, n, m: rng.bridge_uniforms(pid, k, n, m, monitored.dtype,
                                                         monitored.device, **where))
            uniforms = [draw(self.product_id, k, n, n_int).to(monitored)
                        for k in range(len(self._barriers()))]
        normalized = self.payoff(monitored, model, params, uniforms) / numeraire
        return state_matrix, normalized[:, None]

    # -- closed forms (barrier_option.py:201-242) -------------------------------

    def compute_pv_analytically(self, model, params):
        spot, sigma, rate = params[0], params[1], params[2]
        as_t = lambda v: torch.as_tensor(v, dtype=spot.dtype, device=spot.device)
        barrier, strike, tau = as_t(self.barrier1), as_t(self.strike), as_t(self.maturity)
        sqrt_tau = torch.sqrt(tau)
        ndtr = torch.special.ndtr

        def d_plus(x_over_y):
            return (torch.log(x_over_y) + (rate + 0.5 * sigma * sigma) * tau) / (sigma * sqrt_tau)

        call = self.option_type == OptionType.CALL
        if self.barrier_option_type1 == BarrierOptionType.UPANDOUT and call:
            d1_sk, d1_sb = d_plus(spot / strike), d_plus(spot / barrier)
            d1_bk, d1_bs = d_plus(barrier * barrier / (strike * spot)), d_plus(barrier / spot)
            vol_shift = sigma * sqrt_tau
            term1 = ndtr(d1_sk) - ndtr(d1_sb)
            term2 = ndtr(d1_bk) - ndtr(d1_bs)
            term3 = ndtr(d1_sk - vol_shift) - ndtr(d1_sb - vol_shift)
            term4 = ndtr(d1_bk - vol_shift) - ndtr(d1_bs - vol_shift)
            power = 1.0 + 2.0 * rate / (sigma * sigma)
            term_spot = spot * (term1 - (barrier / spot) ** power * term2)
            term_strike = strike * torch.exp(-rate * tau) * (
                term3 - (spot / barrier) ** (1.0 - 2.0 * rate / (sigma * sigma)) * term4)
            return (spot < barrier).to(spot.dtype) * (term_spot - term_strike)

        if self.barrier_option_type1 == BarrierOptionType.DOWNANDOUT and call:
            # vanilla call less the down-and-in call (Reiner and Rubinstein, 1991), with
            # (B/S)^(2 lambda) = factor (B/S) and (B/S)^(2 lambda - 2) = factor (S/B)
            vol_shift = sigma * sqrt_tau
            disc_k = strike * torch.exp(-rate * tau)
            factor = (barrier / spot) ** (2.0 * rate / (sigma * sigma))
            if self.strike >= self.barrier1:
                d1 = d_plus(spot / strike)
                d1_bk = d_plus(barrier * barrier / (strike * spot))
                vanilla = spot * ndtr(d1) - disc_k * ndtr(d1 - vol_shift)
                down_in = factor * (barrier * ndtr(d1_bk)
                                    - (spot / barrier) * disc_k * ndtr(d1_bk - vol_shift))
                value = vanilla - down_in
            else:
                x1, y1 = d_plus(spot / barrier), d_plus(barrier / spot)
                value = (spot * ndtr(x1) - disc_k * ndtr(x1 - vol_shift)
                         - factor * (barrier * ndtr(y1)
                                     - (spot / barrier) * disc_k * ndtr(y1 - vol_shift)))
            return (spot > barrier).to(spot.dtype) * value

        raise NotImplementedError(
            f"Analytical price for {self.barrier_option_type1}/{self.option_type} not implemented.")
