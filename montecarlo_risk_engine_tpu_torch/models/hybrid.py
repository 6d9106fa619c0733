"""Hybrid model container: joint simulation of several correlated models.

Counterpart of ``montecarlo_risk_engine_tpu/models/hybrid.py``
(``ModelConfig``), the model of the xVA books: e.g. a Vasicek rates model,
a Black-Scholes equity model and a CIR++ credit model simulated jointly
with user-given inter-asset correlation (wrong-way risk).

  * ``params`` concatenates the sub-model parameter tuples; names are
    prefixed ``asset.param`` (hybrid.py:102-117).
  * State and noise columns are partitioned by (state_dim, simulation_dim)
    offsets; ``step`` and ``invert_noise`` slice each block and delegate
    (hybrid.py:329-372).
  * The joint noise correlation is assembled block-wise: intra blocks from
    the sub-models, inter blocks from the user matrices (hybrid.py:136-150).
  * Under EULER, when every sub-model is a Black-Scholes, BS-multi,
    Vasicek, CIR++ (stochastic or deterministic) or Hull-White model, paths
    come from the hybrid path kernel K2 (ops/hybrid_paths.py): its block
    descriptors and static joint Cholesky factor come from
    :meth:`kernel_blocks` / :meth:`static_joint_correlation`
    (hybrid.py:213-284).  The other models run on the engine.
  * Under ANALYTICAL the joint one-step covariance (hybrid.py:152-206) has
    the sub-models' own covariances on the diagonal blocks and, between two
    models, the closed form of their Gaussian factor loadings
    (:meth:`Model.analytic_factor_loadings`); such books run on the engine.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model, like
from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.models.black_scholes_multi import BlackScholesMulti
from montecarlo_risk_engine_tpu_torch.models.cirpp import CIRPPModel
from montecarlo_risk_engine_tpu_torch.models.hull_white import HullWhiteModel
from montecarlo_risk_engine_tpu_torch.models.vasicek import VasicekModel
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import MAX_SIM, hybrid_paths

# Sub-model types with a K2 block inside a ModelConfig (hybrid.py:213-259):
# Schwartz-2F's rho is a parameter, so its block is for the model alone.
_KERNEL_TYPES = (BlackScholesModel, BlackScholesMulti, VasicekModel, CIRPPModel, HullWhiteModel)


class ModelConfig(Model):
    def __init__(self, models: Sequence[Model], numeraire_model_idx: int = 0,
                 discount_model_idx: int = 0,
                 inter_asset_correlation_matrix: Optional[List] = None):
        models = list(models)
        if not models:
            raise ValueError("Provide at least one model.")
        if any(m.calibration_date != models[0].calibration_date for m in models):
            raise ValueError("All models must share the same calibration_date.")
        asset_ids = [a for m in models for a in m.asset_ids]
        if len(asset_ids) != len(set(asset_ids)):
            raise ValueError("Duplicate asset_ids across sub-models: each asset must be "
                             "simulated by exactly one model.")
        super().__init__(
            calibration_date=models[0].calibration_date,
            asset_ids=asset_ids,
            simulation_dim=sum(m.simulation_dim for m in models),
            state_dim=sum(m.state_dim for m in models),
        )
        self.models = models
        self.id_to_model = {"numeraire": numeraire_model_idx, "discount": discount_model_idx}
        for idx, m in enumerate(models):
            for a in m.asset_ids:
                self.id_to_model[a] = idx

        self._state_offsets = np.cumsum([0] + [m.state_dim for m in models])
        # Sub-models read absolute columns of the full joint state.
        for i, m in enumerate(models):
            m._col_offset = int(self._state_offsets[i])
        self._sim_offsets = np.cumsum([0] + [m.simulation_dim for m in models])
        self._param_offsets = np.cumsum([0] + [len(m._initial_values()) for m in models])

        # Inter-model correlation blocks over pairs (i, j), j > i; zero when
        # omitted (hybrid.py:81-93).
        self._inter_corr: List[np.ndarray] = []
        pair_idx = 0
        for i, m1 in enumerate(models):
            for m2 in models[i + 1:]:
                if inter_asset_correlation_matrix is None:
                    self._inter_corr.append(np.zeros((m1.simulation_dim, m2.simulation_dim)))
                else:
                    self._inter_corr.append(np.atleast_2d(np.asarray(
                        inter_asset_correlation_matrix[pair_idx], dtype=np.float64)))
                pair_idx += 1

    # -- params ---------------------------------------------------------------

    def _initial_values(self):
        return tuple(v for m in self.models for v in m._initial_values())

    def get_model_param_names(self):
        names = []
        for m in self.models:
            label = m.asset_ids[0] if len(m.asset_ids) == 1 and m.asset_ids[0] else type(m).__name__
            names.extend(f"{label}.{p}" for p in m.get_model_param_names())
        return names

    def requires_grad(self):
        self.perform_smoothing = True
        for m in self.models:
            m.requires_grad()

    def _sub_params(self, params, idx):
        return tuple(params[self._param_offsets[idx]:self._param_offsets[idx + 1]])

    # -- state / noise ----------------------------------------------------------

    def init_state(self, params, num_paths):
        return torch.cat([m.init_state(self._sub_params(params, i), num_paths)
                          for i, m in enumerate(self.models)], dim=1)

    def correlation_matrix(self, params, scheme):
        rows = []
        for i, m in enumerate(self.models):
            row = []
            for j, m2 in enumerate(self.models):
                if i == j:
                    row.append(m.correlation_matrix(self._sub_params(params, i), scheme))
                    continue
                lo, hi = min(i, j), max(i, j)
                pair_idx = sum(len(self.models) - 1 - k for k in range(lo)) + (hi - lo - 1)
                block = self._inter_corr[pair_idx] if i < j else self._inter_corr[pair_idx].T
                row.append(torch.as_tensor(block, dtype=params[0].dtype, device=params[0].device))
            rows.append(torch.cat(row, dim=1))
        corr = torch.cat(rows, dim=0)
        return 0.5 * (corr + corr.mT)

    def covariance_matrix(self, params, delta_t):
        """Joint one-step covariance of the ANALYTICAL noise over ``delta_t``
        (hybrid.py:152-170): the sub-models' covariances on the diagonal, the
        closed-form cross covariance of each pair off it."""
        sub = [self._sub_params(params, i) for i in range(len(self.models))]
        blocks = {}
        pair_idx = 0
        for i, m1 in enumerate(self.models):
            blocks[i, i] = m1.covariance_matrix(sub[i], delta_t)
            for j in range(i + 1, len(self.models)):
                corr = like(self._inter_corr[pair_idx], params[0])
                blocks[i, j] = self._inter_covariance(m1, sub[i], self.models[j], sub[j], corr,
                                                      delta_t)
                blocks[j, i] = blocks[i, j].mT
                pair_idx += 1
        n = len(self.models)
        cov = torch.cat([torch.cat([blocks[i, j] for j in range(n)], dim=1) for i in range(n)])
        return 0.5 * (cov + cov.mT)

    @staticmethod
    def _inter_covariance(m1, p1, m2, p2, corr_block, delta_t):
        """Covariance of two models' ANALYTICAL noise increments driven by
        rho-correlated Brownians (hybrid.py:172-206): with each factor's
        increment v int_0^dt e^{-a (dt - u)} dW(u),
        C_ij = v_i v_j rho_ij (1 - e^{-(a_i + a_j) dt}) / (a_i + a_j), whose
        a_i + a_j -> 0 limit is dt (the Black-Scholes pair's sigma_1 sigma_2
        rho dt)."""
        la = m1.analytic_factor_loadings(p1)
        lb = m2.analytic_factor_loadings(p2)
        if la is None or lb is None:
            raise NotImplementedError(
                "Joint ANALYTICAL covariance needs Gaussian-increment factor loadings on both "
                f"models; {type(m1).__name__} x {type(m2).__name__} has none — use EULER/QE "
                "for this hybrid combination.")
        ref = corr_block
        rows = []
        for a_i, v_i in la:
            row = []
            for a_j, v_j in lb:
                s = like(a_i, ref) + like(a_j, ref)
                near_zero = torch.abs(s) < 1e-12
                s_safe = torch.where(near_zero, torch.ones_like(s), s)
                integral = torch.where(near_zero, like(delta_t, ref),
                                       -torch.expm1(-s_safe * delta_t) / s_safe)
                row.append(like(v_i, ref) * like(v_j, ref) * integral)
            rows.append(torch.stack(row))
        return torch.stack(rows) * corr_block

    def uses_uniforms(self, scheme):
        return any(m.uses_uniforms(scheme) for m in self.models)

    # -- path kernel (ops/hybrid_paths.py) ----------------------------------------

    def kernel_blocks(self):
        """Euler block descriptors of the hybrid path kernel, or None when a
        sub-model has no block there (hybrid.py:213-259)."""
        blocks = []
        for i, m in enumerate(self.models):
            if type(m) not in _KERNEL_TYPES:
                return None
            blocks.append(m.kernel_block(SimulationScheme.EULER, int(self._param_offsets[i])))
        return blocks

    def static_joint_correlation(self) -> np.ndarray:
        """Host mirror of :meth:`correlation_matrix` for the kernel block set:
        the intra blocks are identities but BS-multi's user correlation, the
        inter blocks user configuration (hybrid.py:261-284)."""
        corr = np.eye(self.simulation_dim)
        pair_idx = 0
        for i in range(len(self.models)):
            r0, r1 = self._sim_offsets[i], self._sim_offsets[i + 1]
            if isinstance(self.models[i], BlackScholesMulti):
                corr[r0:r1, r0:r1] = self.models[i].kernel_correlation()
            for j in range(i + 1, len(self.models)):
                c0, c1 = self._sim_offsets[j], self._sim_offsets[j + 1]
                corr[r0:r1, c0:c1] = self._inter_corr[pair_idx]
                corr[c0:c1, r0:r1] = self._inter_corr[pair_idx].T
                pair_idx += 1
        return corr

    def supports_kernel_paths(self, scheme):
        return (scheme == SimulationScheme.EULER and self.simulation_dim <= MAX_SIM
                and self.kernel_blocks() is not None)

    def kernel_paths(self, params, scheme, timeline, num_paths, num_steps, seed, phase=0,
                     path_offset=0, path_stride=1):
        """Joint trajectory from the hybrid path kernel: [T, N, D] f32 in
        block order."""
        if not self.supports_kernel_paths(scheme):
            raise ValueError("the hybrid path kernel needs EULER and Black-Scholes, BS-multi, "
                             "Vasicek, CIR++ or Hull-White sub-models only")
        return hybrid_paths(
            self.kernel_blocks(), np.linalg.cholesky(self.static_joint_correlation()),
            params, timeline, num_paths, num_steps, seed=seed, phase=phase,
            calibration_date=self.calibration_date, path_offset=path_offset,
            path_stride=path_stride,
        )

    # -- stepping -----------------------------------------------------------

    def _sub_scheme(self, m, scheme):
        # QE is defined per asset; sub-models without a QE step integrate
        # their block with Euler (hybrid.py:339-341).
        if scheme == SimulationScheme.QE and not m.uses_uniforms(scheme):
            return SimulationScheme.EULER
        return scheme

    def step(self, params, scheme, t1, t2, state, corr_noise, uniform=None):
        blocks = []
        for i, m in enumerate(self.models):
            s0, s1 = self._state_offsets[i], self._state_offsets[i + 1]
            n0, n1 = self._sim_offsets[i], self._sim_offsets[i + 1]
            blocks.append(m.step(self._sub_params(params, i), self._sub_scheme(m, scheme), t1, t2,
                                 state[:, s0:s1], corr_noise[:, n0:n1], uniform))
        return torch.cat(blocks, dim=1)

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # Blockwise: the joint correlation shapes only the law of the block
        # noises, not the per-block state -> noise map (hybrid.py:355-372).
        blocks = []
        for i, m in enumerate(self.models):
            s0, s1 = self._state_offsets[i], self._state_offsets[i + 1]
            blocks.append(m.invert_noise(self._sub_params(params, i), self._sub_scheme(m, scheme),
                                         t1, t2, state[:, s0:s1], next_state[:, s0:s1]))
        return torch.cat(blocks, dim=1)

    # -- observables --------------------------------------------------------------

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        idx = self.id_to_model[asset_id]
        return self.models[idx].resolve_obs(self._sub_params(params, idx), kind, asset_id,
                                            t1, t2, state)
