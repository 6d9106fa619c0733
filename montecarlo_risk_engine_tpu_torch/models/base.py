"""Model base protocol: step functions over path state.

Counterpart of ``montecarlo_risk_engine_tpu/models/base.py``.

  * Parameters are explicit: every method takes ``params``, a flat tuple of
    0-d tensors in the order of :meth:`Model.get_model_param_names`.
    Autograd differentiates the pipeline with respect to that tuple.
  * Steps map ``(params, t1, t2, state [N, D], corr_noise [N, sim_dim],
    uniform [N]) -> state``.  They are plain functions: the engine loops over
    them in Python.
  * States keep the [N, state_dim] layout everywhere.  The JAX package's
    path-minor plane (``set_state_layout``) is a TPU padding workaround and
    is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, real_dtype
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import hybrid_paths


def params_from_numpy(np_params, device=None, dtype=None) -> Tuple[torch.Tensor, ...]:
    """The port's parameter tuple from numpy (or float) scalars — e.g. the
    JAX model's ``initial_params()`` passed through ``np.asarray`` — so both
    packages compute from the same numbers."""
    dtype = dtype or real_dtype()
    return tuple(
        torch.tensor(float(np.asarray(p, dtype=np.float64)), dtype=dtype, device=device)
        for p in np_params
    )


class Model:
    def __init__(
        self,
        calibration_date: float,
        simulation_dim: int = 1,
        state_dim: int = 1,
        asset_ids: Optional[Sequence[str]] = None,
    ):
        self.calibration_date = float(calibration_date)
        self.asset_ids: List[str] = list(asset_ids) if asset_ids else [""]
        self.num_assets = len(self.asset_ids)
        self.simulation_dim = simulation_dim
        self.state_dim = state_dim
        # Mirrors the reference's ``perform_smoothing``: enabled alongside
        # differentiation so discontinuous branches become fuzzy
        # (model.py:83-90).
        self.perform_smoothing = False

    # -- parameters ---------------------------------------------------------

    def _initial_values(self) -> Tuple[float, ...]:
        raise NotImplementedError

    def initial_params(self, device=None, dtype=None) -> Tuple[torch.Tensor, ...]:
        """Flat tuple of 0-d tensors, in the order of get_model_param_names()."""
        return params_from_numpy(self._initial_values(), device, dtype)

    def get_model_param_names(self) -> List[str]:
        raise NotImplementedError

    def requires_grad(self) -> None:
        """Enable branch smoothing for differentiated runs."""
        self.perform_smoothing = True

    # -- state / noise ------------------------------------------------------

    def init_state(self, params, num_paths: int) -> torch.Tensor:
        """Initial state, shape [num_paths, state_dim]."""
        raise NotImplementedError

    def correlation_matrix(self, params, scheme: SimulationScheme) -> torch.Tensor:
        """Driver-noise correlation (reference model.py:75-77 default: identity)."""
        return torch.eye(self.simulation_dim, dtype=params[0].dtype, device=params[0].device)

    def covariance_matrix(self, params, delta_t) -> torch.Tensor:
        """One-step noise covariance under the ANALYTICAL scheme (reference
        model.py:79-81 default: identity * dt)."""
        return torch.eye(self.simulation_dim, dtype=params[0].dtype,
                         device=params[0].device) * delta_t

    def analytic_factor_loadings(self, params):
        """Per noise factor k: (a_k, vol_k) such that the ANALYTICAL noise
        increment over [t, t + dt] is vol_k int_0^dt e^{-a_k (dt - u)} dW_k(u)
        (a_k = 0 for a Brownian factor).  None where the exact transition is
        not of that Gaussian form (JAX models/base.py:91-105)."""
        return None

    def noise_transform(self, params, scheme: SimulationScheme, delta_t=None) -> torch.Tensor:
        """Matrix L with correlated increments = z @ L.T (reference
        generate_correlated_randn, model.py:38-48): under ANALYTICAL the
        Cholesky factor of the one-step covariance over ``delta_t``, else of
        the noise-factor correlation."""
        if scheme == SimulationScheme.ANALYTICAL:
            return torch.linalg.cholesky(self.covariance_matrix(params, delta_t))
        return torch.linalg.cholesky(self.correlation_matrix(params, scheme))

    def uses_uniforms(self, scheme: SimulationScheme) -> bool:
        """Whether step() consumes a per-path uniform draw (Heston QE only)."""
        return False

    # -- stepping -----------------------------------------------------------

    def step(self, params, scheme: SimulationScheme, t1, t2, state, corr_noise, uniform=None):
        if scheme == SimulationScheme.ANALYTICAL:
            return self.step_analytical(params, t1, t2, state, corr_noise)
        if scheme == SimulationScheme.EULER:
            return self.step_euler(params, t1, t2, state, corr_noise)
        if scheme == SimulationScheme.MILSTEIN:
            return self.step_milstein(params, t1, t2, state, corr_noise)
        if scheme == SimulationScheme.QE:
            return self.step_qe(params, t1, t2, state, corr_noise, uniform)
        raise NotImplementedError(f"Scheme {scheme} not supported by {type(self).__name__}")

    def step_analytical(self, params, t1, t2, state, corr_noise):
        raise NotImplementedError(f"{type(self).__name__}: analytical step not implemented")

    def step_euler(self, params, t1, t2, state, corr_noise):
        raise NotImplementedError(f"{type(self).__name__}: Euler step not implemented")

    def step_milstein(self, params, t1, t2, state, corr_noise):
        raise NotImplementedError(f"{type(self).__name__}: Milstein step not implemented")

    def step_qe(self, params, t1, t2, state, corr_noise, uniform):
        raise NotImplementedError(f"{type(self).__name__}: QE step not implemented")

    # -- fused path kernel --------------------------------------------------

    #: Schemes under which the model alone takes the hybrid path kernel K2
    #: (the JAX model's ``supports_pallas_paths``).
    kernel_schemes: Tuple[SimulationScheme, ...] = ()

    def supports_kernel_paths(self, scheme: SimulationScheme) -> bool:
        """Whether a hand-written path kernel exists for this model and
        scheme (ops/heston_qe.py, ops/hybrid_paths.py).  Its draws are the
        same Philox stream as the engine's default noise, in float32."""
        return scheme in self.kernel_schemes

    def kernel_block(self, scheme: SimulationScheme, param_base: int = 0):
        """The ``KernelBlock`` of K2 (ops/hybrid_paths.py) that steps this
        model under ``scheme``, its parameters at ``param_base`` of the flat
        vector; None where K2 has no such block."""
        return None

    def kernel_correlation(self) -> np.ndarray:
        """Static correlation of the model's K2 noise factors (host array)."""
        return np.eye(self.simulation_dim)

    def kernel_paths(self, params, scheme, timeline, num_paths: int,
                     num_steps: int, seed: int, phase: int = 0, path_offset: int = 0,
                     path_stride: int = 1):
        """States at each timeline point, [T, num_paths, state_dim] f32:
        the model as the one block of K2.  Row i is global path
        ``path_offset + path_stride * i`` (ops/path_shard.py)."""
        if not self.supports_kernel_paths(scheme):
            raise ValueError(f"{type(self).__name__} has no path kernel under {scheme.name}")
        return hybrid_paths([self.kernel_block(scheme)],
                            np.linalg.cholesky(self.kernel_correlation()), params, timeline,
                            num_paths, num_steps, seed=seed, phase=phase,
                            calibration_date=self.calibration_date, path_offset=path_offset,
                            path_stride=path_stride)

    def kernel_paths_with_noise(self, params, scheme, timeline, num_paths: int,
                                seed: int, phase: int = 0, path_offset: int = 0,
                                path_stride: int = 1):
        """Noise-emitting kernel forward for the emitted-noise AD path:
        states [T, N, D], raw normals [T, N, sim_dim], uniforms [T, N] at a
        substep-dense timeline (one substep per point)."""
        raise NotImplementedError

    def kernel_ad_mode(self, scheme: SimulationScheme) -> str:
        """How the differentiated kernel route gets the step draws:
        ``"invert"`` recovers them from consecutive kernel states
        (:meth:`invert_noise`, ops/paths_ad.recovered_noise_fns), ``"emit"``
        takes them from the noise-emitting kernel (Heston QE,
        ops/paths_ad.emitted_noise_fns)."""
        return "invert"

    def invert_noise(self, params, scheme: SimulationScheme, t1, t2, state, next_state):
        """The ``corr_noise`` [N, sim_dim] for which ``step(params, scheme,
        t1, t2, state, corr_noise) == next_state`` (reference
        models/base.py:189).  Zero where the diffusion vanishes: the draw is
        unrecoverable there, and its tangent coefficient is 0."""
        raise NotImplementedError(f"{type(self).__name__}: transition inversion not implemented")

    # -- observables --------------------------------------------------------

    # Column offset into a wider joint state: ModelConfig hands sub-models the
    # full [.., N, D] state and sets this to the sub-model's block start.
    _col_offset: int = 0

    def _col(self, state, k: int):
        """Column ``k`` (relative to ``_col_offset``) of a [..., D] state."""
        return state[..., k + self._col_offset]

    def resolve_obs(self, params, kind, asset_id: str, t1, t2, state):
        """Resolve one observable kind.  ``t1``/``t2`` may be tensors [n]
        with ``state`` [n, N, D] (one row per request) or floats with
        ``state`` [N, D].  Returns [n, N] / [N], or [n] / 0-d when the
        observable is state-independent."""
        raise NotImplementedError

    def resolve_request_rows(self, params, kind, asset_id: str, t1s, t2s, states_sel):
        """Vectorised resolution of n same-kind requests on one asset:
        states_sel [n, N, state_dim] -> [n, N] (or [n])."""
        return self.resolve_obs(params, kind, asset_id, t1s, t2s, states_sel)


def like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (a float, a sequence or a tensor) as a tensor of ``ref``'s
    dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def per_row(t, x):
    """``t`` shaped to broadcast against a pathwise tensor ``x``: a float
    stays a float, a [n] tensor of per-request times becomes [n, 1] against
    ``x`` [n, N]."""
    if isinstance(t, torch.Tensor) and t.dim() and x.dim() > t.dim():
        return t.reshape(t.shape + (1,) * (x.dim() - t.dim()))
    return t
