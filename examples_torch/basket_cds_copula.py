"""k-th-to-default basket CDS pricing with Gaussian and Student-t copulas.

Port of ``examples/basket_cds_copula.py`` (the reference research notebook
on basket CDS, kth-to-default under Gaussian/t copulas): simulates
correlated default times by mapping copula samples through flat hazard
curves, using the port's Student-t CDF (utils/special.py, a custom
derivative rule).  Torch ops on ``device`` with an explicit
``torch.Generator`` seeded 7; the Student-t mixing variable is a gamma draw
from the same generator.

Run: python examples_torch/basket_cds_copula.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from montecarlo_risk_engine_tpu_torch import resolve_device
from montecarlo_risk_engine_tpu_torch.utils.special import t_cdf

N_NAMES = 5
RHO = 0.4
MATURITY = 5.0
RECOVERY = 0.4
HAZARD = 0.02
NUM_PATHS = 200_000
SEED = 7


def default_times_from_uniforms(u):
    """Invert flat-hazard survival: tau = -ln(1-u)/h."""
    return -torch.log1p(-u) / HAZARD


def copula_uniforms(generator, kind: str, num_paths=NUM_PATHS, device=None):
    """[num_paths, N_NAMES] copula uniforms drawn from ``generator`` (a
    ``torch.Generator`` on ``device``)."""
    device = resolve_device(device)
    corr = (RHO * torch.ones((N_NAMES, N_NAMES), dtype=torch.float64, device=device)
            + (1 - RHO) * torch.eye(N_NAMES, dtype=torch.float64, device=device))
    chol = torch.linalg.cholesky(corr)
    z = torch.randn((num_paths, N_NAMES), generator=generator, dtype=torch.float64,
                    device=device) @ chol.T
    if kind == "gaussian":
        return torch.special.ndtr(z)
    # Student-t copula: scale by sqrt(df / chi2)
    df = 4.0
    shape = torch.full((num_paths, 1), df / 2.0, dtype=torch.float64, device=device)
    chi2 = 2.0 * torch._standard_gamma(shape, generator=generator)
    t_samples = z / torch.sqrt(chi2 / df)
    return t_cdf(t_samples, df)


def kth_to_default_leg(taus, k: int, rate: float = 0.02):
    """Protection-leg value of the k-th default before maturity."""
    tau_sorted = torch.sort(taus, dim=1).values
    tau_k = tau_sorted[:, k - 1]
    hit = tau_k <= MATURITY
    df = torch.exp(-rate * torch.clamp(tau_k, max=MATURITY))
    return torch.mean(torch.where(hit, (1.0 - RECOVERY) * df, torch.zeros_like(df)))


def main(num_paths=NUM_PATHS, device=None):
    device = resolve_device(device)
    print(f"{'copula':>10} {'k':>3} {'protection leg':>15}")
    legs = {}
    for kind in ("gaussian", "student-t"):
        generator = torch.Generator(device=device).manual_seed(SEED)
        u = copula_uniforms(generator, kind, num_paths, device)
        taus = default_times_from_uniforms(u)
        for k in (1, 2, N_NAMES):
            leg = float(kth_to_default_leg(taus, k))
            legs[kind, k] = leg
            print(f"{kind:>10} {k:3d} {leg:15.5f}")
    return legs


if __name__ == "__main__":
    main()
