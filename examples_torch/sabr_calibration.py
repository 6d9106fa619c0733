"""SABR smile calibration via the Hagan asymptotic formula.

Port of ``examples/sabr_calibration.py``, the SABR leg of the reference's
implied-vol calibration study (docs/research/iImplied_volatility_calibration
.ipynb calibrates both SABR and Heston to SPY option mids;
examples_torch/heston_calibration.py covers the Heston leg): per-maturity
smile fitting of (alpha, rho, nu) at fixed beta with the Hagan et al. (2002)
lognormal implied-vol expansion, the market-standard quoting formula.

The target surface is synthetic (generated from known SABR parameters) so
the example runs offline and the fit is verifiable against truth; swap in
helpers.market_data.OptionDXDataLoader / YFDataLoader implied vols for live
data.  The Hagan formula is written in torch float64 on ``device``, so the
residual jacobian of the fit comes from ``torch.func.jacfwd``, not finite
differences.

Run: python examples_torch/sabr_calibration.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from scipy.optimize import least_squares

from montecarlo_risk_engine_tpu_torch import resolve_device

SPOT, RATE = 100.0, 0.02
BETA = 0.5
# per-maturity true (alpha, rho, nu): a falling term structure of vol-of-vol
TRUE = {
    0.5: (0.55, -0.35, 1.40),
    1.0: (0.50, -0.40, 1.10),
    2.0: (0.47, -0.45, 0.85),
}
STRIKES = np.array([70.0, 80.0, 90.0, 100.0, 110.0, 120.0, 130.0])


def _f64(x, device):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def hagan_implied_vol(alpha, rho, nu, forward, strike, maturity, beta=BETA, device=None):
    """Hagan et al. (2002) lognormal SABR implied vol (eq. 2.17a).

    Branch-free torch: the ATM limit is handled with a where-guard on
    log(F/K) so the expression stays differentiable at F == K.
    """
    device = resolve_device(device)
    alpha, rho, nu = _f64(alpha, device), _f64(rho, device), _f64(nu, device)
    f, k = _f64(forward, device), _f64(strike, device)
    log_fk = torch.log(f / k)
    fk_mid = (f * k) ** ((1.0 - beta) / 2.0)
    z = (nu / alpha) * fk_mid * log_fk
    x_z = torch.log((torch.sqrt(1.0 - 2.0 * rho * z + z * z) + z - rho)
                    / (1.0 - rho))
    # z/x(z) -> 1 as z -> 0; guard the 0/0 with the 2nd-order expansion
    small = torch.abs(z) < 1e-7
    z_over_x = torch.where(small, 1.0 - 0.5 * rho * z,
                           z / torch.where(small, torch.ones_like(x_z), x_z))
    one_m_beta = 1.0 - beta
    denom = fk_mid * (
        1.0
        + (one_m_beta ** 2 / 24.0) * log_fk ** 2
        + (one_m_beta ** 4 / 1920.0) * log_fk ** 4
    )
    correction = 1.0 + maturity * (
        (one_m_beta ** 2 / 24.0) * alpha ** 2 / (f * k) ** one_m_beta
        + 0.25 * rho * beta * nu * alpha / fk_mid
        + (2.0 - 3.0 * rho ** 2) / 24.0 * nu ** 2
    )
    return (alpha / denom) * z_over_x * correction


def smile(params, forward, maturity, strikes, device=None):
    alpha, rho, nu = params
    return hagan_implied_vol(alpha, rho, nu, forward, strikes, maturity, device=device)


def fit_smile(target_vols, forward, maturity, strikes, device=None):
    """Least-squares (alpha, rho, nu) at fixed beta, jacobian by jacfwd."""
    device = resolve_device(device)
    strikes_t = _f64(strikes, device)
    target = _f64(target_vols, device)

    def resid_np(x):
        return (smile(_f64(x, device), forward, maturity, strikes_t, device)
                - target).cpu().numpy()

    jac_fn = torch.func.jacfwd(lambda x: smile(x, forward, maturity, strikes_t, device))

    def jac_np(x):
        return jac_fn(_f64(x, device)).cpu().numpy()

    x0 = np.array([0.3, 0.0, 0.5])
    return least_squares(
        resid_np, x0, jac=jac_np,
        bounds=([1e-3, -0.999, 1e-3], [5.0, 0.999, 5.0]),
        xtol=1e-14, ftol=1e-14, gtol=1e-14,
    )


def main(verbose=True, device=None):
    device = resolve_device(device)
    results = {}
    for maturity, (alpha_t, rho_t, nu_t) in TRUE.items():
        forward = SPOT * np.exp(RATE * maturity)
        target = hagan_implied_vol(alpha_t, rho_t, nu_t, forward, STRIKES, maturity,
                                   device=device).cpu().numpy()
        fit = fit_smile(target, forward, maturity, STRIKES, device)
        fitted = hagan_implied_vol(*fit.x, forward, STRIKES, maturity,
                                   device=device).cpu().numpy()
        results[maturity] = {
            "true": (alpha_t, rho_t, nu_t),
            "fit": tuple(float(v) for v in fit.x),
            "max_vol_err": float(np.abs(fitted - target).max()),
        }
        if verbose:
            print(f"T={maturity:4.1f}  true a/r/n = "
                  f"{alpha_t:.3f}/{rho_t:+.3f}/{nu_t:.3f}   fitted = "
                  f"{fit.x[0]:.4f}/{fit.x[1]:+.4f}/{fit.x[2]:.4f}   "
                  f"max |dvol| = {results[maturity]['max_vol_err']:.2e}")
    return results


if __name__ == "__main__":
    main()
