"""Heston parameter calibration to an implied-vol surface.

Port of ``examples/heston_calibration.py`` (the reference research
notebook's SABR/Heston calibration on SPY): least-squares fit of (kappa,
theta, sigma, rho, v0) to a grid of option prices via the stable
characteristic-function pricer (products/european_option.py).

The target surface is synthetic (generated from known parameters) so the
example runs offline and the fit is verifiable; swap in
helpers.market_data.OptionDXDataLoader / YFDataLoader mids for live data.
Host-side only (scipy quadrature), so ``device`` is only checked.

Run: python examples_torch/heston_calibration.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.optimize import least_squares

from montecarlo_risk_engine_tpu_torch import (
    Equity,
    EuropeanOption,
    HestonModel,
    OptionType,
    resolve_device,
)

SPOT, RATE = 100.0, 0.02
TRUE = dict(kappa=1.8, theta=0.05, sigma=0.45, rho=-0.6, v0=0.045)
STRIKES = [80.0, 90.0, 100.0, 110.0, 120.0]
MATURITIES = [0.5, 1.0, 2.0]


def price_grid(kappa, theta, sigma, rho, v0):
    model = HestonModel(0.0, spot=SPOT, rate=RATE, sigma=sigma, rho=rho,
                        kappa=kappa, theta=theta, v0=v0)
    prices = []
    for maturity in MATURITIES:
        for strike in STRIKES:
            option = EuropeanOption(Equity(), maturity, strike, OptionType.CALL)
            prices.append(option.heston_call_price(model, strike, maturity))
    return np.array(prices)


def main(device=None):
    resolve_device(device)
    target = price_grid(**TRUE)

    def residuals(x):
        kappa, theta, sigma, rho, v0 = x
        return price_grid(kappa, theta, sigma, rho, v0) - target

    x0 = np.array([1.0, 0.04, 0.3, -0.3, 0.04])
    fit = least_squares(
        residuals, x0,
        bounds=([0.1, 0.005, 0.05, -0.99, 0.005], [10.0, 0.5, 2.0, 0.99, 0.5]),
        diff_step=1e-4, xtol=1e-12, ftol=1e-14, gtol=1e-12,
    )
    names = ["kappa", "theta", "sigma", "rho", "v0"]
    print(f"{'param':>6} {'true':>8} {'fitted':>10}")
    for name, true_val, fitted in zip(names, TRUE.values(), fit.x):
        print(f"{name:>6} {true_val:8.4f} {fitted:10.6f}")
    print("max residual:", np.abs(fit.fun).max())
    return {"fit": dict(zip(names, (float(v) for v in fit.x))),
            "max_residual": float(np.abs(fit.fun).max())}


if __name__ == "__main__":
    main()
