"""Longstaff-Schwartz convergence study: regression degree x path count.

Port of ``examples/lsm_convergence_study.py`` (the reference research
notebook american_style_options.ipynb, the LSM convergence study): prices
an American put through the full SimulationController LSM pipeline over a
grid of polynomial regression degrees and pre/main path counts, against a
dense Cox-Ross-Rubinstein binomial tree oracle, and plots the signed error
per degree as paths grow.

Expected shape (the notebook's punchline):
  * the LSM value sits BELOW the true American value (suboptimal-policy
    bias) and converges upward as paths grow;
  * degree 1 leaves a persistent bias (the linear basis cannot represent
    the continuation value's curvature); degrees 2-4 converge to within MC
    error of the tree, with diminishing returns beyond 3.

The port's working dtype is float64 on every device, so the fits run in
float64 on the card too (the paths come from K2 in float32 and are cast, as
the controller does); the script runs wherever ``device`` says.

Run: python examples_torch/lsm_convergence_study.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    AmericanOption,
    BlackScholesModel,
    Equity,
    NettingSet,
    OptionType,
    PolynomialRegression,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)

S0, K, R, SIGMA, TAU = 100.0, 100.0, 0.05, 0.3, 1.0
NUM_EXERCISE_DATES = 50


def crr_bermudan_put(steps_per_date=80):
    """Dense binomial-tree oracle exercising ONLY on the product's dates.

    The AmericanOption product is a Bermudan on linspace(0, T, n) — n dates
    with spacing T/(n-1) — so the clean oracle restricts the tree's early
    exercise to those same dates; a continuous-exercise tree would sit a few
    cents above any discrete-date scheme by construction."""
    steps = (NUM_EXERCISE_DATES - 1) * steps_per_date
    dt = TAU / steps
    u = np.exp(SIGMA * np.sqrt(dt))
    d = 1.0 / u
    p = (np.exp(R * dt) - d) / (u - d)
    disc = np.exp(-R * dt)
    j = np.arange(steps + 1)
    prices = S0 * u ** (steps - j) * d ** j
    values = np.maximum(K - prices, 0.0)
    for step in range(steps - 1, -1, -1):
        prices = prices[: step + 1] * d
        values = disc * (p * values[: step + 1] + (1 - p) * values[1 : step + 2])
        if step % steps_per_date == 0 and step > 0:
            values = np.maximum(values, K - prices)
    return float(values[0])


def lsm_price(degree, num_paths, root_seed=0, device=None):
    model = BlackScholesModel(0.0, spot=S0, rate=R, sigma=SIGMA)
    product = AmericanOption(Equity("eq"), TAU, NUM_EXERCISE_DATES, K,
                             OptionType.PUT, asset_id="eq")
    # standard Longstaff-Schwartz: in-the-money-weighted regression (the
    # beyond-parity mode; the reference's all-path fit adds an extra few
    # percent of policy bias on top of the degree effect)
    product.itm_only_regression = True
    controller = SimulationController(
        netting_sets=[NettingSet(name="am", products=[product])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        regression_function=PolynomialRegression(degree=degree),
        root_seed=root_seed,
        device=device,
    )
    r = controller.run_simulation()
    return (float(r.get_results("am", "pv", evaluation_idx=0)),
            float(r.get_mc_error("am", "pv", evaluation_idx=0)))


def main(save_plot=True, num_paths=65_536, degrees=(1, 2, 3, 4), device=None):
    device = resolve_device(device)
    path_counts = [max(num_paths // 16, 256), max(num_paths // 4, 1024),
                   num_paths]
    oracle = crr_bermudan_put()
    print(f"CRR binomial oracle ({NUM_EXERCISE_DATES}-date American put): "
          f"{oracle:.6f}")
    print(f"{'degree':>6} " + " ".join(f"{n:>12}" for n in path_counts))

    curves = {}
    ses = {}
    for deg in degrees:
        errors = []
        for n in path_counts:
            pv, se = lsm_price(deg, n, device=device)
            errors.append(pv - oracle)
            ses.setdefault(deg, []).append(se)
        curves[f"degree {deg}"] = np.asarray(errors)
        print(f"{deg:>6} " + " ".join(f"{e:>12.5f}" for e in errors))

    if save_plot:
        return save_profile_plot(
            "lsm_convergence_study.png",
            np.asarray(path_counts, dtype=float),
            curves,
            title=(f"LSM American put vs CRR tree ({oracle:.4f}): "
                   "signed error by degree"),
            ylabel="LSM PV - tree PV",
            xlabel="paths (pre = main)",
        )
    return oracle, curves, ses


if __name__ == "__main__":
    main()
