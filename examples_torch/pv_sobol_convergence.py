"""Scrambled-Sobol QMC vs pseudo-random convergence on a European call.

Port of ``examples/pv_sobol_convergence.py`` (no reference counterpart):
measures the PV error against the Black-Scholes closed form across path
counts for the pseudo-random sampler (the port's Philox stream, on K2) and
the digitally-shifted Sobol sampler (``SimulationController(sampler=
"sobol")``, ops/sobol.py, on the engine).  On this smooth payoff the Sobol
error decays near O(N^-1) versus the Monte Carlo O(N^-1/2).

Run: python examples_torch/pv_sobol_convergence.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.stats import norm

from examples_torch._common import save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    BlackScholesModel,
    Equity,
    EuropeanOption,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)

S0, K, R, SIGMA, TAU = 100.0, 100.0, 0.03, 0.2, 2.0
PSEUDO = "pseudo (Philox)"


def closed_form():
    d1 = (np.log(S0 / K) + (R + 0.5 * SIGMA**2) * TAU) / (SIGMA * np.sqrt(TAU))
    d2 = d1 - SIGMA * np.sqrt(TAU)
    return S0 * norm.cdf(d1) - K * np.exp(-R * TAU) * norm.cdf(d2)


def price(sampler, num_paths, root_seed=0, device=None):
    model = BlackScholesModel(0.0, spot=S0, rate=R, sigma=SIGMA, asset_id="eq")
    option = EuropeanOption(Equity("eq"), TAU, K, OptionType.CALL, asset_id="eq")
    controller = SimulationController(
        netting_sets=[NettingSet(name="opt", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths, num_paths_presim=0,
        # exact transitions so the plot shows pure SAMPLING error
        num_steps=4, simulation_scheme=SimulationScheme.ANALYTICAL,
        sampler=sampler, root_seed=root_seed, device=device,
    )
    r = controller.run_simulation()
    return float(r.get_results("opt", "pv", evaluation_idx=0))


def main(save_plot=True, path_counts=(1024, 4096, 16384, 65536, 262144), device=None):
    device = resolve_device(device)
    ref = closed_form()
    print(f"closed form: {ref:.6f}")
    errors = {PSEUDO: [], "scrambled Sobol": []}
    for n in path_counts:
        e_p = abs(price("pseudo", n, device=device) - ref)
        e_s = abs(price("sobol", n, device=device) - ref)
        errors[PSEUDO].append(e_p)
        errors["scrambled Sobol"].append(e_s)
        print(f"N={n:>7}  pseudo err {e_p:.2e}   sobol err {e_s:.2e}"
              f"   ratio {e_p / max(e_s, 1e-300):.1f}x")
    path = None
    if save_plot:
        path = save_profile_plot(
            "pv_sobol_convergence.png", list(path_counts), errors,
            "European call PV |error| vs paths (log-log)", ylabel="|PV error|",
            loglog=True,
        )
        print(f"saved {path}")
    return path, errors


if __name__ == "__main__":
    main()
