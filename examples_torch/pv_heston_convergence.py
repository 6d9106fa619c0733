"""Heston Euler vs Andersen-QE convergence to the characteristic-function price.

Port of ``examples/pv_heston_convergence.py`` (reference
tests/pv_tests/pv_european_option_heston.py): prices a European call under
Heston with both discretisations across substep counts and plots the error
against the semi-analytic Fourier price.  The QE runs take the Heston-QE
path kernel K1; the Euler runs the engine.

Run: python examples_torch/pv_heston_convergence.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    Equity,
    EuropeanOption,
    HestonModel,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)


def price(scheme, num_steps, num_paths, device=None):
    model = HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7,
                        kappa=2.0, theta=0.06, v0=0.04, asset_id="eq")
    option = EuropeanOption(Equity("eq"), 1.0, 100.0, OptionType.CALL, asset_id="eq")
    controller = SimulationController(
        netting_sets=[NettingSet(name="opt", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths, num_paths_presim=0,
        num_steps=num_steps, simulation_scheme=scheme,
        device=device,
    )
    r = controller.run_simulation()
    return (float(r.get_results("opt", "pv", evaluation_idx=0)),
            float(r.get_mc_error("opt", "pv", evaluation_idx=0)))


def main(num_paths=100_000, save_plot=True, steps=(1, 2, 4, 8, 16), device=None):
    device = resolve_device(device)
    model = HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7,
                        kappa=2.0, theta=0.06, v0=0.04, asset_id="eq")
    option = EuropeanOption(Equity("eq"), 1.0, 100.0, OptionType.CALL, asset_id="eq")
    ref = float(option.compute_pv_analytically_heston(model))
    print(f"characteristic-function price: {ref:.6f}")

    errors = {"Euler (full truncation)": [], "Andersen QE": []}
    runs = {"Euler (full truncation)": [], "Andersen QE": []}
    for n_steps in steps:
        pv_e, se_e = price(SimulationScheme.EULER, n_steps, num_paths, device)
        pv_q, se_q = price(SimulationScheme.QE, n_steps, num_paths, device)
        errors["Euler (full truncation)"].append(abs(pv_e - ref))
        errors["Andersen QE"].append(abs(pv_q - ref))
        runs["Euler (full truncation)"].append((pv_e, se_e))
        runs["Andersen QE"].append((pv_q, se_q))
        print(f"substeps={n_steps:3d}  euler={pv_e:.6f}±{se_e:.4f}  "
              f"qe={pv_q:.6f}±{se_q:.4f}")

    if save_plot:
        path = save_profile_plot(
            "pv_heston_convergence.png", list(steps), errors,
            "Heston discretisation error vs substeps (1y ATM call)",
            ylabel="|PV - CF price|",
        )
        print(f"saved {path}")
        return path
    return {"cf": ref, "runs": runs, "steps": tuple(steps), "maturity": option.exercise_date}


if __name__ == "__main__":
    main()
