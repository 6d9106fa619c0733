"""European option on a zero-coupon bond under Vasicek vs the closed form.

Port of ``examples/pv_european_bond_option.py`` (reference
tests/pv_tests/pv_european_bond_option.py): the Jamshidian-style
bond-option formula prices an option on a zero bond exactly; the MC
estimate under the exact OU transition converges onto it across strikes.
The paths come from K2 (Vasicek exact).

One deviation from the JAX script: the simulation takes ``NUM_STEPS`` = 64
substeps to the exercise date, not one.  The numeraire is a left Riemann
sum of the short rate (quirk Q3, kept on purpose), so with one substep the
deflator is the constant exp(-2 r0) and the estimate carries a bias the
closed form does not: at the default 200,000 paths the strike-0.80 call
sits 6-8 SE above it, and the JAX script fails its own assert there too.
At 64 substeps that bias is below 2 SE at every strike.

Run: python examples_torch/pv_european_bond_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import print_profile_table, save_profile_plot, vasicek_model
from montecarlo_risk_engine_tpu_torch import (
    Bond,
    EuropeanOption,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)

NUM_STEPS = 64


def run(strike, num_paths, device=None):
    device = resolve_device(device)
    model = vasicek_model()
    bond = Bond(startdate=0.0, maturity=5.0, notional=1.0, tenor=5.0,
                pays_notional=True, fixed_rate=0.0, asset_id="irs")
    option = EuropeanOption(bond, exercise_date=2.0, strike=strike,
                            option_type=OptionType.CALL, asset_id="irs")
    controller = SimulationController(
        netting_sets=[NettingSet(name="bondopt", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=0,
        num_steps=NUM_STEPS,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    pv = float(results.get_results("bondopt", "pv", evaluation_idx=0))
    se = float(results.get_mc_error("bondopt", "pv", evaluation_idx=0))
    analytic = float(option.compute_pv_bond_option_analytically(
        model, model.initial_params(device=device)))
    return pv, se, analytic


def main(num_paths=200_000, save_plot=True, device=None):
    device = resolve_device(device)
    strikes = np.array([0.80, 0.85, 0.90, 0.95])
    mc, analytic = [], []
    for k in strikes:
        pv, se, ref = run(float(k), num_paths, device)
        mc.append(pv)
        analytic.append(ref)
        print(f"strike={k:.2f}  MC={pv:.6f} +- {se:.6f}  analytic={ref:.6f}")
        assert abs(pv - ref) < 4.0 * se + 5e-5
    curves = {"MC": np.array(mc), "Jamshidian closed form": np.array(analytic)}
    print_profile_table(strikes, curves)
    if save_plot:
        path = save_profile_plot(
            "pv_european_bond_option.png", strikes, curves,
            "Zero-bond call under Vasicek — MC vs closed form",
            ylabel="PV",
        )
        print(f"saved {path}")
        return path
    return curves


if __name__ == "__main__":
    main()
