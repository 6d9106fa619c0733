"""Bermudan put value vs exercise-right density: European -> American limit.

Port of ``examples/pv_bermudan_option.py`` (reference
tests/pv_tests/pv_bermudan_option.py): LSM-priced Bermudan puts with an
increasing number of exercise dates interpolate between the European price
(one date) and the American limit (dense grid), monotone in the
exercise-date count up to MC error.  The paths come from K2 (Black-Scholes
exact).

Run: python examples_torch/pv_bermudan_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from examples_torch._common import save_profile_plot
from montecarlo_risk_engine_tpu_torch import (
    BermudanOption,
    BlackScholesModel,
    Equity,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)

MATURITY, STRIKE = 1.0, 100.0


def run(n_dates, num_paths, device=None):
    model = BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.3, asset_id="eq")
    dates = np.linspace(MATURITY / n_dates, MATURITY, n_dates)
    option = BermudanOption(Equity("eq"), list(dates), STRIKE, OptionType.PUT,
                            asset_id="eq", itm_only_regression=True)
    controller = SimulationController(
        netting_sets=[NettingSet(name="berm", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    return (float(results.get_results("berm", "pv", evaluation_idx=0)),
            float(results.get_mc_error("berm", "pv", evaluation_idx=0)))


def main(num_paths=100_000, save_plot=True, device=None):
    device = resolve_device(device)
    counts = [1, 2, 4, 8, 16, 32]
    pvs, ses = [], []
    for n in counts:
        pv, se = run(n, num_paths, device)
        pvs.append(pv)
        ses.append(se)
        print(f"exercise dates={n:3d}  pv={pv:9.5f} +- {se:.5f}")
    # one date == European; more rights never cheapen the option (up to noise)
    for a, b, se in zip(pvs, pvs[1:], ses[1:]):
        assert b > a - 4.0 * se, (a, b)
    if save_plot:
        path = save_profile_plot(
            "pv_bermudan_option.png", counts, {"LSM PV": np.array(pvs)},
            "Bermudan put — value vs number of exercise dates (LSM)",
            ylabel="PV",
        )
        print(f"saved {path}")
        return path
    return pvs


if __name__ == "__main__":
    main()
