"""Basket option: geometric closed form + control-variate variance reduction.

Port of ``examples/pv_basket_option.py`` (reference
tests/pv_tests/pv_basket_option.py): the geometric basket under multi-asset
Black-Scholes has a closed form; the arithmetic basket priced with the
geometric payoff as a control variate cuts the MC error by an order of
magnitude at identical path counts.  The paths come from K2 (BS-multi
exact).

Run: python examples_torch/pv_basket_option.py
"""

import os
import sys

if __package__ in (None, ""):  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_risk_engine_tpu_torch import (
    BasketOption,
    BasketOptionType,
    BlackScholesMulti,
    NettingSet,
    OptionType,
    PVMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    resolve_device,
)

ASSETS = ["a0", "a1", "a2", "a3"]


def _model():
    corr = 0.3 * np.ones((4, 4)) + 0.7 * np.eye(4)
    return BlackScholesMulti(
        0.0, rate=0.03, asset_ids=ASSETS, spots=[100.0, 95.0, 105.0, 110.0],
        volatilities=[0.2, 0.25, 0.18, 0.3], correlation_matrix=corr,
    )


def run(basket_type, use_cv, num_paths, device=None):
    device = resolve_device(device)
    model = _model()
    option = BasketOption(
        maturity=2.0, asset_ids=ASSETS, weights=[0.25] * 4, strike=100.0,
        option_type=OptionType.CALL, basket_option_type=basket_type,
        use_variation_reduction=use_cv,
    )
    controller = SimulationController(
        netting_sets=[NettingSet(name="basket", products=[option])],
        model=model,
        risk_metrics=RiskMetrics(metrics=[PVMetric()]),
        num_paths_mainsim=num_paths,
        num_paths_presim=0,
        num_steps=1,
        simulation_scheme=SimulationScheme.ANALYTICAL,
        device=device,
    )
    results = controller.run_simulation()
    pv = float(results.get_results("basket", "pv", evaluation_idx=0))
    se = float(results.get_mc_error("basket", "pv", evaluation_idx=0))
    return pv, se, option, model


def main(num_paths=100_000, save_plot=False, device=None):
    device = resolve_device(device)
    geo, geo_se, option, model = run(BasketOptionType.GEOMETRIC, False, num_paths, device)
    geo_analytic = float(option.compute_pv_analytically(model,
                                                        model.initial_params(device=device)))
    arith, arith_se, _, _ = run(BasketOptionType.ARITHMETIC, False, num_paths, device)
    arith_cv, cv_se, _, _ = run(BasketOptionType.ARITHMETIC, True, num_paths, device)
    print(f"geometric MC        {geo:10.6f} +- {geo_se:.6f}  (analytic {geo_analytic:.6f})")
    print(f"arithmetic plain MC {arith:10.6f} +- {arith_se:.6f}")
    print(f"arithmetic + CV     {arith_cv:10.6f} +- {cv_se:.6f}"
          f"  (variance reduction {arith_se / cv_se:.1f}x)")
    assert abs(geo - geo_analytic) < 4.0 * geo_se + 1e-10
    assert cv_se < arith_se
    return {"geometric": geo, "geometric_analytic": geo_analytic,
            "arithmetic": arith, "arithmetic_cv": arith_cv,
            "se_plain": arith_se, "se_cv": cv_se}


if __name__ == "__main__":
    main()
