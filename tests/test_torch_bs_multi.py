"""The port's BlackScholesMulti, BasketOption and the ANALYTICAL steps of
Black-Scholes and Vasicek, held against the JAX package on the same numbers
(f64, numpy-made inputs, the JAX engine's own threefry draws injected)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu_torch import SimulationScheme, params_from_numpy
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

ASSETS = ["a0", "a1", "a2", "a3"]
TIMELINE = (0.0, 0.5, 0.75, 1.25, 2.0)
JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")


def bs_multi(pkg):
    """The 4-asset model of benchmarks/pv_european_book.py:38-46."""
    corr = np.full((4, 4), 0.35)
    np.fill_diagonal(corr, 1.0)
    return pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=ASSETS,
                                 spots=[95.0 + 7.5 * i for i in range(4)],
                                 volatilities=[0.18 + 0.03 * i for i in range(4)],
                                 correlation_matrix=corr)


def scheme_of(pkg, scheme):
    return pkg.SimulationScheme[scheme.name]


def test_param_names_and_values_match_jax():
    jm, pm = bs_multi(mj), bs_multi(mt)
    assert pm.get_model_param_names() == jm.get_model_param_names()
    assert pm.get_model_param_names()[:2] == ["spot[a0]", "spot[a1]"]
    assert pm.get_model_param_names()[-1] == "rate" and len(pm.get_model_param_names()) == 9
    ported = params_from_numpy([np.asarray(p) for p in jm.initial_params()])
    assert all(torch.equal(a, b) for a, b in zip(ported, pm.initial_params()))
    jp, pp = jm.initial_params(), pm.initial_params()
    np.testing.assert_array_equal(pm.correlation_matrix(pp, SimulationScheme.EULER).numpy(),
                                  np.asarray(jm.correlation_matrix(jp, mj.SimulationScheme.EULER)))
    np.testing.assert_allclose(pm.covariance_matrix(pp, 0.25).numpy(),
                               np.asarray(jm.covariance_matrix(jp, 0.25)), rtol=1e-15)
    assert pm.supports_kernel_paths(SimulationScheme.ANALYTICAL)
    assert not pm.supports_kernel_paths(SimulationScheme.EULER)


@pytest.mark.parametrize("scheme", [SimulationScheme.ANALYTICAL, SimulationScheme.EULER])
def test_engine_matches_jax_engine_on_injected_noise(scheme):
    n, phase = 256, jax_rng.PHASE_MAINSIM
    jm, pm = bs_multi(mj), bs_multi(mt)
    ref = np.asarray(jax_simulate_paths(jm, jm.initial_params(), scheme_of(mj, scheme), TIMELINE,
                                        n, 2, phase, root_seed=3))
    states = simulate_paths(pm, pm.initial_params(), scheme, TIMELINE, n, 2, phase,
                            noise_source=jax_engine_normals(3, phase, len(TIMELINE) * 2, n, 4),
                            device="cpu")
    assert states.shape == ref.shape == (len(TIMELINE), n, 4)
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,scheme", [("bs", SimulationScheme.ANALYTICAL),
                                         ("vasicek", SimulationScheme.ANALYTICAL),
                                         ("vasicek", SimulationScheme.MILSTEIN)])
def test_single_asset_steps_and_inversions_match_jax(name, scheme):
    """Black-Scholes and Vasicek exact steps, covariances and inversions
    against the JAX models, and their engines on the JAX engine's draws."""
    def make(pkg):
        if name == "bs":
            return pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq")
        return pkg.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                                volatility=0.012, asset_id="irs")

    jm, pm = make(mj), make(mt)
    jp, pp = jm.initial_params(), pm.initial_params()
    rs = np.random.default_rng(4)
    n, t1, t2 = 512, 0.75, 1.0
    first = 100.0 * np.exp(0.2 * rs.standard_normal(n)) if name == "bs" \
        else 0.03 + 0.01 * rs.standard_normal(n)
    state = np.stack([first] + ([0.1 * rs.random(n)] if name == "vasicek" else []), axis=-1)
    noise = 0.01 * rs.standard_normal((n, 1))
    js = scheme_of(mj, scheme)
    ref = np.asarray(jm.step(jp, js, t1, t2, jnp.asarray(state), jnp.asarray(noise)))
    out = pm.step(pp, scheme, t1, t2, torch.from_numpy(state), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14, atol=1e-16)
    np.testing.assert_allclose(pm.invert_noise(pp, scheme, t1, t2, torch.from_numpy(state), out).numpy(),
                               np.asarray(jm.invert_noise(jp, js, t1, t2, jnp.asarray(state),
                                                          jnp.asarray(ref))),
                               rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(pm.covariance_matrix(pp, 0.25).numpy(),
                               np.asarray(jm.covariance_matrix(jp, 0.25)), rtol=1e-15)
    assert pm.supports_kernel_paths(scheme) == jm.supports_pallas_paths(js)
    states = simulate_paths(pm, pp, scheme, TIMELINE, 128, 2, 43,
                            noise_source=jax_engine_normals(1, 43, len(TIMELINE) * 2, 128, 1),
                            device="cpu")
    np.testing.assert_allclose(states.numpy(),
                               np.asarray(jax_simulate_paths(jm, jp, js, TIMELINE, 128, 2, 43,
                                                             root_seed=1)),
                               rtol=1e-12, atol=1e-15)


def basket_book(pkg, model_pkg):
    """Four European options and five baskets (arithmetic, geometric,
    control variate, equal-weight geometric of every asset) in three
    netting sets."""
    call, put = pkg.OptionType.CALL, pkg.OptionType.PUT
    europeans = [pkg.EuropeanOption(pkg.Equity(ASSETS[i]), 0.5 + 0.75 * i, 90.0 + 10.0 * i,
                                    call if i % 2 == 0 else put, asset_id=ASSETS[i])
                 for i in range(4)]
    arith, geo = pkg.BasketOptionType.ARITHMETIC, pkg.BasketOptionType.GEOMETRIC
    baskets = [
        pkg.BasketOption(0.75, ASSETS[:2], [0.625, 0.375], 100.0, call, geo),
        pkg.BasketOption(1.25, ASSETS[:3], [1 / 3] * 3, 105.0, put, arith),
        pkg.BasketOption(2.0, ASSETS, [0.4, 0.35, 0.15, 0.10], 100.0, call, arith),
        pkg.BasketOption(2.0, ASSETS, [0.25] * 4, 100.0, call, arith,
                         use_variation_reduction=True),
        pkg.BasketOption(1.25, ASSETS, [0.25] * 4, 98.0, put, geo),
    ]
    netting_sets = [pkg.NettingSet(name="europeans", products=europeans),
                    pkg.NettingSet(name="baskets", products=baskets[:3]),
                    pkg.NettingSet(name="all_assets", products=baskets[3:])]
    return netting_sets, bs_multi(model_pkg), pkg.RiskMetrics(metrics=[pkg.PVMetric()])


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_european_and_basket_book_matches_jax_controller(differentiate):
    n = 1024
    jc = mj.SimulationController(*basket_book(mj, mj), n, 0, 2, mj.SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, **JAX_FLAGS)
    jr = jc.run_simulation()
    noise = {jax_rng.PHASE_MAINSIM: jax_engine_normals(0, jax_rng.PHASE_MAINSIM,
                                                       len(jc.simulation_timeline) * 2, n, 4)}
    pc = mt.SimulationController(*basket_book(mt, mt), n, 0, 2, SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, device="cpu", noise_source=noise)
    assert pc.simulation_timeline == jc.simulation_timeline and not pc._kernel_active
    pr = pc.run_simulation()
    if differentiate:
        assert pc._grad_mode_resolved == "rev"  # P = 9 > V = 3
    for ns in jr.get_netting_set_names():
        np.testing.assert_allclose(pr.get_results(ns, "pv"), jr.get_results(ns, "pv"), rtol=1e-10)
        np.testing.assert_allclose(pr.get_mc_error(ns, "pv"), jr.get_mc_error(ns, "pv"),
                                   rtol=1e-10)
        if differentiate:
            for param in jr.get_model_param_names():
                np.testing.assert_allclose(pr.get_derivatives(ns, "pv", param=param),
                                           jr.get_derivatives(ns, "pv", param=param),
                                           rtol=1e-8, atol=1e-12, err_msg=f"{ns} {param}")


@pytest.mark.parametrize("kind", ["CALL", "PUT"])
def test_basket_closed_form_matches_jax(kind):
    jm, pm = bs_multi(mj), bs_multi(mt)
    for maturity, strike in ((0.75, 95.0), (2.0, 110.0)):
        jb = mj.BasketOption(maturity, ASSETS, [0.25] * 4, strike, mj.OptionType[kind],
                             mj.BasketOptionType.GEOMETRIC)
        pb = mt.BasketOption(maturity, ASSETS, [0.25] * 4, strike, mt.OptionType[kind],
                             mt.BasketOptionType.GEOMETRIC)
        np.testing.assert_allclose(float(pb.compute_pv_analytically(pm, pm.initial_params())),
                                   float(jb.compute_pv_analytically(jm, jm.initial_params())),
                                   rtol=1e-12)


def test_european_closed_form_under_bs_multi_matches_jax():
    jm, pm = bs_multi(mj), bs_multi(mt)
    for i in range(4):
        jo = mj.EuropeanOption(mj.Equity(ASSETS[i]), 1.5, 100.0, mj.OptionType.PUT, asset_id=ASSETS[i])
        po = mt.EuropeanOption(mt.Equity(ASSETS[i]), 1.5, 100.0, mt.OptionType.PUT, asset_id=ASSETS[i])
        assert po.supports_analytic_exposure(pm) and po.supports_analytic_pv(pm)
        np.testing.assert_allclose(float(po.compute_pv_analytically(pm, pm.initial_params())),
                                   float(jo.compute_pv_analytically(jm, jm.initial_params())),
                                   rtol=1e-13)
        spot = np.linspace(80.0, 120.0, 7)
        np.testing.assert_allclose(
            po.compute_discounted_exposure_analytically(0.5, torch.from_numpy(spot),
                                                        torch.tensor(1.01, dtype=torch.float64), pm,
                                                        pm.initial_params()).numpy(),
            np.asarray(jo.compute_discounted_exposure_analytically(0.5, jnp.asarray(spot), 1.01, jm,
                                                                   jm.initial_params())),
            rtol=1e-13)
