"""The remaining model pieces and public names of the port against the JAX
package: the Milstein steps of Heston, Black-Scholes and CIR++, CIR++'s
analytical step, the ModelConfig ANALYTICAL covariance, the CDS bootstrap,
``set_real_dtype`` / ``SettlementType`` / ``PolyomialRegression``, and the
analytic PV evaluation (closed forms plus the Monte Carlo remainder) — on
the same numbers (f64, numpy-made states, the JAX engine's own threefry
draws injected)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu.engine.engine import simulate_paths as jax_simulate_paths
from montecarlo_risk_engine_tpu.helpers.cs_helper import CSHelper as JaxCSHelper
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.helpers.cs_helper import CSHelper
from test_torch_hybrid_blocks import make, mixed
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

TIMELINE = (0.0, 0.25, 0.6, 1.0, 1.75)
HAZARDS = {1.0: 0.02, 2.0: 0.025, 3.0: 0.03, 5.0: 0.035}
JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")


def step_model(name, pkg):
    if name == "heston":
        return pkg.HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0,
                               theta=0.06, v0=0.04, asset_id="eq")
    if name == "bs":
        return pkg.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq")
    return pkg.CIRPPModel(0.0, "cp", HAZARDS, kappa=0.5, theta=0.03, volatility=0.05, y0=0.03)


def step_state(name, rs, n):
    if name == "heston":
        return np.stack([np.log(100.0) + 0.1 * rs.standard_normal(n), 0.04 * rs.random(n)], -1)
    if name == "bs":
        return 100.0 * np.exp(0.2 * rs.standard_normal((n, 1)))
    return np.stack([0.03 + 0.01 * rs.random(n), 0.05 * rs.random(n)], axis=-1)


@pytest.mark.parametrize("name,scheme", [("heston", "MILSTEIN"), ("bs", "MILSTEIN"),
                                         ("cirpp", "MILSTEIN"), ("cirpp", "ANALYTICAL")])
def test_steps_match_jax(name, scheme):
    """One step on numpy-made states and draws, then the engine on the JAX
    engine's draws; none of these schemes takes a path kernel."""
    jm, pm = step_model(name, mj), step_model(name, mt)
    jp, pp = jm.initial_params(), pm.initial_params()
    js, ps = mj.SimulationScheme[scheme], mt.SimulationScheme[scheme]
    rs = np.random.default_rng(11)
    n = 512
    state = step_state(name, rs, n)
    noise = 0.2 * rs.standard_normal((n, pm.simulation_dim))
    ref = np.asarray(jm.step(jp, js, 0.5, 0.75, jnp.asarray(state), jnp.asarray(noise)))
    out = pm.step(pp, ps, 0.5, 0.75, torch.from_numpy(state), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-15)
    if scheme == "ANALYTICAL":
        np.testing.assert_allclose(pm.covariance_matrix(pp, 0.25).numpy(),
                                   np.asarray(jm.covariance_matrix(jp, 0.25)), rtol=1e-14)
        for (ja, jv), (pa, pv) in zip(jm.analytic_factor_loadings(jp),
                                      pm.analytic_factor_loadings(pp)):
            np.testing.assert_allclose([float(pa), float(pv)], [float(ja), float(jv)], rtol=1e-15)
    assert not pm.supports_kernel_paths(ps) and not jm.supports_pallas_paths(js)

    steps, phase = 3, jax_rng.PHASE_MAINSIM
    states = simulate_paths(pm, pp, ps, TIMELINE, 128, steps, phase,
                            noise_source=jax_engine_normals(2, phase, len(TIMELINE) * steps, 128,
                                                            pm.simulation_dim))
    np.testing.assert_allclose(states.numpy(), np.asarray(jax_simulate_paths(
        jm, jp, js, TIMELINE, 128, steps, phase, root_seed=2)), rtol=1e-12, atol=1e-15)


def test_model_config_analytical_covariance_matches_jax():
    A = mt.SimulationScheme.ANALYTICAL
    jm, pm = mixed(mj), mixed(mt)
    for dt in (0.05, 0.25, 1.0):
        np.testing.assert_allclose(pm.covariance_matrix(pm.initial_params(), dt).numpy(),
                                   np.asarray(jm.covariance_matrix(jm.initial_params(), dt)),
                                   rtol=1e-12, atol=1e-16)
    # a pair without Gaussian factor loadings raises, as in the JAX package
    for pkg in (mj, mt):
        config = pkg.ModelConfig([step_model("heston", pkg), make("vasicek", pkg)])
        with pytest.raises(NotImplementedError, match="factor loadings"):
            config.covariance_matrix(config.initial_params(), 0.25)

    # the engine under ANALYTICAL: Vasicek, CIR++ and Black-Scholes jointly
    def hybrid(pkg):
        return pkg.ModelConfig([make("vasicek", pkg), make("cirpp", pkg), make("bs", pkg)],
                               inter_asset_correlation_matrix=[np.array([[0.3]]),
                                                               np.array([[-0.2]]),
                                                               np.array([[0.25]])])

    jh, ph = hybrid(mj), hybrid(mt)
    assert not ph.supports_kernel_paths(A)
    phase = jax_rng.PHASE_PRESIM
    states = simulate_paths(ph, ph.initial_params(), A, TIMELINE, 128, 2, phase,
                            noise_source=jax_engine_normals(5, phase, len(TIMELINE) * 2, 128, 3))
    np.testing.assert_allclose(states.numpy(), np.asarray(jax_simulate_paths(
        jh, jh.initial_params(), mj.SimulationScheme.ANALYTICAL, TIMELINE, 128, 2, phase,
        root_seed=5)), rtol=1e-12, atol=1e-15)


def test_bootstrap_hazards_matches_jax():
    payment_days = np.arange(0.25, 5.01, 0.25)
    dfs = np.exp(-0.02 * payment_days)
    maturities = np.array([1.0, 3.0, 5.0])
    for spreads, recovery in (([0.02, 0.02, 0.02], 0.0), ([0.01, 0.018, 0.025], 0.4)):
        ours = CSHelper().bootstrap_hazards(spreads, maturities, payment_days, dfs, recovery)
        ref = JaxCSHelper().bootstrap_hazards(spreads, maturities, payment_days, dfs, recovery)
        np.testing.assert_allclose(ours, ref, rtol=1e-13)
    flat = CSHelper().bootstrap_hazards([0.02] * 3, maturities, payment_days, dfs, 0.0)
    assert all(abs(h - 0.02) < 2e-3 for h in flat)  # tests/test_models_extended.py:33
    with pytest.raises(ValueError, match="discount factor per payment day"):
        CSHelper().bootstrap_hazards([0.02], maturities[:1], payment_days, dfs[:-1], 0.4)
    hz = torch.tensor([0.02, 0.03], dtype=torch.float64)
    tenors = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert abs(float(CSHelper().probability_of_default(hz, tenors, 1.5))
               - (1.0 - np.exp(-(0.02 + 0.03 * 0.5)))) < 1e-15


def test_public_names_match_jax():
    for name in ("set_real_dtype", "SettlementType", "PolyomialRegression"):
        assert name in mj.__all__ and name in mt.__all__
    assert [(m.name, m.value) for m in mt.SettlementType] == [
        (m.name, m.value) for m in mj.SettlementType]
    assert mt.PolyomialRegression is mt.PolynomialRegression
    assert set(mj.__all__) - set(mt.__all__) <= {"enable_compilation_cache"}


def euro_book(pkg):
    options = [pkg.EuropeanOption(pkg.Equity("eq"), t, k, pkg.OptionType.CALL if i % 2 == 0
                                  else pkg.OptionType.PUT, asset_id="eq")
               for i, (t, k) in enumerate(((0.5, 95.0), (1.0, 100.0), (1.5, 108.0)))]
    return ([pkg.NettingSet(name="euro", products=options)],
            pkg.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq"),
            pkg.RiskMetrics([pkg.PVMetric()]))


def jax_normals_f32(phase, num_counters, num_paths):
    """The JAX engine's threefry normals in float32 (its draws under
    ``set_real_dtype(jnp.float32)``)."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(0), phase)
    draw = lambda c: jax_rng.normals(jax_rng.step_key(phase_k, c, jax_rng.PURPOSE_NORMAL),
                                     (num_paths, 1), jnp.float32)
    z = torch.from_numpy(np.array(jax.jit(jax.vmap(draw))(jnp.arange(num_counters))))
    return lambda counter: (z[counter], None)


def test_float32_working_dtype_matches_jax():
    """``set_real_dtype(float32)`` in both packages: a differentiated
    European book on the same float32 draws, rtol 1e-5; ``None`` restores
    float64."""
    n = 1024
    try:
        mj.set_real_dtype(jnp.float32)
        mt.set_real_dtype(torch.float32)
        jc = mj.SimulationController(*euro_book(mj), n, 0, 2, mj.SimulationScheme.ANALYTICAL,
                                     differentiate=True, **JAX_FLAGS)
        jr = jc.run_simulation()
        noise = {jax_rng.PHASE_MAINSIM: jax_normals_f32(jax_rng.PHASE_MAINSIM,
                                                        len(jc.simulation_timeline) * 2, n)}
        pc = mt.SimulationController(*euro_book(mt), n, 0, 2, mt.SimulationScheme.ANALYTICAL,
                                     differentiate=True, device="cpu", noise_source=noise)
        assert pc.model.initial_params()[0].dtype == torch.float32
        pr = pc.run_simulation()
        np.testing.assert_allclose(pr.get_results("euro", "pv"), jr.get_results("euro", "pv"),
                                   rtol=1e-5)
        np.testing.assert_allclose(pr.get_mc_error("euro", "pv"), jr.get_mc_error("euro", "pv"),
                                   rtol=1e-5)
        for param in jr.get_model_param_names():
            np.testing.assert_allclose(pr.get_derivatives("euro", "pv", param=param),
                                       jr.get_derivatives("euro", "pv", param=param), rtol=1e-5,
                                       err_msg=param)
    finally:
        mj.set_real_dtype(None)
        mt.set_real_dtype(None)
    assert mt.BlackScholesModel(0.0, 100.0, 0.03, 0.25).initial_params()[0].dtype == torch.float64


def analytic_book(pkg):
    """Analytic PV (controller.py:956-1001): a netting set of closed forms
    only (no simulation for it, zero SE) and one that adds a discretely
    monitored barrier, whose Monte Carlo mean and SE the PV takes on."""
    call, put = pkg.OptionType.CALL, pkg.OptionType.PUT
    europeans = [pkg.EuropeanOption(pkg.Equity("eq"), t, k, call if i % 2 == 0 else put,
                                    asset_id="eq")
                 for i, (t, k) in enumerate(((0.5, 95.0), (1.0, 100.0), (1.5, 108.0)))]
    barrier = pkg.BarrierOption(0.0, 1.0, 100.0, 6, call, 125.0, pkg.BarrierOptionType.UPANDOUT,
                                asset_id="eq")
    netting_sets = [pkg.NettingSet(name="closed", products=europeans[:2]),
                    pkg.NettingSet(name="mixed", products=[europeans[2], barrier])]
    metric = pkg.PVMetric(evaluation_type=pkg.Metric.EvaluationType.ANALYTICAL)
    return (netting_sets, pkg.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq"),
            pkg.RiskMetrics([metric]))


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_analytic_pv_evaluation_matches_jax(differentiate):
    n = 512
    jc = mj.SimulationController(*analytic_book(mj), n, 0, 2, mj.SimulationScheme.ANALYTICAL,
                                 differentiate=differentiate, **JAX_FLAGS)
    jr = jc.run_simulation()
    noise = {jax_rng.PHASE_MAINSIM: jax_engine_normals(0, jax_rng.PHASE_MAINSIM,
                                                       len(jc.simulation_timeline) * 2, n, 1)}
    netting_sets, model, metrics = analytic_book(mt)
    pc = mt.SimulationController(netting_sets, model, metrics, n, 0, 2,
                                 mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 device="cpu", noise_source=noise)
    assert pc._analytic_ids == {0, 1, 2} and pc._simulates()
    pr = pc.run_simulation()
    params = model.initial_params()
    closed = sum(float(p.compute_pv_analytically(model, params)) for p in netting_sets[0].products)
    np.testing.assert_allclose(float(pr.get_results("closed", "pv", evaluation_idx=0)), closed,
                               rtol=1e-14)
    assert float(pr.get_mc_error("closed", "pv", evaluation_idx=0)) == 0.0
    assert float(pr.get_mc_error("mixed", "pv", evaluation_idx=0)) > 0.0
    for ns in ("closed", "mixed"):
        np.testing.assert_allclose(pr.get_results(ns, "pv"), jr.get_results(ns, "pv"), rtol=1e-10)
        np.testing.assert_allclose(pr.get_mc_error(ns, "pv"), jr.get_mc_error(ns, "pv"),
                                   rtol=1e-10, atol=1e-15)
        if differentiate:
            for param in jr.get_model_param_names():
                np.testing.assert_allclose(pr.get_derivatives(ns, "pv", param=param),
                                           jr.get_derivatives(ns, "pv", param=param), rtol=1e-8,
                                           atol=1e-12, err_msg=f"{ns} {param}")


def test_bond_option_closed_form_matches_jax():
    for strike, kind in ((0.8, "CALL"), (0.9, "PUT"), (0.95, "CALL")):
        def option(pkg):
            bond = pkg.Bond(startdate=0.0, maturity=5.0, notional=1.0, tenor=5.0,
                            pays_notional=True, fixed_rate=0.0, asset_id="irs")
            return pkg.EuropeanOption(bond, 2.0, strike, pkg.OptionType[kind], asset_id="irs")

        jm, pm = make("vasicek", mj), make("vasicek", mt)
        np.testing.assert_allclose(
            float(option(mt).compute_pv_bond_option_analytically(pm, pm.initial_params())),
            float(option(mj).compute_pv_bond_option_analytically(jm, jm.initial_params())),
            rtol=1e-10)  # a deep out-of-the-money put cancels two terms ~1e5 times its value
    with pytest.raises(TypeError, match="Bond"):
        mt.EuropeanOption(mt.Equity("irs"), 2.0, 0.9, mt.OptionType.CALL, asset_id="irs") \
            .compute_pv_bond_option_analytically(pm, pm.initial_params())
