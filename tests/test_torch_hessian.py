"""Second-order sensitivities of the port against the JAX package.

  * The analytic route: a Black-Scholes call under ``EvaluationType.
    ANALYTICAL`` is its closed form, so its Hessian gamma and vomma equal
    the closed-form gamma and vomma (tests/test_heston_and_hessian.py:65).
  * Monte Carlo books on the JAX engine's own threefry draws (injected
    through ``noise_source``): the port's Hessians equal the JAX
    controller's to rtol 1e-9, on the forward branch (a Black-Scholes book
    with EPE and PFE), the reverse branch (a BS-multi PV book, P > V) and
    the CVA book of tests/test_cva.py:118, whose LSM fits carry both
    tangent levels, on both branches (test_torch_hessian_lsm.py).
  * The kernel routes (the plain versions of K1 with emitted draws and of
    K2 with recovered draws, on the CPU): second order through the
    reconstruction equals direct second-order AD through the engine on the
    kernel's own draws (tests/test_pallas_ad.py:200), and the kernel runs
    once per phase for the whole Hessian run.
"""

import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")
ASSETS = ["a0", "a1", "a2", "a3"]


def hessian(results, ns, metric, k):
    """[P, P] Hessian of evaluation k, H[i][j] = d^2 value / d p_i d p_j."""
    names = results.get_model_param_names()
    return np.array([[results.get_second_derivatives(ns, metric, param1=a, param2=b,
                                                     evaluation_idx=k) for b in names]
                     for a in names])


def hessians(results):
    """{(netting set, metric, evaluation): [P, P]} of a run."""
    out = {}
    for ns in results.get_netting_set_names():
        for metric in results.get_metric_names():
            for k in range(len(results.get_results(ns, metric))):
                out[ns, metric, k] = hessian(results, ns, metric, k)
    return out


def assert_symmetric(hess, rtol=1e-10):
    for key, h in hess.items():
        np.testing.assert_allclose(h, h.T, rtol=rtol, atol=1e-12 * max(1.0, np.abs(h).max()),
                                   err_msg=str(key))


# -- the analytic route -------------------------------------------------------------


def analytic_book(pkg):
    model = pkg.BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2)
    product = pkg.EuropeanOption(pkg.Equity(), exercise_date=2.0, strike=110.0,
                                 option_type=pkg.OptionType.CALL)
    metrics = pkg.RiskMetrics([pkg.PVMetric(evaluation_type=pkg.Metric.EvaluationType.ANALYTICAL)])
    return [pkg.NettingSet(name="ns", products=[product])], model, metrics


def test_analytic_route_gamma_and_vomma_match_closed_forms_and_jax():
    jc = mj.SimulationController(*analytic_book(mj), 1, 0, 1, mj.SimulationScheme.ANALYTICAL,
                                 differentiate=True, use_pallas=False)
    jc.compute_higher_derivatives()
    jr = jc.run_simulation()
    netting_sets, model, metrics = analytic_book(mt)
    pc = mt.SimulationController(netting_sets, model, metrics, 1, 0, 1,
                                 mt.SimulationScheme.ANALYTICAL, differentiate=True, device="cpu")
    pc.compute_higher_derivatives()
    assert not pc._simulates() and pc._phases() == []  # closed forms only: no simulation
    pr = pc.run_simulation()
    product, params = netting_sets[0].products[0], model.initial_params()
    gamma = float(product.compute_dDeltadSpot_analytically(model, params))
    vomma = float(product.compute_dVegadSigma_analytically(model, params))
    h = lambda r, a, b: r.get_second_derivatives("ns", "pv", param1=a, param2=b, evaluation_idx=0)
    assert abs(h(pr, "spot", "spot") - gamma) < 1e-9
    assert abs(h(pr, "volatility", "volatility") - vomma) < 1e-9
    np.testing.assert_allclose(hessian(pr, "ns", "pv", 0), hessian(jr, "ns", "pv", 0),
                               rtol=1e-9, atol=1e-12)
    assert float(pr.get_mc_error("ns", "pv", evaluation_idx=0)) == 0.0
    np.testing.assert_allclose(float(pr.get_results("ns", "pv", evaluation_idx=0)),
                               float(product.compute_pv_analytically(model, params)), rtol=1e-15)
    assert set(pr.get_second_derivatives("ns", "pv", param1="spot", evaluation_idx=0)) == {
        "spot", "volatility", "rate"}
    assert_symmetric(hessians(pr))
    jm = analytic_book(mj)[1]
    jopt = analytic_book(mj)[0][0].products[0]
    np.testing.assert_allclose(
        [gamma, vomma], [float(jopt.compute_dDeltadSpot_analytically(jm, jm.initial_params())),
                         float(jopt.compute_dVegadSigma_analytically(jm, jm.initial_params()))],
        rtol=1e-13)


# -- Monte Carlo books on the JAX engine's draws --------------------------------------


def bs_exposure_book(pkg):
    """Forward branch: P = 3 <= V = 7 (PV, EPE and PFE on three dates)."""
    call, put = pkg.OptionType.CALL, pkg.OptionType.PUT
    products = [pkg.EuropeanOption(pkg.Equity("eq"), 1.0, 100.0, call, asset_id="eq"),
                pkg.EuropeanOption(pkg.Equity("eq"), 1.5, 95.0, put, asset_id="eq")]
    metrics = pkg.RiskMetrics([pkg.PVMetric(), pkg.EPEMetric(), pkg.PFEMetric(0.9)],
                              exposure_timeline=[0.0, 0.5, 1.0])
    return ([pkg.NettingSet(name="e", products=products)],
            pkg.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq"), metrics)


def bs_multi_model(pkg):
    corr = np.full((4, 4), 0.35)
    np.fill_diagonal(corr, 1.0)
    return pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=ASSETS,
                                 spots=[95.0 + 7.5 * i for i in range(4)],
                                 volatilities=[0.18 + 0.03 * i for i in range(4)],
                                 correlation_matrix=corr)


def bs_multi_book(pkg):
    """Reverse branch: P = 9 > V = 1 (one netting set's PV)."""
    products = [pkg.EuropeanOption(pkg.Equity(ASSETS[i]), 0.5 + 0.5 * i, 90.0 + 7.0 * i,
                                   pkg.OptionType.CALL if i % 2 == 0 else pkg.OptionType.PUT,
                                   asset_id=ASSETS[i]) for i in range(4)]
    return ([pkg.NettingSet(name="book", products=products)], bs_multi_model(pkg),
            pkg.RiskMetrics([pkg.PVMetric()]))


# (book, scheme, sub-steps, presim paths, noise dimension, grad mode)
BOOKS = {
    "bs_exposures_fwd": (bs_exposure_book, "ANALYTICAL", 2, 0, 1, "fwd"),
    "bs_multi_pv_rev": (bs_multi_book, "ANALYTICAL", 1, 0, 4, "rev"),
}


@pytest.mark.parametrize("name", list(BOOKS))
def test_hessian_matches_jax_on_injected_noise(name):
    check_against_jax(*BOOKS[name])


def check_against_jax(make, scheme, steps, presim, sim_dim, mode, batch_products=True):
    """The port's Hessians (and, on the reverse branch, its functional
    jacobian) against the JAX controller's on the JAX engine's draws."""
    n = 512
    jc = mj.SimulationController(*make(mj), n, presim, steps, mj.SimulationScheme[scheme],
                                 differentiate=True, **JAX_FLAGS)
    jc.compute_higher_derivatives()
    jr = jc.run_simulation()
    phases = [jax_rng.PHASE_MAINSIM] + ([jax_rng.PHASE_PRESIM] if presim else [])
    noise = {ph: jax_engine_normals(0, ph, len(jc.simulation_timeline) * steps, n, sim_dim)
             for ph in phases}
    pc = mt.SimulationController(*make(mt), n, presim, steps, mt.SimulationScheme[scheme],
                                 differentiate=True, device="cpu", noise_source=noise,
                                 batch_products=batch_products)
    pc.compute_higher_derivatives()
    pr = pc.run_simulation()
    assert pc._grad_mode_resolved == mode
    hp, hj = hessians(pr), hessians(jr)
    assert hp.keys() == hj.keys()
    for key in hj:
        np.testing.assert_allclose(hp[key], hj[key], rtol=1e-9, atol=1e-12, err_msg=str(key))
    for metric in jr.get_metric_names():  # every metric has second-order signal
        assert max(np.abs(h).max() for key, h in hj.items() if key[1] == metric) > 0.0, metric
    assert_symmetric(hp)

    if mode == "rev":
        # The functional reverse jacobian (the Hessian rows' inner function)
        # equals the autograd.grad jacobian of the first-order results.
        params = pc.model.initial_params(device="cpu")
        values, errors, jac = pc._jacrev(pc._pair_fn(None), params)
        _, _, jac_autograd = pc._jacobian(params)
        np.testing.assert_allclose(jac.numpy(), jac_autograd.numpy(), rtol=1e-12, atol=1e-15)


def test_fit_hessian_forward_over_forward_matches_hessian():
    """The LSM fit's second derivatives by the Hessian rows' forward branch
    (``jvp`` of ``jvp`` under ``vmap``) equal torch.func.hessian's
    (forward over reverse): the fit factors and solves in two steps because
    ``torch.linalg.solve``'s forward rule is wrong under a second tangent."""
    from torch.func import hessian as func_hessian, jvp, vmap

    from montecarlo_risk_engine_tpu_torch.utils.regression import fit_least_squares

    rs = np.random.default_rng(5)
    z = torch.from_numpy(rs.standard_normal(128))
    basis = mt.PolynomialRegression(2).get_regression_matrix

    def value(a, b):
        x = 1.0 + a * z + 0.1 * b * z * z
        coeffs = fit_least_squares(basis(x), torch.clamp(b * x - 0.9, min=0.0))
        return a * (basis(x) @ coeffs.mT).sum()

    p = (torch.tensor(0.3, dtype=torch.float64), torch.tensor(1.2, dtype=torch.float64))
    eye = torch.eye(2, dtype=torch.float64)
    jac = lambda q: vmap(lambda t: jvp(lambda r: value(*r), (q,), (t,))[1])(tuple(eye.unbind(1)))
    rows = torch.stack([jvp(jac, (p,), (tuple(eye[j].unbind()),))[1] for j in range(2)], 1)
    ref = torch.stack([torch.stack(r) for r in func_hessian(value, argnums=(0, 1))(*p)])
    np.testing.assert_allclose(rows.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_no_second_derivatives_unless_asked():
    c = mt.SimulationController(*bs_exposure_book(mt), 64, 0, 1, mt.SimulationScheme.ANALYTICAL,
                                differentiate=True, device="cpu")
    r = c.run_simulation()
    assert r.second_derivatives == [] and len(r.derivatives) == 1
    # Hessians come with a differentiated run only (controller.py:2288)
    c = mt.SimulationController(*bs_exposure_book(mt), 64, 0, 1, mt.SimulationScheme.ANALYTICAL,
                                device="cpu")
    c.compute_higher_derivatives()
    r = c.run_simulation()
    assert r.second_derivatives == [] and r.derivatives == []


# -- the kernel routes --------------------------------------------------------------


def heston_book():
    """Forward branch: P = 7 <= V = 8 (eight calls, a netting set each)."""
    model = mt.HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0,
                           theta=0.06, v0=0.04, asset_id="eq")
    netting_sets = [mt.NettingSet(name=f"call_{t:g}", products=[
        mt.EuropeanOption(mt.Equity("eq"), t, 100.0, mt.OptionType.CALL, asset_id="eq")])
        for t in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)]
    return netting_sets, model, mt.RiskMetrics([mt.PVMetric()])


# (book, scheme, sub-steps, kernel forward the draws come from, grad mode)
KERNEL_BOOKS = {
    "heston_qe_emitted": (heston_book, "QE", 3, "kernel_paths_with_noise", "fwd"),
    "bs_multi_recovered": (lambda: bs_multi_book(mt), "ANALYTICAL", 2, "kernel_paths", "rev"),
}


@pytest.mark.parametrize("name", list(KERNEL_BOOKS))
def test_kernel_route_hessian_matches_engine_on_kernel_draws(name, monkeypatch):
    make, scheme, steps, forward, mode = KERNEL_BOOKS[name]
    n = 256
    kc = mt.SimulationController(*make(), n, 0, steps, mt.SimulationScheme[scheme],
                                 differentiate=True, device="cpu")
    assert kc._kernel_active
    kc.compute_higher_derivatives()
    calls = []
    run_kernel = getattr(kc.model, forward)
    monkeypatch.setattr(kc.model, forward, lambda *a, **k: calls.append(1) or run_kernel(*a, **k))
    kr = kc.run_simulation()
    assert len(calls) == 1  # one kernel run for the jacobian and every Hessian row
    assert kc._grad_mode_resolved == mode

    # the engine on the kernel's own frozen draws: direct second-order AD
    params = kc.model.initial_params(device="cpu")
    draws = kc._kernel_noise_of(params)[mt.rng.PHASE_MAINSIM]
    if isinstance(draws, tuple):
        z, u = draws
        source = lambda c: (z[c], u[c])
    else:
        source = lambda c: (draws[c], None)
    ec = mt.SimulationController(*make(), n, 0, steps, mt.SimulationScheme[scheme],
                                 differentiate=True, device="cpu",
                                 noise_source={mt.rng.PHASE_MAINSIM: source})
    assert not ec._kernel_active
    ec.compute_higher_derivatives()
    er = ec.run_simulation()
    hk, he = hessians(kr), hessians(er)
    for key in he:
        np.testing.assert_allclose(hk[key], he[key], rtol=1e-7, atol=1e-10, err_msg=str(key))
    assert_symmetric(hk)
    for ns in er.get_netting_set_names():
        np.testing.assert_allclose(kr.get_results(ns, "pv"), er.get_results(ns, "pv"),
                                   rtol=1e-9, err_msg=ns)
