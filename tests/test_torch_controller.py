"""The PyTorch port's SimulationController on the Heston-QE European book.

Parity: the JAX controller (scan engine, per-product valuation) and the
port's engine see the same threefry draws — the port through its
``noise_source`` seam — so values, standard errors and gradients must agree
to rounding.  The plain path kernel is held against the Heston
characteristic-function price.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths

torch.set_num_threads(1)

MODEL_KW = dict(spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06, v0=0.04)
MATURITIES = tuple(round(0.1 * (i + 1), 10) for i in range(10))
NUM_STEPS = 4


def slice_book(pkg, martingale_correction=False):
    """Ten netting sets, each one ATM call; maturities 0.1 .. 1.0."""
    model = pkg.HestonModel(0.0, asset_id="eq", martingale_correction=martingale_correction,
                            **MODEL_KW)
    netting_sets = [
        pkg.NettingSet(name=f"call_{t:g}", products=[
            pkg.EuropeanOption(pkg.Equity("eq"), t, 100.0, pkg.OptionType.CALL, asset_id="eq")])
        for t in MATURITIES
    ]
    return model, netting_sets


def port_controller(num_paths, differentiate=False, **kwargs):
    model, netting_sets = slice_book(mt, kwargs.pop("martingale_correction", False))
    return mt.SimulationController(
        netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), num_paths, 0, NUM_STEPS,
        mt.SimulationScheme.QE, differentiate=differentiate, device="cpu", **kwargs)


def jax_engine_noise(root_seed, phase, num_counters, num_paths, sim_dim=2):
    """The draws the JAX engine makes at each counter (engine.py:261-297)."""
    phase_k = jax_rng.phase_key(jax_rng.root_key(root_seed), phase)

    def draw(counter):
        z = jax_rng.normals(jax_rng.step_key(phase_k, counter, jax_rng.PURPOSE_NORMAL),
                            (num_paths, sim_dim), jnp.float64)
        u = jax_rng.uniforms(jax_rng.step_key(phase_k, counter, jax_rng.PURPOSE_UNIFORM),
                             (num_paths,), jnp.float64)
        return z, u

    z, u = jax.jit(jax.vmap(draw))(jnp.arange(num_counters))
    z, u = torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))
    return lambda counter: (z[counter], u[counter])


def _table(results, names, getter):
    return np.array([getter(results, n) for n in names])


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_controller_matches_jax_controller_on_injected_noise(differentiate):
    n = 1 << 12
    model, netting_sets = slice_book(mj)
    jc = mj.SimulationController(
        netting_sets, model, mj.RiskMetrics(metrics=[mj.PVMetric()]), n, 0, NUM_STEPS,
        mj.SimulationScheme.QE, differentiate=differentiate, use_pallas=False,
        batch_products=False, streaming=False, metric_streaming=False)
    jr = jc.run_simulation()

    noise = jax_engine_noise(0, jax_rng.PHASE_MAINSIM, len(MATURITIES) * NUM_STEPS, n)
    pc = port_controller(n, differentiate, noise_source={mt.rng.PHASE_MAINSIM: noise})
    assert not pc._kernel_active
    pr = pc.run_simulation()

    names = jr.get_netting_set_names()
    assert pr.get_netting_set_names() == names and pr.get_metric_names() == ["pv"]
    for getter in (lambda r, ns: r.get_results(ns, "pv", evaluation_idx=0),
                   lambda r, ns: r.get_mc_error(ns, "pv", evaluation_idx=0)):
        np.testing.assert_allclose(_table(pr, names, getter), _table(jr, names, getter),
                                   rtol=1e-10)
    if differentiate:
        for param in pr.get_model_param_names():
            getter = lambda r, ns: r.get_derivatives(ns, "pv", param=param, evaluation_idx=0)
            np.testing.assert_allclose(_table(pr, names, getter), _table(jr, names, getter),
                                       rtol=1e-8, atol=1e-12)


def test_controller_plain_kernel_prices_match_characteristic_function():
    n = 1 << 14
    pc = port_controller(n)
    assert pc._kernel_active
    before = heston_qe_paths.launches
    r = pc.run_simulation()
    assert heston_qe_paths.launches == before  # CPU tensors: plain version, no launch
    model, netting_sets = slice_book(mt)
    for ns in netting_sets:
        option = ns.products[0]
        cf = option.compute_pv_analytically_heston(model)
        pv = float(r.get_results(ns.name, "pv", evaluation_idx=0))
        se = float(r.get_mc_error(ns.name, "pv", evaluation_idx=0))
        assert np.isfinite(pv) and 0 < se < 0.2
        assert abs(pv - cf) < 4 * se + 0.05, (ns.name, pv, cf, se)


def test_differentiated_kernel_path_matches_engine_on_same_stream():
    """Emitted-noise AD through the plain kernel vs autograd through the
    engine: both draw the same Philox words (kernel f32, engine f64)."""
    n = 1 << 11
    rk = port_controller(n, differentiate=True).run_simulation()
    re = port_controller(n, differentiate=True, use_kernel=False).run_simulation()
    names = rk.get_netting_set_names()
    for param in rk.get_model_param_names():
        getter = lambda r, ns: r.get_derivatives(ns, "pv", param=param, evaluation_idx=0)
        np.testing.assert_allclose(_table(rk, names, getter), _table(re, names, getter),
                                   rtol=1e-3, atol=1e-3)


def test_kernel_selection_rule():
    assert port_controller(64)._kernel_active
    assert not port_controller(64, use_kernel=False)._kernel_active
    assert not port_controller(64, martingale_correction=True)._kernel_active
    with pytest.raises(ValueError):
        port_controller(64, use_kernel=True, martingale_correction=True)
    with pytest.raises(ValueError):
        port_controller(64, use_kernel=True, antithetic=True)
    with pytest.raises(ValueError):
        port_controller(64, use_kernel=True, noise_source={43: lambda c: None})
    with pytest.raises(NotImplementedError):
        port_controller(64, antithetic=True).run_simulation()


def test_unported_features_raise():
    with pytest.raises(NotImplementedError):
        mt.NettingSet(name="x", products=[object()], threshold=1.0)
    with pytest.raises(NotImplementedError):
        mt.NettingSet(name="x", products=[object()], margin_period_of_risk=0.1)


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mt.resolve_device(None) == torch.device("cpu")
    with pytest.raises(RuntimeError):
        mt.resolve_device("cuda")
    model, netting_sets = slice_book(mt)
    with pytest.raises(RuntimeError):
        mt.SimulationController(netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), 64, 0,
                                NUM_STEPS, mt.SimulationScheme.QE, device="cuda")


def test_european_closed_forms_match_jax():
    jopt = mj.EuropeanOption(mj.Equity("eq"), 0.7, 95.0, mj.OptionType.PUT, asset_id="eq")
    popt = mt.EuropeanOption(mt.Equity("eq"), 0.7, 95.0, mt.OptionType.PUT, asset_id="eq")
    args = (100.0, 0.03, 0.25, 0.7)
    jbs = float(jopt._bs_price(*(jnp.asarray(a) for a in args)))
    pbs = float(popt.bs_price(*(torch.tensor(a, dtype=torch.float64) for a in args[:3]), args[3]))
    np.testing.assert_allclose(pbs, jbs, rtol=1e-13)
    jmodel, _ = slice_book(mj)
    pmodel, _ = slice_book(mt)
    np.testing.assert_allclose(popt.compute_pv_analytically_heston(pmodel),
                               jopt.compute_pv_analytically_heston(jmodel), rtol=1e-13)


@pytest.mark.gpu
def test_controller_on_cuda_runs_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    model, netting_sets = slice_book(mt)
    c = mt.SimulationController(netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), 1 << 16,
                                0, NUM_STEPS, mt.SimulationScheme.QE, device="cuda")
    before = heston_qe_paths.launches
    r = c.run_simulation()
    assert heston_qe_paths.launches > before
    for ns in netting_sets:
        cf = ns.products[0].compute_pv_analytically_heston(model)
        pv = float(r.get_results(ns.name, "pv", evaluation_idx=0))
        se = float(r.get_mc_error(ns.name, "pv", evaluation_idx=0))
        assert abs(pv - cf) < 4 * se + 0.05
