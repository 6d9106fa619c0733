"""The port's SimulationController on exposure books against the JAX
controller: a reduced north-star xVA book (ModelConfig of Vasicek, Black-
Scholes and CIR++; swaps and options; MPoR collateral; CVA, EPE, PFE) and a
Black-Scholes book with a threshold and the remaining exposure metrics.

Both phases of the port's engine take the JAX engine's own threefry draws
through ``noise_source`` (as tests/test_torch_controller.py does), so
values, standard errors and gradients must agree to rounding.  The JAX
controller runs with ``use_pallas=False, batch_products=False,
streaming=False, metric_streaming=False``, the semantics the port follows.
"""

import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
from montecarlo_risk_engine_tpu import rng as jax_rng
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch.metrics import metrics as pm_metrics
from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import hybrid_paths
from montecarlo_risk_engine_tpu_torch.products.swap import InterestRateSwap, IRSType
from test_torch_hybrid_models import jax_engine_normals, north_star_model, port_pkg

torch.set_num_threads(1)

CP = "counterparty"
EXPOSURE_TIMELINE = np.linspace(0.0, 2.0, 9)
MPOR = 10 / 252
# grad_mode="fwd": the port's direction for these books, and the JAX
# jacobian program that compiles fastest (its "auto" picks linearize).
JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")


class _PortPkg:
    """The port's classes under the JAX package's names."""
    InterestRateSwap, IRSType = InterestRateSwap, IRSType
    EuropeanOption, Equity, OptionType, NettingSet = (
        mt.EuropeanOption, mt.Equity, mt.OptionType, mt.NettingSet)
    CVAMetric, EPEMetric, PFEMetric = pm_metrics.CVAMetric, pm_metrics.EPEMetric, pm_metrics.PFEMetric
    ENEMetric, CEMetric, EEPEMetric = pm_metrics.ENEMetric, pm_metrics.CEMetric, pm_metrics.EEPEMetric
    RiskMetrics = mt.RiskMetrics


def reduced_north_star(pkg, model_pkg):
    """2 swaps + 2 options of benchmarks/north_star.py:62-74, 9 exposure
    dates to 2y, MPoR collateral, CVA + EPE + PFE."""
    products = [pkg.InterestRateSwap(0.0, 2.0 + i, notional=1.0, fixed_rate=0.028 + 0.001 * i,
                                     tenor_fixed=0.5, tenor_float=0.5,
                                     irs_type=pkg.IRSType.PAYER if i % 2 == 0 else pkg.IRSType.RECEIVER,
                                     asset_id="irs") for i in range(2)]
    products += [pkg.EuropeanOption(pkg.Equity("eq"), 1.0 + 0.75 * i, 90.0 + 5.0 * i,
                                    pkg.OptionType.CALL if i % 2 == 0 else pkg.OptionType.PUT,
                                    asset_id="eq") for i in range(2)]
    netting_set = pkg.NettingSet(name="north_star", products=products, counterparty_id=CP,
                                 margin_period_of_risk=MPOR)
    metrics = pkg.RiskMetrics(
        metrics=[pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4), pkg.EPEMetric(),
                 pkg.PFEMetric(0.95)],
        exposure_timeline=EXPOSURE_TIMELINE)
    return north_star_model(model_pkg), [netting_set], metrics


def _jax_controller(book, n, differentiate):
    model, netting_sets, metrics = book
    return mj.SimulationController(netting_sets, model, metrics, n, n, 1, mj.SimulationScheme.EULER,
                                   differentiate=differentiate, **JAX_FLAGS)


def _injected(timeline, n, sim_dim):
    return {phase: jax_engine_normals(0, phase, len(timeline), n, sim_dim)
            for phase in (jax_rng.PHASE_PRESIM, jax_rng.PHASE_MAINSIM)}


def _compare(pr, jr, grads, rtol_values=1e-9, rtol_grads=1e-7):
    assert pr.get_netting_set_names() == jr.get_netting_set_names()
    assert pr.get_metric_names() == jr.get_metric_names()
    for ns in jr.get_netting_set_names():
        for metric in jr.get_metric_names():
            np.testing.assert_allclose(pr.get_results(ns, metric), jr.get_results(ns, metric),
                                       rtol=rtol_values, atol=1e-13, err_msg=metric)
            np.testing.assert_allclose(pr.get_mc_error(ns, metric), jr.get_mc_error(ns, metric),
                                       rtol=rtol_values, atol=1e-13, err_msg=metric)
            if grads:
                for param in jr.get_model_param_names():
                    np.testing.assert_allclose(
                        pr.get_derivatives(ns, metric, param=param),
                        jr.get_derivatives(ns, metric, param=param),
                        rtol=rtol_grads, atol=1e-11, err_msg=f"{metric} {param}")


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_north_star_matches_jax_controller_on_injected_noise(differentiate):
    n = 1024
    jc = _jax_controller(reduced_north_star(mj, mj), n, differentiate)
    jr = jc.run_simulation()

    model, netting_sets, metrics = reduced_north_star(_PortPkg, port_pkg())
    pc = mt.SimulationController(netting_sets, model, metrics, n, n, 1, mt.SimulationScheme.EULER,
                                 differentiate=differentiate, device="cpu",
                                 noise_source=_injected(jc.simulation_timeline, n, 3),
                                 batch_products=False)
    assert not pc._kernel_active
    assert pc.simulation_timeline == jc.simulation_timeline
    assert pc.exposure_timeline == jc.exposure_timeline and len(pc.exposure_timeline) == 17
    np.testing.assert_array_equal(pc.netting_set_delayed_exposure_indices[0],
                                  jc.netting_set_delayed_exposure_indices[0])
    pr = pc.run_simulation()
    assert pr.get_metric_names() == [f"cva[{CP}]", "epe", "pfe[0.95]"]
    if differentiate:
        assert pc._grad_mode_resolved == "fwd"  # P = 11 <= V = 1 + 9 + 9
    _compare(pr, jr, differentiate)


def test_exposure_metrics_book_matches_jax_controller():
    """Black-Scholes book with a threshold and MPoR: pathwise analytic
    exposures of the options, EPE, ENE, CE, EEPE (effective), PFE with the
    order-statistic error, forward mode over P = 3 <= V."""
    n, timeline = 1024, np.linspace(0.0, 1.5, 7)

    def book(pkg, model):
        products = [pkg.EuropeanOption(pkg.Equity("eq"), 1.0, 100.0, pkg.OptionType.CALL,
                                       asset_id="eq"),
                    pkg.EuropeanOption(pkg.Equity("eq"), 1.5, 95.0, pkg.OptionType.PUT,
                                       asset_id="eq")]
        ns = pkg.NettingSet(name="bs", products=products, threshold=1.0, margin_period_of_risk=0.1)
        metrics = pkg.RiskMetrics(metrics=[pkg.EPEMetric(), pkg.ENEMetric(), pkg.CEMetric(),
                                           pkg.EEPEMetric(effective=True),
                                           pkg.PFEMetric(0.9, pfe_se="order-statistic")],
                                  exposure_timeline=timeline)
        return [ns], model, metrics

    jc = mj.SimulationController(*book(mj, mj.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq")),
                                 n, n, 2, mj.SimulationScheme.EULER, differentiate=True, **JAX_FLAGS)
    jr = jc.run_simulation()
    pc = mt.SimulationController(*book(_PortPkg, BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq")),
                                 n, n, 2, mt.SimulationScheme.EULER, differentiate=True, device="cpu",
                                 noise_source=_injected(jc.simulation_timeline * 2, n, 1))
    assert not pc.requires_regression  # closed-form exposures, no LSM fit
    _compare(pc.run_simulation(), jr, True)


def test_kernel_route_matches_engine_route_on_the_same_stream():
    """Plain K2 (float32 paths) against the engine (float64) on the same
    Philox normals, forward and differentiated (recovered-noise AD).  A path whose
    exposure sits on the kink of max(E, 0) may fall on either side in the
    two precisions and moves a jacobian entry by O(1/N): 2048 paths keep
    that inside the tolerance."""
    n = 2048
    runs = {}
    for use_kernel in ("auto", False):
        for differentiate in (False, True):
            model, netting_sets, metrics = reduced_north_star(_PortPkg, port_pkg())
            c = mt.SimulationController(netting_sets, model, metrics, n, n, 1,
                                        mt.SimulationScheme.EULER, differentiate=differentiate,
                                        use_kernel=use_kernel, device="cpu")
            assert c._kernel_active == (use_kernel == "auto")
            before = hybrid_paths.launches
            runs[use_kernel, differentiate] = c.run_simulation()
            assert hybrid_paths.launches == before  # CPU tensors: plain version, no launch
    for differentiate in (False, True):
        kernel, engine = runs["auto", differentiate], runs[False, differentiate]
        for metric in engine.get_metric_names():
            np.testing.assert_allclose(kernel.get_results("north_star", metric),
                                       engine.get_results("north_star", metric),
                                       rtol=1e-4, atol=1e-6)
    kernel, engine = runs["auto", True], runs[False, True]
    for metric in engine.get_metric_names():
        for param in engine.get_model_param_names():
            np.testing.assert_allclose(kernel.get_derivatives("north_star", metric, param=param),
                                       engine.get_derivatives("north_star", metric, param=param),
                                       rtol=1e-3, atol=1e-6, err_msg=f"{metric} {param}")


def test_xva_book_checks():
    model, netting_sets, metrics = reduced_north_star(_PortPkg, port_pkg())
    with pytest.raises(ValueError):  # CVA needs a ModelConfig
        mt.SimulationController(netting_sets, BlackScholesModel(0.0, 100.0, 0.03, 0.2, asset_id="eq"),
                                metrics, 64, 64, 1, mt.SimulationScheme.EULER, device="cpu")
    with pytest.raises(ValueError):  # LSM exposures need pre-simulation paths
        mt.SimulationController(netting_sets, model, metrics, 64, 0, 1, mt.SimulationScheme.EULER,
                                device="cpu")
    c = mt.SimulationController(netting_sets, model, metrics, 64, 64, 1, mt.SimulationScheme.EULER,
                                device="cpu", use_kernel=True)
    assert c._kernel_active and c.requires_regression
    with pytest.raises(ValueError):
        mt.SimulationController(netting_sets, model, metrics, 64, 64, 1, mt.SimulationScheme.QE,
                                device="cpu", use_kernel=True)


@pytest.mark.gpu
def test_north_star_on_cuda_runs_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    model, netting_sets, metrics = reduced_north_star(_PortPkg, port_pkg())
    c = mt.SimulationController(netting_sets, model, metrics, 1 << 16, 1 << 16, 1,
                                mt.SimulationScheme.EULER)
    before = hybrid_paths.launches
    r = c.run_simulation()
    assert hybrid_paths.launches == before + 2  # presim + mainsim
    assert np.isfinite(r.get_results("north_star", f"cva[{CP}]")).all()


def cva_seed_spread(num_paths: int = 65536, seeds=range(5)):
    """The full north-star CVA (benchmarks/north_star.py:47-96) on the CPU for
    several root seeds, in the JAX package (threefry) and in the port
    (engine route, Philox): both spreads include the LSM fit noise of each
    seed's own pre-simulation, which a run's MC standard error leaves out.
    For seed 0 the port also runs on the JAX engine's own draws.

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_hybrid_controller.py
    """
    import time

    def book(pkg, model_pkg):
        products = [pkg.InterestRateSwap(0.0, 2.0 + i, notional=1.0, fixed_rate=0.028 + 0.001 * i,
                                         tenor_fixed=0.5, tenor_float=0.5,
                                         irs_type=pkg.IRSType.PAYER if i % 2 == 0 else pkg.IRSType.RECEIVER,
                                         asset_id="irs") for i in range(5)]
        products += [pkg.EuropeanOption(pkg.Equity("eq"), 1.0 + 0.75 * i, 90.0 + 5.0 * i,
                                        pkg.OptionType.CALL if i % 2 == 0 else pkg.OptionType.PUT,
                                        asset_id="eq") for i in range(5)]
        ns = pkg.NettingSet(name="north_star", products=products, counterparty_id=CP,
                            margin_period_of_risk=MPOR)
        metrics = pkg.RiskMetrics(metrics=[pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4)],
                                  exposure_timeline=np.linspace(0.0, 7.0, 29))
        return ([ns], north_star_model(model_pkg), metrics, num_paths, num_paths, 1)

    for seed in seeds:
        t0 = time.time()
        jr = mj.SimulationController(*book(mj, mj), mj.SimulationScheme.EULER,
                                     root_seed=seed).run_simulation()
        pr = mt.SimulationController(*book(_PortPkg, port_pkg()),
                                     mt.SimulationScheme.EULER, root_seed=seed, use_kernel=False,
                                     device="cpu").run_simulation()
        jax_cva = float(jr.get_results("north_star", f"cva[{CP}]", evaluation_idx=0))
        if seed == 0:
            timeline = mj.SimulationController(*book(mj, mj), mj.SimulationScheme.EULER).simulation_timeline
            same = mt.SimulationController(*book(_PortPkg, port_pkg()), mt.SimulationScheme.EULER,
                                           device="cpu",
                                           noise_source=_injected(timeline, num_paths, 3))
            cva = float(same.run_simulation().get_results("north_star", f"cva[{CP}]",
                                                          evaluation_idx=0))
            print(f"seed 0 on the JAX engine's draws: JAX {jax_cva!r} port {cva!r} "
                  f"(rel {abs(cva - jax_cva) / jax_cva:.1e})", flush=True)
        print(f"seed {seed}: JAX {jax_cva:.7f} "
              f"port {float(pr.get_results('north_star', f'cva[{CP}]', evaluation_idx=0)):.7f} "
              f"(se {float(pr.get_mc_error('north_star', f'cva[{CP}]', evaluation_idx=0)):.2e}, "
              f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    import conftest  # noqa: F401  (CPU backend, float64)

    cva_seed_spread()
