"""The port's binary, Asian and barrier options against the JAX package on
the same numbers (f64, the JAX engine's own threefry draws injected through
``noise_source`` and its bridge uniforms through ``bridge_source``), their
closed forms, and the port's refusal of the Brownian bridge off
Black-Scholes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu import rng as jax_rng
from montecarlo_risk_engine_tpu_torch import rng
from test_torch_hybrid_models import jax_engine_normals

torch.set_num_threads(1)

JAX_FLAGS = dict(use_pallas=False, batch_products=False, streaming=False, metric_streaming=False,
                 grad_mode="fwd")
N = 512


def jax_bridge_uniforms(product_id, barrier_idx, num_paths, num_intervals):
    """The JAX package's bridge stream (barrier_option.py:185-195)."""
    base = jax_rng.phase_key(jax_rng.root_key(0), jax_rng.PHASE_BRIDGE)
    key = jax_rng.step_key(base, product_id, barrier_idx)
    return torch.from_numpy(np.array(jax_rng.uniforms(key, (num_paths, num_intervals),
                                                      jnp.float64)))


def path_book(pkg):
    """Two binaries, both Asian averagings, and barriers of every type, one
    and two barriers, discretely monitored and with the bridge: each product
    its own netting set."""
    B, call, put = pkg.BarrierOptionType, pkg.OptionType.CALL, pkg.OptionType.PUT
    products = [
        pkg.BinaryOption(1.0, 100.0, 10.0, call, asset_id="eq"),
        pkg.BinaryOption(1.5, 95.0, 8.0, put, asset_id="eq"),
        pkg.AsianOption(0.0, 1.0, 100.0, 6, call, pkg.AsianAveragingType.ARITHMETIC, asset_id="eq"),
        pkg.AsianOption(0.0, 1.0, 98.0, 5, put, pkg.AsianAveragingType.GEOMETRIC, asset_id="eq"),
    ]
    barriers = [(B.UPANDOUT, 125.0, None, None), (B.DOWNANDOUT, 85.0, None, None),
                (B.UPANDIN, 120.0, None, None), (B.DOWNANDIN, 90.0, None, None),
                (B.UPANDOUT, 130.0, B.DOWNANDOUT, 80.0)]
    for bridge in (False, True):
        for kind, b1, kind2, b2 in barriers:
            option = pkg.BarrierOption(0.0, 1.0, 100.0, 7, call if b1 > 100 else put, b1, kind,
                                       barrier2=b2, barrier_option_type2=kind2, asset_id="eq")
            if bridge:
                option.set_use_brownian_bridge()
            products.append(option)
    return [pkg.NettingSet(name=f"p{i}", products=[p]) for i, p in enumerate(products)]


def bs(pkg):
    return pkg.BlackScholesModel(0.0, 100.0, 0.03, 0.25, asset_id="eq")


@pytest.mark.parametrize("differentiate", [False, True], ids=["forward", "differentiated"])
def test_path_products_match_jax_controller(differentiate):
    jc = mj.SimulationController(path_book(mj), bs(mj), mj.RiskMetrics([mj.PVMetric()]), N, 0, 2,
                                 mj.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 **JAX_FLAGS)
    jr = jc.run_simulation()
    noise = {jax_rng.PHASE_MAINSIM: jax_engine_normals(0, jax_rng.PHASE_MAINSIM,
                                                       len(jc.simulation_timeline) * 2, N, 1)}
    pc = mt.SimulationController(path_book(mt), bs(mt), mt.RiskMetrics([mt.PVMetric()]), N, 0, 2,
                                 mt.SimulationScheme.ANALYTICAL, differentiate=differentiate,
                                 device="cpu", noise_source=noise,
                                 bridge_source=jax_bridge_uniforms)
    assert pc.simulation_timeline == jc.simulation_timeline and not pc.requires_regression
    pr = pc.run_simulation()
    for ns in jr.get_netting_set_names():
        np.testing.assert_allclose(pr.get_results(ns, "pv"), jr.get_results(ns, "pv"), rtol=1e-9,
                                   atol=1e-13, err_msg=ns)
        np.testing.assert_allclose(pr.get_mc_error(ns, "pv"), jr.get_mc_error(ns, "pv"),
                                   rtol=1e-9, atol=1e-13, err_msg=ns)
        if differentiate:
            np.testing.assert_allclose(np.asarray(pr.get_derivatives(ns, "pv")),
                                       np.asarray(jr.get_derivatives(ns, "pv")),
                                       rtol=1e-7, atol=1e-10, err_msg=ns)


def test_closed_forms_match_jax():
    jm, pm = bs(mj), bs(mt)
    jp, pp = jm.initial_params(), pm.initial_params()
    for kind in ("CALL", "PUT"):
        for maturity, strike in ((0.5, 95.0), (2.0, 110.0)):
            jb = mj.BinaryOption(maturity, strike, 10.0, mj.OptionType[kind], asset_id="eq")
            pb = mt.BinaryOption(maturity, strike, 10.0, mt.OptionType[kind], asset_id="eq")
            assert pb.supports_analytic_pv(pm)
            np.testing.assert_allclose(float(pb.compute_pv_analytically(pm, pp)),
                                       float(jb.compute_pv_analytically(jm, jp)), rtol=1e-12)
    for kind, barrier in (("UPANDOUT", 130.0), ("DOWNANDOUT", 80.0)):
        for maturity, strike in ((1.0, 100.0), (2.5, 90.0)):
            make = lambda pkg: pkg.BarrierOption(0.0, maturity, strike, 12, pkg.OptionType.CALL,
                                                 barrier, pkg.BarrierOptionType[kind],
                                                 asset_id="eq")
            np.testing.assert_allclose(float(make(mt).compute_pv_analytically(pm, pp)),
                                       float(make(mj).compute_pv_analytically(jm, jp)),
                                       rtol=1e-12)


def test_bridge_refused_off_black_scholes():
    """Under BlackScholesMulti the JAX package's bridge reads params[1], the
    second asset's spot, as the volatility (barrier_option.py:146): it
    returns a value, and the port refuses the bridge with ValueError."""
    assets = ["a0", "a1"]

    def setup(pkg):
        model = pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=assets, spots=[100.0, 90.0],
                                      volatilities=[0.2, 0.25],
                                      correlation_matrix=np.array([[1.0, 0.3], [0.3, 1.0]]))
        option = pkg.BarrierOption(0.0, 1.0, 100.0, 5, pkg.OptionType.CALL, 125.0,
                                   pkg.BarrierOptionType.UPANDOUT, asset_id="a0")
        option.set_use_brownian_bridge()
        return [pkg.NettingSet(name="b", products=[option])], model

    jc = mj.SimulationController(*setup(mj), mj.RiskMetrics([mj.PVMetric()]), 256, 0, 1,
                                 mj.SimulationScheme.ANALYTICAL, **JAX_FLAGS)
    assert float(jc.model.initial_params()[1]) == 90.0  # spot[a1], not a volatility
    assert np.isfinite(float(jc.run_simulation().get_results("b", "pv", evaluation_idx=0)))
    pc = mt.SimulationController(*setup(mt), mt.RiskMetrics([mt.PVMetric()]), 256, 0, 1,
                                 mt.SimulationScheme.ANALYTICAL, device="cpu")
    with pytest.raises(ValueError, match="BlackScholesModel"):
        pc.run_simulation()


def test_bridge_uniforms_stream():
    """The port's own bridge stream: uniforms in (0, 1), a counter per
    (product, barrier, path, interval), keyed by seed 0 whatever the run's
    root seed."""
    u = rng.bridge_uniforms(3, 0, 4096, 6, torch.float64, "cpu")
    assert u.shape == (4096, 6) and bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert torch.equal(u, rng.bridge_uniforms(3, 0, 4096, 6, torch.float64, "cpu"))
    assert not torch.equal(u, rng.bridge_uniforms(3, 1, 4096, 6, torch.float64, "cpu"))
    assert not torch.equal(u, rng.bridge_uniforms(4, 0, 4096, 6, torch.float64, "cpu"))
    # a path's uniforms do not depend on how many paths are drawn
    assert torch.equal(u[:100], rng.bridge_uniforms(3, 0, 100, 6, torch.float64, "cpu"))

    def pv(root_seed):
        option = mt.BarrierOption(0.0, 1.0, 100.0, 5, mt.OptionType.CALL, 120.0,
                                  mt.BarrierOptionType.UPANDOUT, asset_id="eq")
        option.set_use_brownian_bridge()
        c = mt.SimulationController([mt.NettingSet(name="b", products=[option])], bs(mt),
                                    mt.RiskMetrics([mt.PVMetric()]), 1024, 0, 1,
                                    mt.SimulationScheme.ANALYTICAL, root_seed=root_seed,
                                    device="cpu")
        return float(c.run_simulation().get_results("b", "pv", evaluation_idx=0))

    assert np.isfinite(pv(0)) and pv(0) != pv(1)
