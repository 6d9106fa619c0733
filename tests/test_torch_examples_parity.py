"""The port's example scripts (examples_torch/) against the JAX scripts
(examples/) on the CPU.

Statistical, where the two packages draw different streams (the port's
Philox against JAX's threefry): at 4096-8192 paths each helper's value lies
within 4 combined standard errors of the JAX helper's.  Exact (1e-12),
where a script computes without draws or on given inputs: SABR's Hagan
formula and its jacobian (``torch.func.jacfwd`` against ``jax.jacfwd``),
the CRR tree, and the copula's default times and k-th-to-default legs on
the same numpy inputs.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = str(Path(__file__).resolve().parent.parent / "examples")


def jax_example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(EXAMPLES)


def port_example(name):
    return importlib.import_module(f"examples_torch.{name}")


def within_4se(port, jax_, what):
    (a, se_a), (b, se_b) = port, jax_
    gap, limit = abs(a - b), 4.0 * float(np.hypot(se_a, se_b))
    assert se_a > 0 and se_b > 0 and gap < limit, f"{what}: {a} vs {b}, gap {gap} > {limit}"


# -- statistical: within 4 combined SE ------------------------------------------


def test_european_option_run_matches_jax():
    pv, se, analytic, grads = port_example("pv_european_option").run(8192, device="cpu")
    jpv, jse, janalytic, jgrads = jax_example("pv_european_option").run(8192)
    within_4se((pv, se), (jpv, jse), "pv")
    np.testing.assert_allclose(analytic, janalytic, rtol=1e-12)
    assert set(grads) == set(jgrads)


@pytest.mark.parametrize("scheme", ["EULER", "QE"])
def test_heston_price_matches_jax(scheme):
    """The QE book takes K1's plain version on the CPU, the Euler book the
    engine; the JAX package's CPU controller takes its engine for both."""
    import montecarlo_risk_engine_tpu as mj
    import montecarlo_risk_engine_tpu_torch as mt

    port = port_example("pv_heston_convergence").price(mt.SimulationScheme[scheme], 4, 8192,
                                                       device="cpu")
    ref = jax_example("pv_heston_convergence").price(mj.SimulationScheme[scheme], 4, 8192)
    within_4se(port, ref, f"heston {scheme}")


def test_lsm_price_matches_jax():
    port = port_example("lsm_convergence_study").lsm_price(2, 8192, device="cpu")
    ref = jax_example("lsm_convergence_study").lsm_price(2, 8192)
    within_4se(port, ref, "LSM degree 2")


@pytest.mark.parametrize("kind,use_cv", [("GEOMETRIC", False), ("ARITHMETIC", False),
                                         ("ARITHMETIC", True)])
def test_basket_run_matches_jax(kind, use_cv):
    import montecarlo_risk_engine_tpu as mj
    import montecarlo_risk_engine_tpu_torch as mt

    pv, se, _, _ = port_example("pv_basket_option").run(mt.BasketOptionType[kind], use_cv, 8192,
                                                         device="cpu")
    jpv, jse, _, _ = jax_example("pv_basket_option").run(mj.BasketOptionType[kind], use_cv, 8192)
    within_4se((pv, se), (jpv, jse), f"{kind} basket, cv={use_cv}")


def test_cva_for_rho_matches_jax():
    port = port_example("cva_wwr_sweep").cva_for_rho(0.5, num_paths=4096, device="cpu")
    ref = jax_example("cva_wwr_sweep").cva_for_rho(0.5, num_paths=4096)
    within_4se(port, ref, "CVA at rho 0.5")


# -- exact: the same inputs, 1e-12 ----------------------------------------------


def test_sabr_hagan_vol_and_jacobian_match_jax():
    port, ref = port_example("sabr_calibration"), jax_example("sabr_calibration")
    rs = np.random.default_rng(11)
    cases = [(m, np.array(p)) for m, p in ref.TRUE.items()]
    cases += [(float(rs.uniform(0.25, 3.0)),
               np.array([rs.uniform(0.1, 1.0), rs.uniform(-0.8, 0.8), rs.uniform(0.2, 2.0)]))
              for _ in range(4)]
    strikes = np.concatenate([ref.STRIKES, [ref.SPOT * 1.01]])
    for maturity, x in cases:
        forward = ref.SPOT * np.exp(ref.RATE * maturity)
        strikes_np = np.append(strikes, forward)  # an ATM strike: the guard
        strikes_j = jnp.asarray(strikes_np)
        vols = port.hagan_implied_vol(*x, forward, strikes_np, maturity, device="cpu").numpy()
        np.testing.assert_allclose(
            vols, np.asarray(ref.hagan_implied_vol(*x, forward, strikes_j, maturity)),
            rtol=1e-12, atol=1e-15)
        jac = torch.func.jacfwd(lambda p: port.smile(p, forward, maturity,
                                                     torch.from_numpy(strikes_np),
                                                     device="cpu"))
        jjac = jax.jacfwd(lambda p: ref.smile(p, forward, maturity, strikes_j))
        np.testing.assert_allclose(jac(torch.from_numpy(x)).numpy(),
                                   np.asarray(jjac(jnp.asarray(x))), rtol=1e-12, atol=1e-14)


def test_crr_tree_matches_jax():
    port, ref = port_example("lsm_convergence_study"), jax_example("lsm_convergence_study")
    for steps in (8, 80):
        np.testing.assert_allclose(port.crr_bermudan_put(steps), ref.crr_bermudan_put(steps),
                                   rtol=1e-12)


def test_copula_default_times_and_legs_match_jax():
    port, ref = port_example("basket_cds_copula"), jax_example("basket_cds_copula")
    rs = np.random.default_rng(3)
    u = rs.uniform(0.0, 0.999, size=(4096, port.N_NAMES))
    taus = port.default_times_from_uniforms(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(taus, np.asarray(ref.default_times_from_uniforms(jnp.asarray(u))),
                               rtol=1e-12)
    for k in (1, 2, port.N_NAMES):
        for rate in (0.0, 0.02, 0.05):
            np.testing.assert_allclose(
                float(port.kth_to_default_leg(torch.from_numpy(taus), k, rate)),
                float(ref.kth_to_default_leg(jnp.asarray(taus), k, rate)), rtol=1e-12)
