"""The port's PV, calibration and study example scripts (examples_torch/) on
the CPU.

Counterpart of tests/test_examples_smoke.py's PV half, at its sizes (2048
or 4096 paths, ``steps=(1, 4)``, ``path_counts=(1024, 8192)``, ``degrees=(1,
2)``), with its assertions and its two ``slow`` marks, plus tiny cases of
the three scripts that file does not run (basket_cds_copula, cva_wwr_sweep,
heston_calibration).
"""

import importlib
import os

import pytest
import torch

torch.set_num_threads(1)


def _run_example(module_name, **kwargs):
    mod = importlib.import_module(f"examples_torch.{module_name}")
    return mod.main(device="cpu", **kwargs)


@pytest.mark.parametrize("module_name", [
    "pv_european_option",
    "pv_binary_option",
    "pv_barrier_option",
    "pv_bermudan_option",
    "pv_european_bond_option",
    "cirpp_scenarios_vs_deterministic_hazard",
])
def test_pv_example_saves_plot(module_name):
    path = _run_example(module_name, num_paths=2048, save_plot=True)
    assert path is not None and os.path.exists(path)
    assert os.path.getsize(path) > 5_000


def test_basket_control_variate_example():
    out = _run_example("pv_basket_option", num_paths=4096)
    assert out["se_cv"] < out["se_plain"]


@pytest.mark.slow
def test_storage_pv_example():
    path = _run_example("pv_storage", num_paths=2048, save_plot=True)
    assert path is not None and os.path.exists(path)


@pytest.mark.slow
def test_cva_corporate_bond_example():
    path = _run_example("cva_corporate_bond", num_paths=4096, save_plot=True)
    assert path is not None and os.path.exists(path)


def test_lsm_convergence_study_example():
    path = _run_example("lsm_convergence_study", num_paths=2048,
                        degrees=(1, 2), save_plot=True)
    assert path is not None and os.path.exists(path)
    assert os.path.getsize(path) > 5_000


def test_second_derivatives_example():
    gamma, vomma = _run_example("pv_second_derivatives", num_paths=256)
    assert gamma > 0.0 and vomma > 0.0


def test_heston_convergence_example_fast():
    path = _run_example(
        "pv_heston_convergence", num_paths=4096, save_plot=True, steps=(1, 4)
    )
    assert path is not None and os.path.exists(path)


def test_sobol_convergence_example_fast():
    path, errors = _run_example(
        "pv_sobol_convergence", save_plot=True, path_counts=(1024, 8192)
    )
    assert path is not None and os.path.exists(path)
    # the QMC error should beat pseudo at the larger count
    assert errors["scrambled Sobol"][-1] < errors["pseudo (Philox)"][-1]


def test_sabr_calibration_example():
    """The per-maturity Hagan fits recover the generating (alpha, rho, nu)
    and reprice the synthetic smile to < 1e-8 vol points."""
    results = _run_example("sabr_calibration", verbose=False)
    for maturity, r in results.items():
        true = r["true"]
        fit = r["fit"]
        assert r["max_vol_err"] < 1e-8, (maturity, r)
        for t, f in zip(true, fit):
            assert abs(t - f) < 5e-3 * max(1.0, abs(t)), (maturity, true, fit)


def test_basket_cds_copula_example_tiny():
    legs = _run_example("basket_cds_copula", num_paths=4096)
    for kind in ("gaussian", "student-t"):
        first, second, last = (legs[kind, k] for k in (1, 2, 5))
        # the k-th default is later (or never) as k grows
        assert 0.0 < last < second < first < 1.0 - 0.4
    # the t copula's tail dependence makes joint defaults likelier
    assert legs["student-t", 5] > legs["gaussian", 5]


def test_cva_wwr_sweep_example_tiny():
    out = _run_example("cva_wwr_sweep", num_paths=2048, rhos=(-0.9, 0.9))
    (cva_lo, se_lo), (cva_hi, se_hi) = out[-0.9], out[0.9]
    assert cva_lo > 0.0 and cva_hi > 0.0 and se_lo > 0.0 and se_hi > 0.0
    # wrong-way risk: a payer swap's exposure rises with rates, so a
    # positive rate-credit correlation raises the CVA
    assert cva_hi > cva_lo


def test_heston_calibration_example():
    out = _run_example("heston_calibration")
    from examples_torch.heston_calibration import TRUE

    assert out["max_residual"] < 1e-6
    for name, true in TRUE.items():
        assert abs(out["fit"][name] - true) < 1e-4 * max(1.0, abs(true)), (name, out["fit"])
