"""The port's exposure-profile example scripts (examples_torch/) on the CPU.

Counterpart of tests/test_examples_smoke.py's profile half, at its path
counts (512 paths) and with its assertions, plus the one profile script
that file does not run (ee_pfe_swap_profiles) at a tiny size.  Each script
is imported as ``examples_torch.<name>``, so its modules never shadow the
JAX scripts' top-level names.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _run_example(module_name, **kwargs):
    mod = importlib.import_module(f"examples_torch.{module_name}")
    return mod.main(device="cpu", **kwargs)


@pytest.mark.parametrize("module_name", [
    "ee_pfe_bermudan_swaption",
    "ee_pfe_swap_collateralized",
    "ee_pfe_storage",
    "ee_pfe_european_vs_analytic",
    "ee_pfe_american_equity_option",
    "ee_pfe_bermudan_equity_option",
    "ee_pfe_bermudan_bond_option",
    "ee_pfe_barrier_option",
    "ee_pfe_binary_option",
    "ee_pfe_bond",
    "ee_pfe_flexicall",
    "ee_pfe_swaption",
    "eepe_simulation",
    "storage_volume_constraints",
    "storage_volume_over_time",
])
def test_profile_example_saves_plot(module_name):
    path = _run_example(module_name, num_paths=512, save_plot=True)
    assert path is not None and os.path.exists(path)
    assert os.path.dirname(path) == str(REPO / "examples_torch" / "plots")
    assert os.path.getsize(path) > 5_000  # a real rendered PNG


def test_swap_profiles_example_tiny():
    profiles = _run_example("ee_pfe_swap_profiles", num_paths=512)
    assert set(profiles) == {"uncollateralized", "collateralized MPoR=0.25"}
    for p in profiles.values():
        assert p["epe"].shape == p["ene"].shape == p["pfe"].shape == (21,)
        assert np.isfinite(p["epe"]).all() and (p["epe"] >= 0).all() and (p["ene"] <= 0).all()
    # collateral takes exposure away
    assert (profiles["collateralized MPoR=0.25"]["epe"].mean()
            < profiles["uncollateralized"]["epe"].mean())


def test_port_examples_do_not_shadow_the_jax_scripts():
    """A worker can import both sets: the JAX scripts as top-level modules
    (tests/test_examples_smoke.py puts examples/ on sys.path), the port's as
    a package."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        jax_mod = importlib.import_module("ee_pfe_bond")
        jax_common = importlib.import_module("_common")
    finally:
        sys.path.remove(str(REPO / "examples"))
    port_mod = importlib.import_module("examples_torch.ee_pfe_bond")
    port_common = importlib.import_module("examples_torch._common")
    assert jax_mod is not port_mod and jax_common is not port_common
    assert port_mod.__file__.startswith(str(REPO / "examples_torch"))
    assert jax_mod.__file__.startswith(str(REPO / "examples" / ""))
    assert port_common.PLOT_DIR != jax_common.PLOT_DIR


def test_script_runs_alone_and_defaults_to_the_card():
    """``python examples_torch/<name>.py`` finds the package from its own
    path, and its default device is the card: without CUDA it stops at the
    device, it does not fall back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "examples_torch/storage_volume_constraints.py"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]
