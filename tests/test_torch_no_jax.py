"""The PyTorch port stands without JAX: neither the package, nor its example
scripts (``examples_torch/``), nor ``chip_smoke.py`` imports ``jax`` or the
JAX package; the engine's default device is the card; and ``chip_smoke.py``
refuses to run without a card or outside the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "montecarlo_risk_engine_tpu_torch"
EXAMPLES = REPO / "examples_torch"
FORBIDDEN = {"jax", "jaxlib", "montecarlo_risk_engine_tpu"}


def _run(code_or_args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    args = [sys.executable, "-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_import_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['montecarlo_risk_engine_tpu'] = None\n"
        "import montecarlo_risk_engine_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "import examples_torch as e\n"
        "for info in pkgutil.iter_modules(e.__path__, e.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n"
    )
    proc = _run(code, REPO, {"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
                         + sorted(str(p.relative_to(REPO)) for p in EXAMPLES.glob("*.py"))
                         + ["chip_smoke.py"])
def test_sources_import_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_engine_defaults_to_the_card(monkeypatch):
    """``simulate_paths`` without ``device=`` resolves to the card, as every
    entry point does: with CUDA reported absent it raises the
    ``resolve_device`` error instead of running on the CPU, where
    ``Model.initial_params()`` puts the parameters."""
    from montecarlo_risk_engine_tpu_torch import CIRPPModel, SimulationScheme, rng
    from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CIRPPModel(0.0, asset_id="cp", hazard_rates={1.0: 0.02, 5.0: 0.03}, kappa=0.4,
                       theta=0.02, volatility=0.06, y0=0.015)
    assert model.initial_params()[0].device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_paths(model, model.initial_params(), SimulationScheme.EULER, [0.5, 1.0], 64, 4,
                       rng.PHASE_MAINSIM)
    states = simulate_paths(model, model.initial_params(), SimulationScheme.EULER, [0.5, 1.0],
                            64, 4, rng.PHASE_MAINSIM, device="cpu")
    assert states.device == torch.device("cpu") and states.shape == (2, 64, 2)


def test_dispatcher_refuses_other_devices():
    from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths

    params = tuple(torch.zeros((), device="meta") for _ in range(7))
    with pytest.raises(ValueError):
        heston_qe_paths(params, (0.5, 1.0), 16, 2)


def test_chip_smoke_fails_without_cuda():
    proc = _run([sys.executable, "chip_smoke.py"], REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
