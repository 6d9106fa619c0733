"""The benchmark's Heston QE surface (riskbench/configs/heston_qe_book.json)
against its plain reference (riskbench/reference/heston_qe_book.py) on the
CPU at a few quotes and 4,096 paths: the port through SimulationController
agrees with the reference within a tenth of each cell's limits, PV and
jacobian; the float32 control reads above a limit; a fault planted in the
reference's input reads above the limits; the configuration expands to the
50 quotes on the bring-up smoke's Heston model."""

import copy
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import montecarlo_risk_engine_tpu_torch as mt

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from riskbench import book, spec  # noqa: E402
from riskbench.reference import heston_qe_book as ref  # noqa: E402
from riskbench.reference import philox  # noqa: E402

CELLS = {"pv": "heston_qe_book.pv_1m", "greeks": "heston_qe_book.greeks_1m"}
PATHS = 4096
SEED = 2 ** 31 + 6007
# (maturity, strike): the surface's corners and its middle
QUOTES = [(0.1, 80.0), (0.5, 100.0), (1.0, 90.0), (1.0, 120.0)]
DATES = [round(0.1 * (i + 1), 10) for i in range(10)]
STRIKES = [80.0, 90.0, 100.0, 110.0, 120.0]


def few_quotes(cfg):
    """The configuration with the netting sets of ``QUOTES`` alone."""
    cfg = copy.deepcopy(cfg)
    keep = {f"call_{t:g}_{k:g}" for t, k in QUOTES}
    cfg["netting_sets"] = [ns for ns in cfg["netting_sets"] if ns["name"] in keep]
    return cfg


def cell(kind):
    c = spec.load_cell(CELLS[kind])
    return c._replace(config=few_quotes(c.config), traffic={**c.traffic, "num_paths": PATHS})


def port_run(kind, dtype=None):
    c = cell(kind)
    mt.set_real_dtype(dtype)
    try:
        controller = book.build_controller(mt, c.config, c.traffic, SEED, "cpu")
        assert controller._kernel_active
        return book.read_results(controller.run_simulation(), SEED, bool(c.traffic["differentiate"]))
    finally:
        mt.set_real_dtype(None)


@pytest.fixture(scope="module")
def runs():
    return {kind: port_run(kind) for kind in CELLS}


def test_the_configuration_is_the_surface():
    cfg = spec.load_cell(CELLS["pv"]).config
    model = cfg["model"]
    assert model["type"] == "HestonModel" and model["asset_id"] == "eq"
    assert {k: model[k] for k in chip_smoke.MODEL_KW} == chip_smoke.MODEL_KW
    assert (cfg["scheme"], cfg["num_steps"], cfg["reduced"]) == ("QE", 4, [])
    assert [m["type"] for m in cfg["metrics"]["metrics"]] == ["PVMetric"]
    products = book.netting_set_products(cfg)
    assert all(len(ns) == 1 for ns in products) and len(products) == 50
    quotes = [(p["exercise_date"], p["strike"]) for (p,) in products]
    assert quotes == list(itertools.product(DATES, STRIKES))
    assert tuple(DATES) == chip_smoke.MATURITIES
    assert {p["option_type"]["value"] for (p,) in products} == {"CALL"}
    assert [ns["name"] for ns in cfg["netting_sets"]] == [f"call_{t:g}_{k:g}" for t, k in quotes]
    for kind, name in CELLS.items():
        traffic = spec.load_cell(name).traffic
        assert (traffic["num_paths"], traffic["num_paths_presim"]) == (1 << 20, 0)
        assert traffic["differentiate"] == (kind == "greeks")


@pytest.mark.parametrize("kind", CELLS)
def test_the_port_agrees_with_the_reference(runs, kind):
    c = cell(kind)
    readings = ref.check(c.config, c.traffic, [runs[kind]], "cpu")
    assert set(readings) == set(c.traffic["limits"])
    for name, value in readings.items():
        assert value <= c.traffic["limits"][name] / 10, (name, value)


@pytest.mark.parametrize("kind", CELLS)
def test_the_float32_control_reads_above_a_limit(kind):
    c = cell(kind)
    readings = ref.check(c.config, c.traffic, [port_run(kind, torch.float32)], "cpu")
    assert any(readings[k] > c.traffic["limits"][k] for k in readings), readings


def _substep_left_unchanged(monkeypatch, cfg):
    calls = [0]

    def wrap(real):
        def step(log_s, v, *args):
            calls[0] += 1
            return (log_s, v) if calls[0] % 10 == 1 else real(log_s, v, *args)
        return step
    monkeypatch.setattr(ref, "kernel_substep", wrap(ref.kernel_substep))
    monkeypatch.setattr(ref, "fuzzy_step", wrap(ref.fuzzy_step))
    return cfg


def _uniform_lane_swapped(monkeypatch, cfg):
    real = ref.draws

    def draws(seed, counter, paths):
        z_s, z_v, _ = real(seed, counter, paths)
        word = lambda v: torch.full((), v, dtype=torch.int64, device=paths.device)
        w = philox.philox((paths, word(counter), word(0), word(0)), (seed, philox.PHASE_MAINSIM))
        return z_s, z_v, philox.uniform(w[3], torch.float32)
    monkeypatch.setattr(ref, "draws", draws)
    return cfg


def _one_strike_moved(monkeypatch, cfg):
    cfg = copy.deepcopy(cfg)
    cfg["netting_sets"][1]["products"][0]["fields"]["strike"] += 1.0
    return cfg


@pytest.mark.parametrize("kind, fault", [
    ("pv", _substep_left_unchanged), ("pv", _one_strike_moved),
    ("greeks", _substep_left_unchanged), ("greeks", _uniform_lane_swapped),
    ("greeks", _one_strike_moved)])
def test_a_fault_in_the_references_input_reads_above_the_limits(runs, monkeypatch, kind, fault):
    c = cell(kind)
    cfg = fault(monkeypatch, c.config)
    readings = ref.check(cfg, c.traffic, [runs[kind]], "cpu")
    assert all(readings[k] > c.traffic["limits"][k] for k in readings), readings


def test_the_forward_surface_never_takes_the_exponential_branch(runs, monkeypatch):
    """psi = s^2 / m^2 is largest at v = 0, where it is sigma^2 / (2 kappa
    theta) = 1.0417 < psi_c = 1.5: the hard QE step stays on its quadratic
    branch, so the forward cell's values do not read the uniform (the
    differentiated cell's fuzzy switch, a ramp over psi in [1, 2], does)."""
    m = chip_smoke.MODEL_KW
    sigma, kappa, theta = m["sigma"], m["kappa"], m["theta"]
    v = np.array([0.0, 1e-6, 1e-3, 0.04, 0.5])
    for dt in (0.025, 0.25):
        ekt = np.exp(-kappa * dt)
        mean = theta * (1.0 - ekt) + v * ekt
        s2 = (v * sigma ** 2 * ekt * (1.0 - ekt) / kappa
              + theta * sigma ** 2 * (1.0 - ekt) ** 2 / (2.0 * kappa))
        psi = s2 / mean ** 2
        assert psi.argmax() == 0 and psi[0] == pytest.approx(sigma ** 2 / (2 * kappa * theta))
    assert sigma ** 2 / (2 * kappa * theta) < ref.PSI_C
    c = cell("pv")
    _uniform_lane_swapped(monkeypatch, c.config)
    assert ref.check(c.config, c.traffic, [runs["pv"]], "cpu")["pv_gap"] <= \
        c.traffic["limits"]["pv_gap"] / 10


def test_the_reference_repeats_the_kernels_stream():
    """The reference's draws are the port's Philox words, uniforms and
    Box-Muller pair at the kernel's counters, bit for bit."""
    paths = torch.arange(64, dtype=torch.int64)
    z_s, z_v, u = ref.draws(SEED, 7, paths)
    w = mt.rng.philox4x32_10((paths, torch.tensor(7), torch.tensor(0), torch.tensor(0)),
                             (SEED, mt.rng.PHASE_MAINSIM))
    port = mt.rng.substep_draws(SEED, mt.rng.PHASE_MAINSIM, 7, 64, torch.float32, "cpu")
    for a, b in zip((z_s, z_v, u), port):
        assert torch.equal(a, b)
    assert torch.equal(u, mt.rng.uniform_from_word(w[2], torch.float32))
    assert np.isfinite(z_s.numpy()).all()
