"""Cells, configurations and metrics are found by name, and new ones come
with new files alone; a run's last line; the reference against the port's
CPU route; the control and the planted faults read as not correct.

The runs here are the harness's own, on the CPU at a few thousand paths:
they skip the look for a card (``device="cpu"``) and nothing else."""

import json
import shutil
import time

import pytest
import torch

from riskbench import calibrate, harness, spec

SEED = 2 ** 31 + 977
PATHS = 2048
CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


def small(traffic):
    """A cell's traffic at a size the CPU runs in seconds."""
    return {**traffic, "num_paths": PATHS, "trace_runs": 2, "check_runs": 2,
            "num_paths_presim": PATHS if traffic["num_paths_presim"] else 0}


def run_cell(capsys, workload, traced=False):
    rc = harness.run(workload, SEED, 0.5, traced, time.perf_counter(), device="cpu",
                     traffic_overrides=small(spec.load_cell(workload).traffic))
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_and_metric_is_found(workload):
    cell = spec.load_cell(workload)
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    assert callable(cell.reference.check) and callable(cell.reference.path_launches)
    assert set(cell.traffic["limits"]) and cell.traffic["num_paths"] > 0


def test_a_cell_and_a_metric_come_with_new_files_alone(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "riskbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    base = bench["workloads"][0]
    bench["workloads"].append({**base, "name": f"{base['config']}.tiny", "traffic": "tiny"})
    bench["per_layer"].append({"name": "runs_traced", "unit": "runs", "better": "higher",
                               "source": "device_trace", "layer": "device (one H100)",
                               "moves": "run_s", "workloads": [f"{base['config']}.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = spec.load_json(spec.BENCH_DIR / "traffic" / f"{base['config']}.{base['traffic']}.json")
    (root / "riskbench" / "traffic" / f"{base['config']}.tiny.json").write_text(
        json.dumps({**traffic, "num_paths": 1024}))
    (root / "riskbench" / "metrics" / "runs_traced.py").write_text(
        "def read(record):\n    return None if record.trace is None else record.trace.runs\n")
    monkeypatch.setattr(spec, "BENCH_DIR", root / "riskbench")
    cell = spec.load_cell(f"{base['config']}.tiny", root=root)
    assert cell.traffic["num_paths"] == 1024
    assert "runs_traced" in [m["name"] for m in cell.per_layer]
    assert "runs_traced" not in [m["name"] for m in spec.load_cell(base["name"], root=root).per_layer]
    assert spec.reader("runs_traced").read(harness.Record(cell, 0, [], 0, 0, None, [])) is None


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_last_line(capsys, traced):
    rc, line, err = run_cell(capsys, "bs_multi_euro_book.pv_1m", traced)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert set(line["checks"]) == {"pv_gap"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    assert err.strip().splitlines()[-1].startswith("[check] pv_gap ")
    if traced:
        assert {"busy_s", "window_s"} <= set(dev) and set(line["breakdown"]) == {
            "device_ops", "idle_gaps"}
    else:
        assert {"run_s", "setup_s"} <= set(line["metrics"])
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.run("bs_multi_euro_book.pv_1m", SEED, 0.5, False, time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


@pytest.mark.parametrize("workload", CELLS)
def test_reference_against_the_port_and_its_control(workload):
    """The program agrees with the reference to rounding at a few thousand
    paths; the float32 control reads above the cell's limit in at least one
    number."""
    cell = spec.load_cell(workload)
    cell = cell._replace(traffic=small(cell.traffic))
    import montecarlo_risk_engine_tpu_torch as mt
    program = calibrate.readings(cell, mt, [SEED], "cpu")[SEED]
    for name, value in program.items():
        assert value <= cell.traffic["limits"][name] / 10, (name, value)
    mt.set_real_dtype(torch.float32)
    try:
        control = calibrate.readings(cell, mt, [SEED], "cpu")[SEED]
    finally:
        mt.set_real_dtype(None)
    assert any(control[k] > cell.traffic["limits"][k] for k in control), control


def _half_the_paths(monkeypatch):
    from riskbench import book
    real = book.build_controller

    def build(*args, **kwargs):
        c = real(*args, **kwargs)
        c.num_paths_mainsim //= 2  # the mean is taken over the first half
        return c
    monkeypatch.setattr(book, "build_controller", build)


def _a_step_left_unchanged(monkeypatch):
    from montecarlo_risk_engine_tpu_torch.models.hybrid import ModelConfig
    from montecarlo_risk_engine_tpu_torch.ops import hybrid_paths as k2
    kernel, engine, calls = k2.hybrid_substep, ModelConfig.step, [0, 0]

    def kernel_step(slots, prm, a, b, w, row):
        calls[0] += 1
        return (list(a), list(b)) if calls[0] % 10 == 1 else kernel(slots, prm, a, b, w, row)

    def engine_step(self, params, scheme, t1, t2, state, *args, **kwargs):
        calls[1] += 1
        return state if calls[1] % 10 == 1 else engine(self, params, scheme, t1, t2, state,
                                                        *args, **kwargs)
    monkeypatch.setattr(k2, "hybrid_substep", kernel_step)
    monkeypatch.setattr(ModelConfig, "step", engine_step)


def _one_answer_altered(monkeypatch):
    """One path's cashflow or exposure off by one unit where it is made."""
    from montecarlo_risk_engine_tpu_torch.api import batching, streaming_metrics

    def bump(cls, name, index):
        real = getattr(cls, name)

        def altered(self, *args, **kwargs):
            out = real(self, *args, **kwargs).clone()
            out[index] += 1.0
            return out
        monkeypatch.setattr(cls, name, altered)
    bump(batching.EuropeanEquityBatch, "segmented_cashflows", (0, 0))
    bump(batching.TerminalBatch, "exposure_contributions", (5, 0, 0))
    bump(streaming_metrics.MetricStreamExecutor, "_netted_row", (0, 0))


@pytest.mark.parametrize("fault", [_half_the_paths, _a_step_left_unchanged, _one_answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, line, _ = run_cell(capsys, workload)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_on_the_card(card, capsys, workload):
    rc = harness.run(workload, SEED, 2.0, False, time.perf_counter())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True and line["device"]["platform"] == "gpu"


def test_values_are_read_by_their_shape():
    import numpy as np
    import montecarlo_risk_engine_tpu_torch as mt
    from riskbench import book
    assert book._convert(mt, {"enum": "OptionType", "value": "PUT"}) is mt.OptionType.PUT
    assert isinstance(book._convert(mt, {"type": "Equity", "asset_id": "eq"}), mt.Equity)
    assert book._convert(mt, {"1.0": 0.02, "5": 0.03}) == {1.0: 0.02, 5.0: 0.03}
    m = book._convert(mt, [[1.0, 0.5], [0.5, 1.0]])
    assert isinstance(m, np.ndarray) and m.dtype == np.float64 and m.shape == (2, 2)
    nested = book._convert(mt, [[[0.25]], [[0.4]]])
    assert isinstance(nested, list) and all(isinstance(x, np.ndarray) for x in nested)
    assert book._convert(mt, [95.0, 102.5]) == [95.0, 102.5]


@pytest.mark.parametrize("rule", ["rebuilt", "every_tie_a_put"])
def test_bs_multi_tie_sides(monkeypatch, rule):
    """At 65,536 paths some float32 states equal a strike; the reference's
    rebuild of the port's float64 state puts each on the port's side of the
    kink, and a rule that ignores the rebuild reads far above the limit."""
    import montecarlo_risk_engine_tpu_torch as mt
    cell = spec.load_cell("bs_multi_euro_book.greeks_1m")
    cell = cell._replace(traffic={**cell.traffic, "num_paths": 1 << 16})
    ref, ties = cell.reference, []
    real = ref._ties

    def counted(*args):
        out = real(*args)
        ties.extend(out)
        return out
    monkeypatch.setattr(ref, "_ties", counted)
    if rule == "every_tie_a_put":  # this seed's ties all lie at or above the strike
        monkeypatch.setattr(ref, "program_rebuild",
                            lambda states32, *a: [torch.zeros_like(s, dtype=torch.float64)
                                                  for s in states32])
    reading = calibrate.readings(cell, mt, [2147483901], "cpu")[2147483901]["jac_gap"]
    assert ties
    limit = cell.traffic["limits"]["jac_gap"]
    assert (reading <= limit / 10) if rule == "rebuilt" else (reading > 100 * limit), reading
