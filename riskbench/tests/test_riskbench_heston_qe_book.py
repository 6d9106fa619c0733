"""The Heston QE surface's cells: a substep of K1 left unchanged reads as
not correct in both; K1's work is counted from its launch shapes; and the
two readers of K1 (k1_ms, k1_roofline_pct) read a synthetic device trace
per run, and nothing where the launches are not one a run.

The planted step patches the plain twin of K1's QE update, which the CPU
route runs for the forward paths, and the model's QE step, which rebuilds
the differentiated cell's paths from K1's emitted draws: the greeks cell's
values come from that rebuild."""

import json
import time

import pytest

from riskbench import counting, counting_k1, harness, spec, trace

CELLS = ["heston_qe_book.pv_1m", "heston_qe_book.greeks_1m"]
SEED = 2 ** 31 + 977
PATHS = 2048
K1_NAME = "void (anonymous namespace)::heston_qe_kernel<false, false>(float2*, float2*, float*)"


def run_cell(capsys, workload):
    traffic = {**spec.load_cell(workload).traffic, "num_paths": PATHS, "check_runs": 2}
    rc = harness.run(workload, SEED, 0.5, False, time.perf_counter(), device="cpu",
                     traffic_overrides=traffic)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _a_k1_step_left_unchanged(monkeypatch):
    from montecarlo_risk_engine_tpu_torch.models.heston import HestonModel
    from montecarlo_risk_engine_tpu_torch.ops import heston_qe
    kernel, model, calls = heston_qe.heston_qe_substep, HestonModel.step_qe, [0, 0]

    def kernel_step(log_s, v, *args, **kwargs):
        calls[0] += 1
        return (log_s, v) if calls[0] % 10 == 1 else kernel(log_s, v, *args, **kwargs)

    def model_step(self, params, t1, t2, state, *args):
        calls[1] += 1
        return state if calls[1] % 10 == 1 else model(self, params, t1, t2, state, *args)
    monkeypatch.setattr(heston_qe, "heston_qe_substep", kernel_step)
    monkeypatch.setattr(HestonModel, "step_qe", model_step)
    return calls


@pytest.mark.parametrize("workload", CELLS)
def test_a_k1_step_left_unchanged_is_not_correct(capsys, monkeypatch, workload):
    calls = _a_k1_step_left_unchanged(monkeypatch)
    rc, line = run_cell(capsys, workload)
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert calls[1 if "greeks" in workload else 0] > 0


def test_k1_work_by_hand():
    launch = counting_k1.Launch((0.5, 1.0), 4, 1000)
    # 8 substeps of one Philox call, 3 uniforms, a Box-Muller pair and the
    # QE update; (log S, v) float32 at 2 points
    assert counting_k1.ops(launch) == 1000 * 8 * (98 + 15 + 8 + 52)
    assert counting_k1.nbytes(launch) == 2 * 1000 * 8
    emit = counting_k1.Launch(counting_k1.dense((0.5, 1.0), 4), 1, 1000, True)
    assert emit.timeline == (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
    assert counting_k1.ops(emit) == counting_k1.ops(launch)
    assert counting_k1.nbytes(emit) == 8 * 1000 * (8 + 12)


@pytest.mark.parametrize("workload, emit, bound_ms, by", [
    ("heston_qe_book.pv_1m", False, 0.10830, "operations"),
    ("heston_qe_book.greeks_1m", True, 0.25041, "bytes"),
])
def test_one_launch_a_run_and_its_bound(workload, emit, bound_ms, by):
    cell = spec.load_cell(workload)
    (launch,) = counting_k1.launches(cell.config, cell.traffic)
    assert launch.emit == emit and launch.num_paths == 1 << 20
    assert counting.live_substeps(launch.timeline, launch.num_steps) == 40
    t, bound_by = counting_k1.least_seconds(launch)
    assert bound_by == by and t * 1e3 == pytest.approx(bound_ms, rel=1e-4)
    assert cell.reference.path_launches(cell.config, cell.traffic) == []


def record(workload, durations, runs):
    events, t = [], 0.0
    for d in durations:
        events += [trace.Event("void fill_kernel(double*)", t, t + 1e-5),
                   trace.Event(K1_NAME, t + 2e-5, t + 2e-5 + d)]
        t += 1.0
    summary = trace.device_summary(events, float(runs), runs)
    return harness.Record(spec.load_cell(workload), 0.0, [1.0] * runs, float(runs), 0, summary, [])


@pytest.mark.parametrize("workload", CELLS)
def test_the_k1_readers_read_a_trace_per_run(workload):
    rec = record(workload, [6e-4, 5e-4], 2)
    assert spec.reader("k1_ms").read(rec) == pytest.approx(0.55)
    (launch,) = counting_k1.launches(rec.cell.config, rec.cell.traffic)
    least = counting_k1.least_seconds(launch)[0]
    assert spec.reader("k1_roofline_pct").read(rec) == pytest.approx(100 * 2 * least / 1.1e-3)
    assert {"k1_ms", "k1_roofline_pct"} <= {m["name"] for m in rec.cell.per_layer}


@pytest.mark.parametrize("workload", CELLS)
def test_nothing_unless_one_launch_a_run(workload):
    assert spec.reader("k1_roofline_pct").read(record(workload, [5e-4] * 3, 2)) is None
    assert spec.reader("k1_ms").read(record(workload, [], 2)) is None
    assert spec.reader("k1_roofline_pct").read(record(workload, [], 2)) is None
    empty = harness.Record(spec.load_cell(workload), 0.0, [], 0.0, 0, None, [])
    assert spec.reader("k1_ms").read(empty) is None
    assert spec.reader("k1_roofline_pct").read(empty) is None


def test_listed_for_the_heston_cells_alone():
    for name in ("k1_ms", "k1_roofline_pct"):
        bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
        (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert metric["workloads"] == CELLS and metric["layer"] == "path kernel K1"
        assert name not in {m["name"] for m in spec.load_cell("bs_multi_euro_book.pv_1m").per_layer}

