"""The port's spans (montecarlo_risk_engine_tpu_torch/tracing.py): off, one
shared no-op that records nothing; on, nested records whose run ids count
the roots; the span tree of the benchmark's north-star greeks book, its
streaming forward route and the BS-multi PV book at a few hundred paths,
name by name; values bit for bit the same with tracing on and off; and the
spans on the clock that ``torch.profiler`` stamps its events with."""

import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import tracing

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from riskbench import book, spec  # noqa: E402

PATHS = 256
SEED = 2 ** 31 + 4099

# Spans a run, by name (the books of riskbench/configs at PATHS paths).
PV_BOOK = {"run": 1, "plan": 1, "paths": 1, "resolve": 1, "evaluate": 1, "value": 1,
           "netting": 1, "to_host": 1, "results": 1}
GREEKS_BOOK = {"run": 1, "plan": 1, "kernel_noise": 2, "jacobian": 1, "sweep": 2, "paths": 4,
               "resolve": 4, "fit": 4, "evaluate": 2, "value": 4, "netting": 2, "to_host": 1,
               "results": 1}
STREAM_BOOK = {"run": 1, "plan": 1, "paths": 1, "resolve": 1, "fit": 2, "stream": 1, "fold": 57,
               "assemble": 1, "to_host": 1, "results": 1}


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def controller(workload):
    cell = spec.load_cell(workload)
    traffic = {**cell.traffic, "num_paths": PATHS,
               "num_paths_presim": PATHS if cell.traffic["num_paths_presim"] else 0}
    return book.build_controller(mt, cell.config, traffic, SEED, "cpu"), traffic


def answers(c, traffic):
    out = book.read_results(c.run_simulation(), SEED, bool(traffic["differentiate"]))
    return [out.values, out.errors] + ([out.jac] if out.jac is not None else [])


def runs_of(spans):
    by_run = {}
    for s in spans:
        by_run.setdefault(s.run, []).append(s)
    return list(by_run.values())


def test_off_is_one_shared_noop_that_records_nothing():
    a, b = tracing.span("run"), tracing.span("value", family="EuropeanEquity", products=3)
    assert a is b and not tracing.enabled()
    with a:
        with b:
            pass
    assert tracing.take() == []


def test_on_nests_and_counts_runs():
    tracing.enable()
    for _ in range(2):
        with tracing.span("run", route="kernel"):
            with tracing.span("paths", phase=43, paths=8):
                with tracing.span("resolve", phase=43):
                    pass
            with tracing.span("to_host"):
                pass
    spans = tracing.take()
    assert tracing.take() == []
    assert [s.name for s in spans] == ["run", "paths", "resolve", "to_host"] * 2
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1, 4, 5, 4]
    assert spans[4].run == spans[0].run + 1 and len({s.run for s in spans[:4]}) == 1
    assert spans[1].attrs == {"phase": 43, "paths": 8}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("workload,expected,parents", [
    ("bs_multi_euro_book.pv_1m", PV_BOOK,
     {("paths", "run"), ("value", "evaluate"), ("netting", "evaluate"), ("to_host", "run")}),
    ("north_star_xva.greeks_1m", GREEKS_BOOK,
     {("kernel_noise", "run"), ("sweep", "jacobian"), ("paths", "sweep"), ("fit", "sweep"),
      ("value", "evaluate"), ("netting", "evaluate"), ("evaluate", "sweep")}),
    ("north_star_xva.fwd_16m", STREAM_BOOK,
     {("paths", "run"), ("fit", "run"), ("fold", "stream"), ("stream", "run"),
      ("assemble", "run")}),
], ids=["pv", "greeks", "streaming_forward"])
def test_span_tree_and_values_on_and_off(workload, expected, parents):
    c, traffic = controller(workload)
    plain = answers(c, traffic)
    tracing.enable()
    traced = answers(c, traffic)
    if workload != "north_star_xva.greeks_1m":  # the counts repeat run after run
        answers(c, traffic)
    spans = tracing.take()
    for run in runs_of(spans):
        assert run[0].name == "run" and run[0].parent == -1
        assert dict(Counter(s.name for s in run)) == expected
        assert {(s.name, spans[s.parent].name) for s in run if s.parent >= 0} >= parents
    assert len(runs_of(spans)) == (1 if workload == "north_star_xva.greeks_1m" else 2)
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    from riskbench import trace

    for _ in range(2):  # the first profile warms the profiler up
        tracing.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with tracing.span("run"):
                    with record_function("inside"):
                        torch.ones(64).sum()
        spans = tracing.take()
        tracing.disable()
    inside = sorted((trace._ns(ev, "start"), trace._ns(ev, "start") + trace._ns(ev, "duration"))
                    for ev in prof.profiler.kineto_results.events() if ev.name() == "inside")
    assert len(inside) == len(spans) == 3
    for (start, end), s in zip(inside, spans):
        assert s.start_ns - 50_000 <= start and end <= s.end_ns + 50_000, (start, end, s)


def small_mixed_book(per_family=2):
    """The benchmark's mixed book, each family cut to its first products."""
    cell = spec.load_cell("mixed_pv_book.pv_1k")
    cfg = {**cell.config, "netting_sets": [{**ns, "products": [{**e, "count": per_family}
                                                                for e in ns["products"]]}
                                           for ns in cell.config["netting_sets"]]}
    traffic = {**cell.traffic, "num_paths": PATHS, "num_paths_presim": PATHS}
    return book.build_controller(mt, cfg, traffic, SEED, "cpu"), traffic


def test_exercise_spans_one_a_scan_and_phase():
    from montecarlo_risk_engine_tpu_torch.api.batching import ExerciseEquityBatch

    c, traffic = small_mixed_book()
    batches = [b for b in c._batches if isinstance(b, ExerciseEquityBatch)]
    buckets = c._exercise_scan_groups()[0]
    assert batches and buckets
    scans = ([(type(b.products[0]).__name__, len(b.products), len(b.products[0].product_timeline))
              for b in batches]
             + [(type(b[0]).__name__, len(b), len(b[0].product_timeline)) for b in buckets])
    tracing.enable()
    answers(c, traffic)
    spans = tracing.take()
    exercise = [s for s in spans if s.name == "exercise"]
    assert sorted((s.attrs["kind"], s.attrs["products"], s.attrs["steps"], s.attrs["phase"])
                  for s in exercise) == sorted(scan + (phase,) for scan in scans
                                               for phase in ("fit", "value"))
    assert {s.attrs["kind"] for s in exercise} == {"AmericanOption", "FlexiCall", "Storage"}
    for s in exercise:
        assert spans[s.parent].name == s.attrs["phase"]
        assert not any(x.parent == spans.index(s) for x in spans)  # the scan alone


def test_exercise_spans_off_keep_nothing_and_change_no_value():
    c, traffic = small_mixed_book()
    plain = answers(c, traffic)
    assert tracing.take() == [] and not tracing.enabled()
    tracing.enable()
    traced = answers(c, traffic)
    assert any(s.name == "exercise" for s in tracing.take())
    tracing.disable()
    again = answers(c, traffic)
    assert tracing.take() == []
    for a, b, d in zip(plain, traced, again):
        assert np.array_equal(a, b) and np.array_equal(a, d)


# The Heston QE surface: K1's one launch a run inside the span that owns it.
HESTON_PV = {"run": 1, "plan": 1, "paths": 1, "resolve": 1, "evaluate": 1, "value": 1,
             "netting": 50, "to_host": 1, "results": 1}
HESTON_GREEKS = {"run": 1, "plan": 1, "kernel_noise": 1, "jacobian": 1, "sweep": 1, "paths": 1,
                 "resolve": 1, "evaluate": 1, "value": 1, "netting": 50, "to_host": 1,
                 "results": 1}


@pytest.mark.parametrize("workload,expected,owner,route,emits,rebuilds", [
    ("heston_qe_book.pv_1m", HESTON_PV, "paths", "kernel", 0, {}),
    ("heston_qe_book.greeks_1m", HESTON_GREEKS, "kernel_noise", "recon_kernel", 1, {0: 1, 7: 1}),
], ids=["pv", "greeks"])
def test_heston_spans_and_k1_launches(monkeypatch, workload, expected, owner, route, emits,
                                      rebuilds):
    """K1's launches, and those of the greeks' rebuild kernel
    (ops/qe_tangents.py: a primal and a 7-tangent launch inside ``paths``),
    are counted by their wrappers on the card; on the CPU their plain
    versions stand in, counted here the same way."""
    from montecarlo_risk_engine_tpu_torch.ops import heston_qe, qe_tangents

    real, stamps = heston_qe.heston_qe_paths_reference, []
    real_rebuild, rebuild_stamps = qe_tangents.qe_planes_reference, []

    def counted(*args, **kwargs):
        stamps.append(time.time_ns())
        heston_qe.heston_qe_paths.launches += 1
        heston_qe.heston_qe_paths.emit_launches += int(bool(kwargs.get("emit_noise")))
        return real(*args, **kwargs)

    def counted_rebuild(*args):
        rebuild_stamps.append(time.time_ns())
        qe_tangents.qe_planes.launches[0 if len(args) < 7 or args[6] is None
                                       else args[6].shape[0]] += 1
        return real_rebuild(*args)
    monkeypatch.setattr(heston_qe, "heston_qe_paths_reference", counted)
    monkeypatch.setattr(heston_qe.heston_qe_paths, "launches", 0)
    monkeypatch.setattr(heston_qe.heston_qe_paths, "emit_launches", 0)
    monkeypatch.setattr(qe_tangents, "qe_planes_reference", counted_rebuild)
    monkeypatch.setattr(qe_tangents.qe_planes, "launches", Counter())
    c, traffic = controller(workload)
    plain = answers(c, traffic)
    before = (heston_qe.heston_qe_paths.launches, heston_qe.heston_qe_paths.emit_launches)
    assert dict(qe_tangents.qe_planes.launches) == rebuilds
    tracing.enable()
    traced = [answers(c, traffic) for _ in range(2)]
    spans = tracing.take()
    tracing.disable()
    launched = (heston_qe.heston_qe_paths.launches - before[0],
                heston_qe.heston_qe_paths.emit_launches - before[1])
    assert before == (1, emits) and launched == (2, 2 * emits)  # one launch a run
    assert dict(qe_tangents.qe_planes.launches) == {k: 3 * n for k, n in rebuilds.items()}
    for run in runs_of(spans):
        assert dict(Counter(s.name for s in run)) == expected
        (paths,) = [s for s in run if s.name == "paths"]
        assert paths.attrs["route"] == route
        (own,) = [s for s in run if s.name == owner]
        assert sum(own.start_ns <= t <= own.end_ns for t in stamps) == 1
        assert sum(paths.start_ns <= t <= paths.end_ns
                   for t in rebuild_stamps) == sum(rebuilds.values())
    for a, b, d in zip(plain, *traced):
        assert np.array_equal(a, b) and np.array_equal(a, d)
