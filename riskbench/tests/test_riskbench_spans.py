"""The span pass (riskbench/spans.py): the card's idle time cut at span
boundaries and put down to the innermost span, the layers and the
harness's share summing to the pass's idle time, the clock's slack, and
readers that read nothing without spans."""

import json
import sys
import time

import pytest

from riskbench import book, harness, spans, spec, trace
from riskbench.tests.test_riskbench_cells import SEED, small

NEW = ("controller_idle_ms", "paths_idle_ms", "valuation_idle_ms", "valuation_host_ms",
       "host_wait_ms")
US = 1000  # ns


def span(name, start, end, parent, run):
    from montecarlo_risk_engine_tpu_torch.tracing import Span
    return Span(name, start * US, end * US, parent, run, {})


SPANS = [span("run", 0, 100, -1, 1), span("plan", 0, 10, 0, 1), span("paths", 10, 50, 0, 1),
         span("resolve", 30, 40, 2, 1), span("to_host", 90, 100, 0, 1),
         span("run", 120, 200, -1, 2), span("value", 130, 180, 5, 2)]
DEVICE = [(5 * US, 20 * US, "k1"), (35 * US, 60 * US, "k2"), (95 * US, 98 * US, "Memcpy DtoH"),
          (150 * US, 160 * US, "k1")]


def test_idle_is_cut_at_span_boundaries_and_goes_to_the_innermost_span():
    s = spans.summarize(SPANS, DEVICE, 0, 210 * US)
    got = {k: round(v * 1e6, 6) for k, v in s.idle_s.items()}
    # run 1: [0, 5] plan; [20, 30] paths, [30, 35] resolve; [60, 90] run, [90, 95] and
    # [98, 100] to_host.  run 2: [120, 130] and [180, 200] run, [130, 150] and [160, 180] value
    assert got == {"plan": 5, "paths": 10, "resolve": 5, "run": 60, "to_host": 7, "value": 40}
    assert s.runs == 2 and s.spans_per_run == 3.5
    assert s.valuation_host_s == pytest.approx(60e-6) and s.to_host_s == pytest.approx(10e-6)
    assert {k: round(v * 1e6, 6) for k, v in s.self_s.items()} == {
        "run": 70, "plan": 10, "paths": 30, "resolve": 10, "to_host": 10, "value": 50}
    assert s.first_kernel_slack_s == pytest.approx(5e-6)
    assert s.last_event_slack_s == pytest.approx(-2e-6)


def test_the_clock_slack_takes_each_event_to_its_nearest_run():
    # the gap between the runs is [100, 120], its middle 110: a copy that
    # ends 4 us after run 1's to_host is run 1's; a copy 4 us and a kernel
    # 1 us before run 2 starts are run 2's
    device = DEVICE + [(103 * US, 104 * US, "Memcpy HtoD"), (116 * US, 117 * US, "Memcpy HtoD"),
                       (119 * US, 121 * US, "k3")]
    s = spans.summarize(SPANS, device, 0, 210 * US)
    assert s.first_kernel_slack_s == pytest.approx(-1e-6)
    assert s.last_event_slack_s == pytest.approx(4e-6)


def test_layers_and_the_harness_share_sum_to_the_pass_idle():
    s = spans.summarize(SPANS, DEVICE, 0, 210 * US)
    layers = {layer: spans.layer_idle_s(s, layer) for layer in spans.LAYERS}
    assert layers == pytest.approx({"controller": 65e-6, "paths": 10e-6, "valuation": 45e-6,
                                    "device_wait": 7e-6})
    assert s.harness_idle_s == pytest.approx(30e-6)  # [100, 120] and [200, 210]
    assert sum(layers.values()) + s.harness_idle_s == pytest.approx(s.total_idle_s)
    assert s.total_idle_s == pytest.approx(157e-6)


def test_no_device_work_is_all_idle():
    s = spans.summarize(SPANS, [], 0, 210 * US)
    assert s.total_idle_s == pytest.approx(210e-6)
    assert sum(s.idle_s.values()) == pytest.approx(180e-6)
    assert s.first_kernel_slack_s is None and s.last_event_slack_s is None


def test_stamps_set_the_cards_clock():
    # stamps 2 ms apart, each a kernel of 10 us in a 50 us window; the card's
    # records 450 us late before the runs and 50 us late after them
    before = [(1000 * US, 1050 * US), (3000 * US, 3050 * US)]
    after = [(9000 * US, 9050 * US), (11000 * US, 11050 * US)]

    def stamp(t0, late):
        return (t0 + (20 + late) * US, t0 + (30 + late) * US, "bessel_j0_kernel")

    device = [stamp(t0, 450) for t0, _ in before] + [stamp(t0, 50) for t0, _ in after]
    kernels = [(s, e) for s, e, _ in device]
    assert spans.stamp_offsets_ns(kernels, before) == [450 * US, 450 * US]
    assert spans.stamp_offsets_ns(kernels[1:], before) == [450 * US]  # a lost record
    assert spans.stamp_offsets_ns(kernels, [(20000 * US, 20050 * US)]) == []
    work = [(6275 * US, 6375 * US, "k1")]  # between the groups: 450 us less the drift so far
    late = (450 - 400 * (6275 - 3050) / (9000 - 3050)) * US
    (got,) = spans.calibrated(device + work, before, after)
    assert got[0] == pytest.approx(6275 * US - late) and got[1] == pytest.approx(6375 * US - late)
    assert spans.calibrated(device[1:2] + work, before, []) == [(5825 * US, 5925 * US, "k1")]
    # stamps after the runs that disagree (records late) are not used
    torn = device[:2] + [stamp(after[0][0], 50), stamp(after[1][0], 650)]
    assert spans.calibrated(torn + work, before, after) == [(5825 * US, 5925 * US, "k1")]


def small_record():
    cell = spec.load_cell("bs_multi_euro_book.pv_1m")
    cell = cell._replace(traffic=small(cell.traffic))
    return harness.Record(cell, 0.0, [0.01], 0.01, 0, trace.TraceSummary(0.01, 0.0, 1, [], [], []),
                          [])


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_nothing_outside_the_harness(name):
    cell = spec.load_cell("bs_multi_euro_book.pv_1m")
    assert spec.reader(name).read(harness.Record(cell, 0.0, [0.01], 0.01, 0, None, [])) is None
    assert spec.reader(name).read(small_record()) is None  # no harness.run frame above


def test_no_pass_without_the_tracing_module(monkeypatch):
    import montecarlo_risk_engine_tpu_torch as mt
    monkeypatch.delattr(mt, "tracing")
    monkeypatch.setitem(sys.modules, "montecarlo_risk_engine_tpu_torch.tracing", None)
    monkeypatch.setattr(spans, "_harness_controller", lambda: pytest.fail("looked for a run"))
    assert spans.run_pass(small_record()) is None


def test_a_pass_that_records_no_span_reads_nothing(monkeypatch):
    import montecarlo_risk_engine_tpu_torch as mt
    from montecarlo_risk_engine_tpu_torch import tracing
    record = small_record()
    c = book.build_controller(mt, record.cell.config, record.cell.traffic, SEED, "cpu")
    monkeypatch.setattr(spans, "_harness_controller", lambda: c)
    monkeypatch.setattr(tracing, "enable", lambda annotate=False: None)
    assert spans.run_pass(record) is None
    for name in NEW:
        assert spec.reader(name).read(record) is None


def test_the_traced_line_reports_the_span_metrics(capsys):
    workload = "bs_multi_euro_book.pv_1m"
    rc = harness.run(workload, SEED, 0.5, True, time.perf_counter(), device="cpu",
                     traffic_overrides=small(spec.load_cell(workload).traffic))
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    for name in NEW:
        assert line["metrics"][name]["unit"] == "ms/run" and line["metrics"][name]["value"] >= 0
    assert "[spans] pass: 1 runs" in out.err
    assert "[spans] idle ms/run by span: " in out.err
