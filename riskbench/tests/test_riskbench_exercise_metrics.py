"""The two readers of the ``exercise`` spans (exercise_idle_ms,
exercise_host_ms): per run from a span pass's summary, the card's idle
inside an ``exercise`` span its own and not its parent's, and nothing from
a pass without such spans or without a pass."""

import pytest

from riskbench import harness, spans, spec

US = 1000  # ns
READERS = ("exercise_idle_ms", "exercise_host_ms")


def span(name, start, end, parent, run):
    from montecarlo_risk_engine_tpu_torch.tracing import Span
    return Span(name, start * US, end * US, parent, run, {})


# two runs: a fit with an exercise scan inside, a value with one inside
SPANS = [span("run", 0, 100, -1, 1), span("fit", 10, 60, 0, 1), span("exercise", 20, 50, 1, 1),
         span("run", 120, 220, -1, 2), span("value", 130, 200, 3, 2),
         span("exercise", 140, 190, 4, 2)]
DEVICE = [(0, 10 * US, "k"), (30 * US, 40 * US, "k"), (60 * US, 100 * US, "k"),
          (120 * US, 130 * US, "k"), (150 * US, 160 * US, "k"), (200 * US, 220 * US, "k")]


def record():
    cell = spec.load_cell("mixed_pv_book.pv_1k")
    return harness.Record(cell, 0.0, [0.1, 0.1], 0.2, 0, None, [])


def read(monkeypatch, name, summary):
    rec = record()
    monkeypatch.setattr(spans, "_last", [rec, summary])
    return spec.reader(name).read(rec)


def test_idle_inside_an_exercise_span_is_its_own():
    s = spans.summarize(SPANS, DEVICE, 0, 230 * US)
    # run 1: exercise [20, 30] and [40, 50], fit [10, 20] and [50, 60];
    # run 2: exercise [140, 150] and [160, 190], value [130, 140] and [190, 200]
    assert s.idle_s["exercise"] == pytest.approx(60e-6)
    assert s.idle_s["fit"] == pytest.approx(20e-6) and s.idle_s["value"] == pytest.approx(20e-6)
    assert s.self_s["exercise"] == pytest.approx(80e-6)


def test_the_readers_read_a_pass_per_run(monkeypatch):
    s = spans.summarize(SPANS, DEVICE, 0, 230 * US)
    assert read(monkeypatch, "exercise_idle_ms", s) == pytest.approx(60e-3 / 2)
    assert read(monkeypatch, "exercise_host_ms", s) == pytest.approx(80e-3 / 2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_exercise_spans(monkeypatch, name):
    plain = [sp for sp in SPANS if sp.name != "exercise"]
    s = spans.summarize(plain, DEVICE, 0, 230 * US)
    assert read(monkeypatch, name, s) is None
    assert read(monkeypatch, name, None) is None


@pytest.mark.parametrize("name", READERS)
def test_listed_for_the_mixed_book_alone(name):
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert metric["workloads"] == ["mixed_pv_book.pv_1k"] and metric["layer"] == "valuation"
    assert name in {m["name"] for m in spec.load_cell("mixed_pv_book.pv_1k").per_layer}
    assert name not in {m["name"] for m in spec.load_cell("bs_multi_euro_book.pv_1m").per_layer}
