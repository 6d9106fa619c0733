"""The reduction of a trace: busy time as a union, idle gaps by host op."""

import pytest

from riskbench import trace
from riskbench.trace import Event


def test_merge_and_gaps():
    busy = trace.merge([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.gaps(busy, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0)]


def test_innermost_op_names_each_point():
    host = [Event("outer", 0.0, 10.0, 1), Event("inner", 2.0, 3.0, 1),
            Event("later", 4.0, 9.0, 1), Event("deep", 5.0, 6.0, 1), Event("other", 0.5, 1.5, 2)]
    names = trace.innermost_ops(host, [2.5, 3.5, 5.5, 8.0, 11.0, 1.0])
    # at 1.0 thread 2's "other" started after thread 1's open "outer"
    assert names == ["inner", "outer", "deep", "later", None, "other"]


def test_summarize_counts_overlap_once_and_names_idle_gaps():
    device = [Event("k1", 1.0, 3.0), Event("k2", 2.0, 4.0), Event("Memcpy DtoH", 6.0, 7.0),
              Event("k1", 20.0, 21.0)]  # outside the window
    host = [Event(trace.RUN_RANGE, 0.0, 5.0), Event(trace.RUN_RANGE, 5.0, 10.0),
            Event("aten::mm", 0.0, 1.0), Event("aten::item", 4.0, 5.0),
            Event("aten::copy_", 7.0, 10.0)]
    s = trace.summarize(device, host)
    assert s.window_s == 10.0 and s.runs == 2
    assert s.busy_s == pytest.approx(4.0)  # [1, 4] and [6, 7]
    assert dict(s.device_ops) == {"k1": 2.0, "k2": 2.0, "Memcpy DtoH": 1.0}
    assert dict(s.idle_gaps) == {"aten::mm": 1.0, "aten::item": 2.0, "aten::copy_": 3.0}
    assert trace.count(s.device_events, trace.is_kernel) == 2
    assert trace.kernel_seconds(s.device_events, ("k2",)) == [2.0]


def test_a_cpu_profile_gives_the_run_ranges():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(trace.RUN_RANGE):
                torch.ones(8).sum()
    device, host = trace.from_profiler(prof)
    assert device == []
    assert sum(e.name == trace.RUN_RANGE for e in host) == 2
    s = trace.summarize(device, host)
    assert s.runs == 2 and s.busy_s == 0.0 and s.window_s > 0


def test_device_summary_takes_the_host_window():
    device = [Event("k1", 1.0, 3.0), Event("k2", 2.0, 4.0), Event("Memset", 6.0, 6.5)]
    s = trace.device_summary(device, 10.0, 2, [("aten::mm", 0.7)])
    assert s.window_s == 10.0 and s.runs == 2
    assert s.busy_s == pytest.approx(3.5)  # [1, 4] and [6, 6.5]
    assert dict(s.device_ops) == {"k1": 2.0, "k2": 2.0, "Memset": 0.5}
    assert s.idle_gaps == [("aten::mm", 0.7)]
    assert trace.span(device) == 5.5 and trace.span([]) == 0.0
