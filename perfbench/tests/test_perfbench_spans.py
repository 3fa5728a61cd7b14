"""The program's spans read against the window's trace
(:mod:`perfbench.spans`): a hand-made trace with the program's collector
events on three other threads, at a known clock offset, and a tiny traced
run of the DLRM cell on the CPU."""

from __future__ import annotations

import pytest

from perfbench import spans
from perfbench.metrics._shared import device_idle_pct, input_stall_pct
from perfbench.runner import RunContext
from perfbench.tests.test_perfbench_trace import kernel, span, trace
from perfbench.trace import TraceSummary

#: The trace's ``baseTimeNanoseconds`` and the offset (µs) of the
#: collector's clock from the trace's absolute one.
BASE_NS, OFFSET_US = 1_700_000_000_000_000_000, 37.5


def collector_span(name, start, end, tid):
    """A collector B/E pair at trace times ``start``..``end`` (µs)."""
    to_collector = BASE_NS / 1e3 - OFFSET_US
    return [{"name": name, "ph": "B", "ts": start + to_collector, "pid": 9, "tid": tid,
             "args": {}},
            {"name": name, "ph": "E", "ts": end + to_collector, "pid": 9, "tid": tid}]


def launch(ts, correlation, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": correlation}}


def traced():
    """``trace()``'s window of 100 us with an update range in each step
    (its kernels 8 and 7 us, inside the card's busy time), and the
    collector's events: the update spans on the window's thread (the
    fit's pairs), a producer whose two decodes (the first begun before the
    window) hold a reader wait each, and two reader workers (one decode
    blocked 10 us on the full results queue, one still running at the
    window's end)."""
    events = trace() + [
        span(spans.UPDATE_OP, 20, 10), launch(21, 5),
        {**kernel(30, 8), "args": {"correlation": 5}},
        span(spans.UPDATE_OP, 80, 10), launch(82, 6),
        {**kernel(85, 7), "args": {"correlation": 6}},
    ]
    collector = (collector_span("step.update", 20, 30, 11)
                 + collector_span("step.update", 80, 90, 11)
                 + collector_span("loader.decode", -10, 40, 12)
                 + collector_span("reader.wait", 10, 30, 12)
                 + collector_span("loader.decode", 45, 90, 12)
                 + collector_span("reader.wait", 50, 55, 12)
                 + collector_span("reader.decode", 5, 45, 13)
                 + collector_span("reader.queue_wait", 30, 40, 13)
                 + collector_span("reader.decode", 50, 130, 13)
                 + collector_span("reader.decode", 0, 20, 14))
    return events, collector


def test_the_program_spans_read_the_hand_computed_values():
    events, collector = traced()
    summary = TraceSummary(events, (spans.UPDATE_OP,))
    program = spans.ProgramSpans(collector, events, 11, BASE_NS)
    assert program.offset_us == pytest.approx(OFFSET_US)
    assert [r for _, _, r in program.residuals_us] == pytest.approx([0.0] * 4, abs=1e-3)
    assert [ts for ts, _, _ in program.residuals_us] == pytest.approx([20, 30, 80, 90])
    ctx = RunContext(trace=summary, steps=2, spans=program, mix={"reader_workers": 2})
    # (8 + 7) us of update kernels over 2 steps.
    assert spans.update_device_ms(ctx) == pytest.approx(7.5e-3)
    # Decodes clipped to the window, less the queue wait: (40 - 10) + 50 +
    # 20 us over 100 us x 2 workers.
    assert spans.reader_busy_pct(ctx) == pytest.approx(50.0)
    # The producer's self time: (40 - 20) + (45 - 5) us over 100 us.
    assert spans.loader_busy_pct(ctx) == pytest.approx(60.0)
    # The window thread's spans are the profiler's ranges, its loader's
    # copy among them.
    assert program.counts == {"step.update": 2, "loader.copy": 1, "loader.decode": 2,
                              "reader.wait": 2, "reader.decode": 3, "reader.queue_wait": 1}


def test_the_old_readings_stand_beside_the_program_spans():
    events, _ = traced()
    old, new = TraceSummary(trace()), TraceSummary(events, (spans.UPDATE_OP,))
    assert new.busy_s == old.busy_s and new.window_s == old.window_s
    assert new.idle_under == old.idle_under and new.idle_gaps == old.idle_gaps
    assert input_stall_pct(RunContext(trace=new)) == input_stall_pct(RunContext(trace=old))
    assert device_idle_pct(RunContext(trace=new)) == device_idle_pct(RunContext(trace=old))


def test_nothing_is_read_without_the_program_spans():
    ctx = RunContext(trace=TraceSummary(trace()), steps=2, mix={"reader_workers": 2})
    assert [read(ctx) for read in spans.READERS.values()] == [None, None, None]
    events, collector = traced()
    unpaired = spans.ProgramSpans(collector, events, 99, BASE_NS)  # not the window's thread
    assert unpaired.offset_us is None and not unpaired.counts


def test_a_tiny_traced_dlrm_run_reads_every_layer(tiny_root):
    result, ctx, code = spans.traced_run(tiny_root, "dlrm-criteo-b8192", 2**31 + 9, 0.5,
                                         device="cpu")
    assert code == 0 and result["correct"] is True
    got = spans.readings(ctx)
    assert got["fit"]["ends_paired"] >= 2 * 6 * ctx.steps - 4  # window-edge spans aside
    assert got["metrics"]["update_device_ms"] == 0.0  # no device events on the CPU
    # The workers may sit the whole window blocked on a full results queue.
    assert 0 <= got["metrics"]["reader_busy_pct"] <= 100
    assert 0 < got["metrics"]["loader_busy_pct"] <= 100
    names = set(got["spans"])
    assert {"reader.decode", "reader.wait", "loader.decode", "loader.wait", "loader.device_put",
            "dlrm.collate", "step.forward", "step.backward", "step.update"} <= names
