"""The trace reductions against a small hand-made Chrome trace."""

from __future__ import annotations

import pytest

from perfbench.metrics._shared import device_idle_pct, input_stall_pct
from perfbench.runner import RunContext
from perfbench.trace import TraceSummary


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def trace():
    """A window of 100 us: two steps, each after a ``next()``. The first
    ``next()`` returns while the card still runs (no stall); the second
    makes the card wait 10 us, and the gap begins under a loader span
    nested in it; the card idles 5 us more at the end of the second step.
    The loader's thread has a span of its own that must not count."""
    return [
        span("perfbench.window", 0, 100),
        span("perfbench.next_batch", 0, 5),
        span("perfbench.step", 5, 30),
        kernel(0, 50),
        span("perfbench.next_batch", 40, 20),
        span("petastorm_tpu_torch.loader.copy", 45, 13),
        span("perfbench.step", 60, 38),
        span("petastorm_tpu_torch.loader.decode", 20, 60, tid=2),
        kernel(60, 35),
    ]


def test_idle_gaps_are_summed_by_innermost_and_by_every_open_span():
    summary = TraceSummary(trace())
    assert summary.window_s == pytest.approx(100e-6)
    assert summary.busy_s == pytest.approx(85e-6)
    assert dict(summary.idle_gaps) == pytest.approx(
        {"petastorm_tpu_torch.loader.copy": 10e-6, "perfbench.step": 5e-6})
    assert summary.idle_under["perfbench.next_batch"] == pytest.approx(10e-6)
    assert summary.idle_under["petastorm_tpu_torch.loader.copy"] == pytest.approx(10e-6)
    assert "petastorm_tpu_torch.loader.decode" not in summary.idle_under


def test_input_stall_counts_only_the_card_waiting_inside_next():
    ctx = RunContext(trace=TraceSummary(trace()))
    assert input_stall_pct(ctx) == pytest.approx(10.0)
    assert device_idle_pct(ctx) == pytest.approx(15.0)
    assert input_stall_pct(RunContext(trace=None)) is None
