"""The program's own spans (``petastorm_tpu_torch.telemetry.tracing``) read
against the window's profiler trace, and a traced run of a cell that arms
them.

The profiler records only the thread that entered it: the window's. The
reader's workers and the loader's producer record into the program's
``COLLECTOR`` alone. :class:`ProgramSpans` moves the ``COLLECTOR`` spans
of those other threads onto the trace's clock by the offset
``fit_profiler_clock`` measures from the spans that reached both sinks,
takes the window thread's spans from the profiler's own ranges where
it has them (the truth there: a span's ``COLLECTOR`` reads trail the
profiler's stamps by whatever wait for the interpreter lock came between
them), clips them to ``perfbench.window``, and sums seconds, self seconds
(less the part child spans on the same thread cover) and counts by name,
across threads.
The readers below turn them, and the device time of the work launched
inside the ``step.update`` span, into the per-layer numbers of three
layers:

- ``update_device_ms``: device ms a step of the SGD update (model step);
- ``reader_busy_pct``: ``reader.decode`` self seconds (the
  ``reader.queue_wait`` inside them, a worker blocked on the full results
  queue, taken out) over the window's seconds times the reader's workers
  (reader);
- ``loader_busy_pct``: ``loader.decode`` self seconds (the ``reader.wait``
  inside them taken out) over the window's seconds; 100 % is the one
  producer thread saturated (loader).

The runner does not arm ``COLLECTOR`` around its window, so these are not
yet metrics of ``BENCHMARK.json``; ``python -m perfbench.spans --workload
<cell> --seed <n> --seconds <s>`` makes a ``--trace 1`` run of the cell
through the runner with ``COLLECTOR`` armed over the window and prints
the runner's result with these readings as one JSON line.

:func:`traced_run`, :func:`readings` and :func:`main` are that stopgap.
:func:`traced_run` swaps three of the runner's module globals for the
length of one run and wraps the cell's ``mark_window`` and ``close``, so
it leans on how :func:`perfbench.runner.run_cell` looks them up; the tiny
CPU run in ``perfbench/tests/test_perfbench_spans.py`` breaks if that
changes. Once the runner arms ``COLLECTOR`` itself and hands its events
to the metric readers, the three go, and :class:`ProgramSpans` and the
readers stay.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
from collections import defaultdict

from perfbench.trace import WINDOW_SPAN, window_bounds
from petastorm_tpu_torch.telemetry.critical_path import pair_spans
from petastorm_tpu_torch.telemetry.tracing import (
    COLLECTOR,
    PROFILER_PREFIX,
    fit_profiler_clock,
)

#: The profiler's name of the program's SGD update span.
UPDATE_OP = "petastorm_tpu_torch.step.update"


class ProgramSpans:
    """The program's spans on the trace's clock, clipped to the window.

    ``events``: the collector's events; ``trace_events``: the profiler's
    Chrome trace events, ``base_time_ns`` its ``baseTimeNanoseconds``;
    ``tid``: the collector's id of the window's thread (where the spans
    that reach both sinks are, and whose spans are read from the
    profiler's ranges instead, where the profiler has the name).
    ``seconds``, ``self_seconds`` and
    ``counts`` are by span name; ``offset_us`` and ``residuals_us`` (each
    paired end's ``(trace ts, span name, residual)``, in time order) are
    the clock fit's (None and ``[]`` when no span reached both sinks:
    then nothing is read)."""

    def __init__(self, events, trace_events, tid, base_time_ns=0):
        lo, hi = window_bounds(trace_events)
        self.window_s = (hi - lo) * 1e-6
        self.offset_us, fit = fit_profiler_clock(events, trace_events, tid, base_time_ns)
        self.residuals_us = sorted(fit)
        self.seconds, self.self_seconds = defaultdict(float), defaultdict(float)
        self.counts = defaultdict(int)
        if self.offset_us is None:
            return
        window = next(e for e in trace_events
                      if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN)
        by_thread = defaultdict(list)
        for e in trace_events:
            name = e.get("name", "")
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                    and (e.get("pid"), e.get("tid")) == (window.get("pid"), window.get("tid")) \
                    and name.startswith(PROFILER_PREFIX):
                start = float(e["ts"])
                by_thread["window"].append((start, start + float(e.get("dur", 0.0)),
                                            name[len(PROFILER_PREFIX):]))
        ranged = {name for _, _, name in by_thread["window"]}
        shift = self.offset_us - base_time_ns / 1e3
        for s in pair_spans(events):
            on_window = s["tid"] == tid
            if on_window and s["name"] in ranged:
                continue
            start = s["ts"] + shift
            by_thread["window" if on_window else (s["pid"], s["tid"])].append(
                (start, start + s["dur"], s["name"]))
        for spans in by_thread.values():
            # Spans nest on a thread: each one's direct children are disjoint.
            stack = []  # [end, name, clipped seconds, seconds its children cover]
            for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
                while stack and stack[-1][0] <= start:
                    self._close(stack.pop())
                clipped = max(0.0, min(end, hi) - max(start, lo)) * 1e-6
                if stack:
                    stack[-1][3] += clipped
                stack.append([end, name, clipped, 0.0])
                if clipped > 0:
                    self.counts[name] += 1
            while stack:
                self._close(stack.pop())

    def _close(self, entry):
        _, name, clipped, covered = entry
        self.seconds[name] += clipped
        self.self_seconds[name] += clipped - covered


def update_device_ms(ctx):
    """Device ms a step of the work launched inside ``step.update``."""
    if ctx.trace is None or not ctx.steps:
        return None
    seconds = ctx.trace.op_device_s.get(UPDATE_OP)
    return None if seconds is None else 1e3 * seconds / ctx.steps


def reader_busy_pct(ctx):
    """``reader.decode`` self seconds over the window's seconds x the workers."""
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.counts.get("reader.decode"):
        return None
    return (100.0 * spans.self_seconds["reader.decode"]
            / (spans.window_s * ctx.mix["reader_workers"]))


def loader_busy_pct(ctx):
    """``loader.decode`` self seconds over the window's seconds."""
    spans = getattr(ctx, "spans", None)
    if spans is None or not spans.counts.get("loader.decode"):
        return None
    return 100.0 * spans.self_seconds["loader.decode"] / spans.window_s


READERS = {"update_device_ms": update_device_ms, "reader_busy_pct": reader_busy_pct,
           "loader_busy_pct": loader_busy_pct}


def traced_run(root, workload, seed, seconds, device="cuda"):
    """A ``--trace 1`` run of ``workload`` through the runner with
    ``COLLECTOR`` armed from the window's start to the loader's close;
    returns the runner's result, its run context (with ``spans``) and
    exit code. The runner's own reductions are untouched: the trace's
    events and base time are kept on the side, and ``UPDATE_OP`` is added
    to the host ops whose device time the summary reads. ``device="cpu"``
    serves the tests."""
    from perfbench import runner, trace

    kept = {}
    load_events, summary_class, context_class = (trace.load_events, trace.TraceSummary,
                                                 runner.RunContext)

    def keep_events(path):
        with open(path) as f:
            doc = json.load(f)
        kept["events"], kept["base_ns"] = doc["traceEvents"], doc.get("baseTimeNanoseconds", 0)
        return kept["events"]

    class Summary(summary_class):
        def __init__(self, events, host_ops=()):
            super().__init__(events, tuple(host_ops) + (UPDATE_OP,))

    class Context(context_class):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            kept["ctx"] = self

    def patch(cell):
        mark_window, close = cell.mark_window, cell.close

        def armed_window():
            kept["tid"] = threading.get_ident() % 1_000_000
            COLLECTOR.acquire()
            mark_window()

        def disarmed_close():
            COLLECTOR.release()
            close()

        cell.mark_window, cell.close = armed_window, disarmed_close

    trace.load_events, trace.TraceSummary, runner.RunContext = keep_events, Summary, Context
    try:
        result, code = runner.run_cell(root, workload, seed, seconds, True, device=device,
                                       patch=patch)
    finally:
        trace.load_events, trace.TraceSummary, runner.RunContext = (load_events, summary_class,
                                                                    context_class)
    ctx = kept.get("ctx")
    if ctx is not None:
        ctx.spans = ProgramSpans(COLLECTOR.events(), kept["events"], kept["tid"],
                                 kept["base_ns"])
        ctx.dropped_events = COLLECTOR.dropped
    return result, ctx, code


def _fit_summary(residuals):
    """Median, 99th percentile, largest and share within 20 us of the
    absolute residuals (us)."""
    residuals = sorted(abs(r) for r in residuals)
    return {"ends_paired": len(residuals), "median_us": residuals[len(residuals) // 2],
            "p99_us": residuals[int(len(residuals) * 0.99)], "max_us": residuals[-1],
            "within_20us_pct": 100.0 * sum(r <= 20.0 for r in residuals) / len(residuals)}


def readings(ctx):
    """What a traced run's program spans give: the readers' values, the
    clock fit (over all paired ends and by span name), and the spans by
    name."""
    spans = ctx.spans
    signed = [r for _, _, r in spans.residuals_us]
    fit = {"offset_us": spans.offset_us, "ends_paired": len(signed)}
    if signed:
        tenth = max(1, len(signed) // 10)
        by_name = defaultdict(list)
        for _, name, r in spans.residuals_us:
            by_name[name].append(r)
        fit.update(_fit_summary(signed),
                   drift_us=statistics.median(signed[-tenth:])
                   - statistics.median(signed[:tenth]),
                   by_name={name: _fit_summary(rs) for name, rs in sorted(by_name.items())})
    return {"metrics": {name: read(ctx) for name, read in READERS.items()},
            "units_per_s": ctx.units / ctx.window_s, "steps": ctx.steps, "fit": fit,
            "dropped_events": ctx.dropped_events,
            "spans": {name: {"s": spans.seconds[name], "self_s": spans.self_seconds[name],
                             "count": spans.counts[name]} for name in sorted(spans.seconds)},
            "device_ops": sorted(ctx.trace.device_ops.items(), key=lambda kv: -kv[1])[:12]}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m perfbench.spans", description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    result, ctx, code = traced_run(os.getcwd(), args.workload, args.seed, args.seconds)
    if result is None:
        return code
    print(json.dumps({"workload": args.workload, "seed": args.seed, "result": result,
                      "program_spans": readings(ctx)}), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
