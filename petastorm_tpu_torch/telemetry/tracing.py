"""Per-batch pipeline spans as Chrome ``trace_event`` JSON (the port's own
copy of ``petastorm_tpu/telemetry/tracing.py``).

Each stage of the loader records a span (a begin/end event pair) into the
process-wide :data:`COLLECTOR`; :meth:`TraceCollector.export` writes them
as JSON that Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``
loads. Collection is off by default and costs one attribute read per call
site when off. ``make_torch_dataloader(trace_path=...)`` arms it for each
iteration and writes the file at its end; the module functions
(:func:`enable`, :func:`disable`, :func:`record_span`, :func:`export`,
:func:`wall_us`) act on :data:`COLLECTOR` directly.

:func:`span` is the program's one span call: it records into
:data:`COLLECTOR` when that is armed, on any thread, and enters
``torch.profiler.record_function("petastorm_tpu_torch.<name>")`` when a
torch profiler records the calling thread (the profiler records only the
thread that entered it, so spans on the reader's and the loader's own
threads reach only :data:`COLLECTOR`). :func:`fit_profiler_clock` measures
the offset between the two sinks' clocks from the spans that reached both.
The module imports without torch: the service's worker-side modules use it.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import threading
import time

from petastorm_tpu_torch.telemetry.critical_path import pair_spans

#: Bounded event buffer: at ~10 spans per batch, 200k events cover ~10k
#: batches while a forgotten trace flag costs ~50 MB, not the heap.
DEFAULT_MAX_EVENTS = 200_000


class TraceCollector:
    """Process-wide span sink. ``enabled`` is a plain bool read without the
    lock: call sites check it before taking timestamps."""

    def __init__(self, max_events=DEFAULT_MAX_EVENTS):
        self.enabled = False
        self._max_events = max_events
        self._lock = threading.Lock()
        self._events = []
        self._dropped = 0
        self._armers = 0  # acquire/release refcount
        # ts is in microseconds: perf_counter for durations, anchored to the
        # wall clock so traces of several processes share an axis.
        self._epoch = time.time() - time.perf_counter()

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        """Off, whoever armed it (the armers' count restarts at zero)."""
        self.enabled = False
        with self._lock:
            self._armers = 0

    def clear(self):
        with self._lock:
            self._events = []
            self._dropped = 0

    def acquire(self):
        """Scoped arming: the first armer clears the buffer, later armers
        (a second trace-armed loader) join the running trace, and
        collection stays on until the last one calls :meth:`release`."""
        with self._lock:
            self._armers += 1
            if self._armers == 1:
                self._events = []
                self._dropped = 0
        self.enabled = True
        return self

    def release(self):
        with self._lock:
            self._armers = max(0, self._armers - 1)
            if self._armers == 0:
                self.enabled = False

    def _ts_us(self, t):
        return (self._epoch + t) * 1e6

    def ts_us(self, t):
        """A ``time.perf_counter()`` reading in the trace timebase
        (wall-anchored microseconds), the unit of every event's ``ts``."""
        return self._ts_us(t)

    def now_us(self):
        """The current instant in the trace timebase."""
        return self._ts_us(time.perf_counter())

    def record_span(self, name, t_start, t_end, bid=None, args=None, tid=None):
        """One completed span as a B/E event pair; ``t_start``/``t_end``
        are ``time.perf_counter()`` readings, ``bid`` lands in
        ``args.bid``."""
        if not self.enabled:
            return
        span_args = dict(args or {})
        if bid is not None:
            span_args["bid"] = bid
        pid = os.getpid()
        tid = tid if tid is not None else threading.get_ident() % 1_000_000
        begin = {"name": name, "cat": "petastorm", "ph": "B", "ts": self._ts_us(t_start),
                 "pid": pid, "tid": tid, "args": span_args}
        end = {"name": name, "cat": "petastorm", "ph": "E", "ts": self._ts_us(t_end),
               "pid": pid, "tid": tid}
        with self._lock:
            if len(self._events) + 2 > self._max_events:
                self._dropped += 2
                return
            self._events.append(begin)
            self._events.append(end)

    def instant(self, name, t, bid=None, args=None):
        """A zero-duration marker (``ph: i``) at ``time.perf_counter()``
        reading ``t``."""
        if not self.enabled:
            return
        event_args = dict(args or {})
        if bid is not None:
            event_args["bid"] = bid
        event = {"name": name, "cat": "petastorm", "ph": "i", "s": "t",
                 "ts": self._ts_us(t), "pid": os.getpid(),
                 "tid": threading.get_ident() % 1_000_000, "args": event_args}
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(event)

    def events(self):
        with self._lock:
            return list(self._events)

    def ship(self):
        """Take and clear the buffered events with their drop count: an
        armed peer pushes its ring to the dispatcher on each heartbeat tick
        and records on into an empty buffer, so no event ships twice."""
        with self._lock:
            events, self._events = self._events, []
            dropped, self._dropped = self._dropped, 0
        return events, dropped

    @property
    def dropped(self):
        """Events refused since the buffer was last cleared (it was full)."""
        with self._lock:
            return self._dropped

    def export(self, path):
        """Write the buffered events as trace JSON; returns their count."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"producer": "petastorm_tpu_torch.telemetry",
                             "dropped_events": dropped}}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(events)


#: The process-default collector every loader records into.
COLLECTOR = TraceCollector()


def enable():
    return COLLECTOR.enable()


def disable():
    COLLECTOR.disable()


def record_span(name, t_start, t_end, bid=None, args=None):
    COLLECTOR.record_span(name, t_start, t_end, bid=bid, args=args)


def export(path):
    return COLLECTOR.export(path)


def wall_us():
    """The process's current wall-anchored trace timestamp (µs): what the
    flight recorder stamps its events with, so the rings of several
    processes share the traces' axis."""
    return COLLECTOR.now_us()


#: What a span's name is prefixed with in a torch profiler's trace.
PROFILER_PREFIX = "petastorm_tpu_torch."


class _Off:
    """The span of a call with both sinks off: no timestamp, no torch call."""

    __slots__ = ()
    armed = False
    args = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def discard(self):
        pass


_OFF = _Off()


class _Span:
    """A span bound for :data:`COLLECTOR` (``armed``), a profiler range, or
    both. The COLLECTOR's clock is read right after the range enters and
    right after it exits: the profiler stamps the range's start early in
    its enter and its end late in its exit, so both ends of the span then
    trail the range's by about the same few microseconds."""

    __slots__ = ("name", "args", "_collector", "_range", "_t0")

    def __init__(self, name, args, collector, profiler):
        self.name = name
        self.args = args if collector is not None else None
        self._collector = collector
        self._range = (profiler.record_function(PROFILER_PREFIX + name)
                       if profiler is not None else None)

    @property
    def armed(self):
        """Whether the span goes to :data:`COLLECTOR`: build args only then."""
        return self._collector is not None

    def discard(self):
        """Record nothing into :data:`COLLECTOR` (the profiler's range
        stays): for a stage that found its stream's end."""
        self._collector = None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._collector is not None:
            self._collector.record_span(self.name, self._t0, time.perf_counter(),
                                        args=self.args)
        return False


def _profiler():
    """``torch.autograd.profiler`` when a torch profiler records the calling
    thread, else None. Without torch imported no profiler runs; the module
    flag is set while any thread profiles, and the thread-local check is
    made only then."""
    module = sys.modules.get("torch.autograd.profiler")
    if module is None or not getattr(module, "_is_profiler_enabled", True):
        return None
    return module if sys.modules["torch"].autograd._profiler_enabled() else None


def span(name, **args):
    """Context manager: one span of ``name`` (``args`` land in the
    COLLECTOR event's ``args``). It records into :data:`COLLECTOR` when
    armed and enters ``record_function(PROFILER_PREFIX + name)`` when a
    profiler records the calling thread; with both off it does nothing.
    The span it returns has ``armed`` (build costly args only then, into
    ``span.args``) and ``discard()``."""
    collector = COLLECTOR if COLLECTOR.enabled else None
    profiler = _profiler()
    if collector is None and profiler is None:
        return _OFF
    return _Span(name, args, collector, profiler)


def fit_profiler_clock(events, profiler_events, tid, base_time_ns=0):
    """``(offset_us, residuals)``: the offset that puts :data:`COLLECTOR`'s
    timestamps on a torch profiler's Chrome trace clock (``trace ts =
    collector ts + offset``), and each paired end's ``(trace ts, span name,
    residual µs)`` after it.

    The fit pairs the spans that reached both sinks: COLLECTOR B/E pairs
    on thread ``tid`` (its ``threading.get_ident() % 1_000_000``) and the
    trace's ``PROFILER_PREFIX``-named host ranges (``user_annotation``; a
    CUDA trace also projects each range onto the device's timeline as a
    ``gpu_user_annotation``, which is not the host's clock) of the same
    names, whose ``ts`` ``base_time_ns`` (the trace's
    ``baseTimeNanoseconds``) makes absolute.
    Both clocks are the wall clock's reading at an anchor plus the
    monotonic time since, so they differ by far less than the gap between
    two spans of one name on one thread: each range is paired with the
    span whose start is nearest after a first fit at zero, then again
    after the median offset. None and ``[]`` when no span pairs."""
    spans = {}
    for s in pair_spans(e for e in events if e.get("tid") == tid):
        spans.setdefault(s["name"], []).append((s["ts"], s["ts"] + s["dur"]))
    base_us = base_time_ns / 1e3
    ranges = []
    for e in profiler_events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and name.startswith(PROFILER_PREFIX) and name[len(PROFILER_PREFIX):] in spans:
            start = float(e["ts"]) + base_us
            ranges.append((name[len(PROFILER_PREFIX):], start, start + float(e.get("dur", 0.0))))
    for name in spans:
        spans[name].sort()
    offset = 0.0
    for _ in range(2):
        diffs = []
        for name, start, end in ranges:
            starts = [s for s, _ in spans[name]]
            i = bisect.bisect_left(starts, start - offset)
            near = min((j for j in (i - 1, i) if 0 <= j < len(starts)),
                       key=lambda j: abs(starts[j] + offset - start))
            s, t = spans[name][near]
            diffs += [(start, name, start - s), (end, name, end - t)]
        if not diffs:
            return None, []
        offset = statistics.median(d for _, _, d in diffs)
    return offset, [(ts - base_us, name, d - offset) for ts, name, d in diffs]
