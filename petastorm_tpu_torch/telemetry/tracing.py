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
"""

from __future__ import annotations

import json
import os
import threading
import time

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
