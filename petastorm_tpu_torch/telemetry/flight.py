"""Crash-safe flight recorder: the last N structured events, always on (the
port's own copy of ``petastorm_tpu/telemetry/flight.py``).

Every process keeps a small bounded ring of recent structured events
(lifecycle decisions, worker exceptions a pool forwarded) and dumps it to
disk when something goes wrong:

- the caller dumps explicitly (an invariant it checks failed);
- an unhandled exception on any thread (a chained
  ``threading.excepthook``, armed by :func:`install`);
- ``SIGUSR2`` (a snapshot of a live, wedged process).

Every entry is stamped with the process's wall-anchored trace timestamp
(``tracing.wall_us()``), so dumps of several processes of one incident sort
on one axis. The ring records unconditionally; a ``note`` costs one lock
and a dict, at control-path rates, never per row.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading

from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.metrics import FLIGHT_DUMPS, FLIGHT_EVENTS

#: Ring capacity: ~2k control-path events cover minutes of activity
#: while keeping a dump small enough to attach to a report.
DEFAULT_CAPACITY = 2048

#: Dump directory override; default is the system temp dir.
DUMP_DIR_ENV = "PETASTORM_FLIGHT_DIR"


class FlightRecorder:
    """Bounded in-memory event ring with on-demand disk dumps."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._events = []
        self._seq = 0  # total notes ever (dump shows how much rolled off)
        self._context = {}
        self._dumps = 0

    def set_context(self, **fields):
        """Merge correlation fields (role, worker id, ...) into the
        recorder's context: stamped on every later dump, and the join keys
        of one incident's dumps across processes. ``None`` removes a
        key."""
        with self._lock:
            for key, value in fields.items():
                if value is None:
                    self._context.pop(key, None)
                else:
                    self._context[key] = value

    def note(self, event, **fields):
        """Append one structured event to the ring (always on)."""
        entry = {"t_us": tracing.wall_us(), "event": str(event)}
        entry.update(fields)
        with self._lock:
            self._seq += 1
            self._events.append(entry)
            if len(self._events) > self._capacity:
                self._events.pop(0)
        FLIGHT_EVENTS.inc()

    def snapshot(self):
        with self._lock:
            return list(self._events)

    def dump(self, reason, path=None):
        """Write the ring (plus context) to ``path`` — default
        ``$PETASTORM_FLIGHT_DIR`` or the temp dir, named by pid+reason so
        concurrent processes of one incident never clobber each other.
        Returns the path, or ``None`` if even the dump write failed (a
        recorder must never raise out of a crash path)."""
        with self._lock:
            events = list(self._events)
            context = dict(self._context)
            seq = self._seq
            self._dumps += 1
        doc = {"reason": str(reason), "pid": os.getpid(),
               "context": context, "total_events": seq,
               "events": events}
        if path is None:
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in str(reason))[:60]
            directory = os.environ.get(DUMP_DIR_ENV) \
                or tempfile.gettempdir()
            path = os.path.join(
                directory, f"flight-{os.getpid()}-{safe}.json")
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, default=repr)
        except OSError:
            FLIGHT_DUMPS.labels("write_failed").inc()
            return None
        FLIGHT_DUMPS.labels(str(reason).split(":", 1)[0][:40] or
                            "unspecified").inc()
        return path


#: The process-default recorder every component notes into.
RECORDER = FlightRecorder()

_installed = False
_prev_excepthook = None


def _thread_excepthook(hook_args):
    """Chained ``threading.excepthook``: an unhandled exception on ANY
    thread dumps the ring (the crash's own postmortem), then defers to
    the previously-installed hook (default: traceback to stderr)."""
    exc_type = getattr(hook_args, "exc_type", None)
    name = getattr(getattr(hook_args, "thread", None), "name", "?")
    RECORDER.note("unhandled_thread_exception", thread=name,
                  error=(exc_type.__name__ if exc_type else "?"))
    RECORDER.dump(f"thread-crash:{name}")
    if _prev_excepthook is not None:
        _prev_excepthook(hook_args)


def _sigusr2_handler(signum, frame):
    path = RECORDER.dump("sigusr2")
    print(f"flight recorder dump: {path}", file=sys.stderr, flush=True)


def install(capture_signals=True):
    """Arm the crash hooks: chain ``threading.excepthook`` and (from the
    main thread, when asked) a ``SIGUSR2`` dump handler. Idempotent;
    signal installation failures (non-main thread, restricted env) are
    tolerated — the excepthook and explicit dumps still work."""
    global _installed, _prev_excepthook
    if _installed:
        return RECORDER
    _prev_excepthook = threading.excepthook
    threading.excepthook = _thread_excepthook
    if capture_signals:
        try:
            signal.signal(signal.SIGUSR2, _sigusr2_handler)
        except (ValueError, OSError, AttributeError):
            pass  # non-main thread / no SIGUSR2 on this platform
    _installed = True
    return RECORDER
