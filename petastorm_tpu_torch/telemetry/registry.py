"""Process-wide metrics registry: counters, gauges, log-bucket histograms
(the port's own copy of ``petastorm_tpu/telemetry/registry.py``).

Producers (the reader's pools and ventilator, the loader's stage timings,
the decoded-batch cache) declare typed, named, label-aware metric families
here (:mod:`petastorm_tpu_torch.telemetry.metrics`), so the same numbers are

- readable in-process (the ``diagnostics`` dicts are derived from the same
  metric objects),
- scrapeable (Prometheus text exposition,
  :mod:`petastorm_tpu_torch.telemetry.http`), the JAX package's text line
  for line for equal registries,
- and rate-able (a :class:`SnapshotRing` of periodic snapshots gives
  ``rate()``-style deltas without an external time-series store).

An increment is one small-lock acquire and a float add, with no allocation
once the child is interned; everything is standard library and
thread-safe. The process-default registry is :data:`REGISTRY`.
"""

from __future__ import annotations

import math
import threading
import time


def log_buckets(lo=1e-5, hi=100.0, factor=4.0):
    """Fixed logarithmically-spaced bucket bounds: ``lo * factor**k`` up to
    (and including the first bound >=) ``hi``. The histogram default covers
    10 microseconds to ~2 minutes in 13 buckets — wide enough for decode
    times and stall waits alike, cheap enough to expose per label set."""
    bounds = []
    edge = lo
    while edge < hi:
        bounds.append(edge)
        edge *= factor
    bounds.append(edge)
    return tuple(bounds)


DEFAULT_TIME_BUCKETS = log_buckets()


class _Child:
    """One (family, label-values) time series. Interned per label set by the
    family, so producers hold a reference and pay no dict lookup per update."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    @property
    def value(self):
        with self._lock:
            return self._value


class CounterChild(_Child):
    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount


class GaugeChild(_Child):
    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        with self._lock:
            self._value -= amount


class HistogramChild:
    """Fixed-bucket histogram series: per-bucket counts + sum + count."""

    __slots__ = ("_lock", "_bounds", "_counts", "sum", "count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        with self._lock:
            # Linear scan: bucket lists are ~13 long and observations are
            # per-batch (hundreds/s), not per-row — bisect would save
            # nothing measurable and cost a function call.
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self.sum += value
            self.count += 1

    def bucket_counts(self):
        """Per-bucket (non-cumulative) counts, +Inf last."""
        with self._lock:
            return list(self._counts)

    def quantile(self, q):
        """Approximate quantile by linear interpolation inside the bucket
        that crosses rank ``q * count`` (the same estimate Prometheus's
        ``histogram_quantile`` computes server-side). ``None`` when empty."""
        with self._lock:
            total = self.count
            if total == 0:
                return None
            rank = q * total
            seen = 0
            prev_bound = 0.0
            for i, bound in enumerate(self._bounds):
                in_bucket = self._counts[i]
                if seen + in_bucket >= rank:
                    if in_bucket == 0:
                        return bound
                    frac = (rank - seen) / in_bucket
                    return prev_bound + frac * (bound - prev_bound)
                seen += in_bucket
                prev_bound = bound
            return self._bounds[-1]  # rank fell in the +Inf bucket


_CHILD_TYPES = {"counter": CounterChild, "gauge": GaugeChild}


class MetricFamily:
    """A named metric with a fixed label schema; ``labels()`` interns one
    child per label-value tuple."""

    def __init__(self, name, help_text, kind, label_names=(), buckets=None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = tuple(label_names)
        self.buckets = (tuple(buckets) if buckets is not None
                        else DEFAULT_TIME_BUCKETS) if kind == "histogram" \
            else None
        self._lock = threading.Lock()
        self._children = {}

    def labels(self, *values, **kv):
        """The child for these label values (positional, in declared order,
        or by keyword). Label values are coerced to str — a worker_id or a
        stage name, never unbounded per-row data."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by keyword, "
                                 "not both")
            try:
                values = tuple(kv[name] for name in self.label_names)
            except KeyError as exc:
                raise ValueError(
                    f"{self.name} labels are {self.label_names}") from exc
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "histogram":
                    child = HistogramChild(self._lock, self.buckets)
                else:
                    child = _CHILD_TYPES[self.kind](self._lock)
                self._children[key] = child
            return child

    def remove(self, *values):
        """Drop the series for these label values (e.g. a finalized
        per-instance label) — the series vanishes from exposition and
        snapshots, exactly like a restarted Prometheus target."""
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(key, None)

    # Unlabeled convenience: family.inc()/set()/observe() act on the
    # zero-label child.
    def inc(self, amount=1.0):
        self.labels().inc(amount)

    def set(self, value):
        self.labels().set(value)

    def dec(self, amount=1.0):
        self.labels().dec(amount)

    def observe(self, value):
        self.labels().observe(value)

    @property
    def value(self):
        return self.labels().value

    def children(self):
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """A set of metric families; declaration is idempotent (re-declaring the
    same name with the same type/labels returns the existing family — the
    pattern of module-level declarations surviving re-imports)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    def _declare(self, name, help_text, kind, label_names, buckets=None):
        with self._lock:
            family = self._families.get(name)
            if family is not None:
                if family.kind != kind \
                        or family.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as a "
                        f"{family.kind} with labels {family.label_names}")
                return family
            family = MetricFamily(name, help_text, kind, label_names,
                                  buckets)
            self._families[name] = family
            return family

    def counter(self, name, help_text, labels=()):
        return self._declare(name, help_text, "counter", labels)

    def gauge(self, name, help_text, labels=()):
        return self._declare(name, help_text, "gauge", labels)

    def histogram(self, name, help_text, labels=(), buckets=None):
        return self._declare(name, help_text, "histogram", labels, buckets)

    def families(self):
        """Name → family, sorted by name (stable exposition order)."""
        with self._lock:
            return dict(sorted(self._families.items()))

    def snapshot(self):
        """Point-in-time value of every series, JSON-shaped::

            {family_name: {"type": ..., "help": ..., "series": [
                {"labels": {...}, "value": x}                    # counter/gauge
                {"labels": {...}, "sum": s, "count": n,
                 "buckets": [[le, cumulative_count], ...]}       # histogram
            ]}}
        """
        out = {}
        for name, family in self.families().items():
            series = []
            for key, child in sorted(family.children().items()):
                labels = dict(zip(family.label_names, key))
                if family.kind == "histogram":
                    counts = child.bucket_counts()
                    cumulative, buckets = 0, []
                    for bound, n in zip(family.buckets, counts):
                        cumulative += n
                        buckets.append([bound, cumulative])
                    buckets.append(["+Inf", cumulative + counts[-1]])
                    series.append({"labels": labels, "sum": child.sum,
                                   "count": child.count, "buckets": buckets})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": family.kind, "help": family.help,
                         "series": series}
        return out


# -- Prometheus text exposition ---------------------------------------------

def _escape_help(text):
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value):
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(value):
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _format_labels(label_names, key, extra=()):
    parts = [f'{name}="{_escape_label_value(value)}"'
             for name, value in sorted(zip(label_names, key))]
    parts.extend(f'{name}="{value}"' for name, value in extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def expose_prometheus(registry):
    """The registry in Prometheus text exposition format (version 0.0.4):
    ``# HELP`` / ``# TYPE`` per family (emitted even for families with no
    series yet, so a scrape enumerates the full vocabulary), label values
    escaped, label names sorted, histogram buckets cumulative with a
    ``+Inf`` terminal plus ``_sum``/``_count``."""
    lines = []
    for name, family in registry.families().items():
        lines.append(f"# HELP {name} {_escape_help(family.help)}")
        lines.append(f"# TYPE {name} {family.kind}")
        for key, child in sorted(family.children().items()):
            if family.kind == "histogram":
                cumulative = 0
                counts = child.bucket_counts()
                for bound, n in zip(family.buckets, counts):
                    cumulative += n
                    labels = _format_labels(
                        family.label_names, key,
                        extra=[("le", _format_value(bound))])
                    lines.append(f"{name}_bucket{labels} {cumulative}")
                labels = _format_labels(family.label_names, key,
                                        extra=[("le", "+Inf")])
                lines.append(f"{name}_bucket{labels} "
                             f"{cumulative + counts[-1]}")
                base = _format_labels(family.label_names, key)
                lines.append(f"{name}_sum{base} "
                             f"{_format_value(child.sum)}")
                lines.append(f"{name}_count{base} {child.count}")
            else:
                labels = _format_labels(family.label_names, key)
                lines.append(f"{name}{labels} "
                             f"{_format_value(child.value)}")
    return "\n".join(lines) + "\n"


# -- rate()-style deltas ------------------------------------------------------

class SnapshotRing:
    """Bounded ring of periodic registry snapshots — in-process ``rate()``.

    A scraping Prometheus computes rates server-side; a bare trainer has
    no time-series store, so the ring keeps
    the last ``capacity`` snapshots taken every ``interval_s`` on a daemon
    thread and :meth:`rate` answers "per-second delta over the last N
    seconds" from the two snapshots straddling the window."""

    def __init__(self, registry, interval_s=5.0, capacity=120):
        self._registry = registry
        self.interval_s = interval_s
        self._capacity = capacity
        self._snaps = []          # [(monotonic_t, snapshot), ...]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self.take()  # t0 baseline, so rates are available after one tick
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-snapshot-ring")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.take()

    def take(self):
        snap = (time.monotonic(), self._registry.snapshot())
        with self._lock:
            self._snaps.append(snap)
            if len(self._snaps) > self._capacity:
                self._snaps.pop(0)

    def snapshots(self):
        with self._lock:
            return list(self._snaps)

    @staticmethod
    def _series_value(snapshot, name, labels):
        family = snapshot.get(name)
        if family is None:
            return None  # family unknown to this snapshot's registry
        want = {k: str(v) for k, v in (labels or {}).items()}
        # A declared family with no matching series yet is 0, not None: a
        # counter that first appears mid-window must rate from zero.
        total = 0.0
        for series in family["series"]:
            if all(series["labels"].get(k) == v for k, v in want.items()):
                total += series.get("value", series.get("sum", 0.0))
        return total

    def rate(self, name, labels=None, window_s=None):
        """Per-second delta of a counter (or histogram sum) over the last
        ``window_s`` seconds (default: the full ring). Series matching
        ``labels`` (a subset filter) are summed before differencing.
        ``None`` when fewer than two snapshots cover the series."""
        snaps = self.snapshots()
        if len(snaps) < 2:
            return None
        t1, newest = snaps[-1]
        t0, oldest = snaps[0]
        if window_s is not None:
            for t, snap in snaps[:-1]:
                if t1 - t <= window_s:
                    t0, oldest = t, snap
                    break
        if t1 <= t0:
            return None
        new = self._series_value(newest, name, labels)
        old = self._series_value(oldest, name, labels)
        if new is None or old is None:
            return None
        # Counters only move up within one process lifetime; a NEGATIVE
        # delta means the producer restarted and its counter reset to
        # zero mid-window. Clamp instead of reporting a negative rate —
        # the restart window's rate is unknowable, and 0 is the honest
        # floor.
        return max(0.0, new - old) / (t1 - t0)


#: The process-default registry every family in
#: :mod:`petastorm_tpu_torch.telemetry.metrics` registers into.
REGISTRY = MetricsRegistry()
