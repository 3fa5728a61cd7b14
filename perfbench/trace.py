"""Reductions of a ``torch.profiler`` Chrome trace to the numbers the
per-layer metrics read: the device's busy time (the union of kernels,
copies and memsets), the device time of the kernels launched inside a
named host op, the device operations that took the most time, and the
device's idle gaps by what the host was doing meanwhile.

Every interval is clipped to the benchmark's own window span, so set-up
and the reference never count.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "perfbench.window"


def load_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _interval(event):
    start = float(event["ts"])
    return start, start + float(event.get("dur", 0.0))


def window_bounds(events, span=WINDOW_SPAN):
    """``(start, end)`` in trace microseconds of the window span."""
    for event in events:
        if event.get("ph") == "X" and event.get("name") == span:
            return _interval(event)
    raise ValueError(f"the trace holds no {span!r} span")


def _clip(intervals, lo, hi):
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return sorted(out)


def union(intervals):
    """Merged, sorted, non-overlapping intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


class TraceSummary:
    """What the metric readers take from one trace (times in seconds)."""

    def __init__(self, events, host_ops=()):
        lo, hi = window_bounds(events)
        self.window_s = (hi - lo) * 1e-6
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self._busy = union(_clip([_interval(e) for e in device], lo, hi))
        self.busy_s = sum(e - s for s, e in self._busy) * 1e-6
        self.device_ops = defaultdict(float)
        for e in device:
            for s, t in _clip([_interval(e)], lo, hi):
                self.device_ops[e["name"]] += (t - s) * 1e-6
        self.op_device_s = {name: self._op_device_seconds(events, device, name, lo, hi)
                            for name in host_ops}
        self.idle_gaps, self.idle_under = self._idle_gaps(events, lo, hi)

    @staticmethod
    def _op_device_seconds(events, device, name, lo, hi):
        """Device seconds of the work launched inside host ops called
        ``name`` (on the op's own thread, any depth below it): the runtime
        calls inside each such op, and the device events that carry their
        correlation ids. None when the trace holds no such op."""
        ops = defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation") \
                    and e.get("name") == name:
                ops[(e.get("pid"), e.get("tid"))].append(_interval(e))
        if not ops:
            return None
        ops = {key: union(spans) for key, spans in ops.items()}
        starts = {key: [s for s, _ in spans] for key, spans in ops.items()}
        correlations = set()
        for e in events:
            if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            key = (e.get("pid"), e.get("tid"))
            if key not in ops:
                continue
            ts = float(e["ts"])
            i = bisect.bisect_right(starts[key], ts) - 1
            if i >= 0 and ts <= ops[key][i][1]:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    correlations.add(corr)
        total = 0.0
        for e in device:
            if e.get("args", {}).get("correlation") in correlations:
                for s, t in _clip([_interval(e)], lo, hi):
                    total += t - s
        return total * 1e-6

    def _idle_gaps(self, events, lo, hi):
        """Idle seconds of the device by the host spans (the benchmark's
        own, or the loader's) open on the window's thread when each gap
        began: ``(by innermost span, by every span open)``."""
        window = next(e for e in events
                      if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN)
        key = (window.get("pid"), window.get("tid"))
        marks = []  # (time, order, kind, name): ends sort before starts
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                    and (e.get("pid"), e.get("tid")) == key and e["name"] != WINDOW_SPAN:
                s, t = _interval(e)
                marks.append((s, 1, "open", e["name"]))
                marks.append((t, 0, "close", e["name"]))
        gaps, reach = [], lo
        for s, e in self._busy + [(hi, hi)]:
            if s > reach:
                gaps.append((reach, s))
                marks.append((reach, 2, "gap", len(gaps) - 1))
            reach = max(reach, e)
        by_name, under = defaultdict(float), defaultdict(float)
        stack = []
        for _, _, kind, name in sorted(marks, key=lambda m: (m[0], m[1])):
            if kind == "open":
                stack.append(name)
            elif kind == "close":
                if name in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(name)]
            else:
                s, e = gaps[name]
                by_name[stack[-1] if stack else "no host span"] += (e - s) * 1e-6
                for open_span in set(stack):
                    under[open_span] += (e - s) * 1e-6
        return by_name, under

    def breakdown(self, top=10):
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, secs] for name, secs in ops],
                "idle_gaps": [[name, secs] for name, secs in gaps]}
