"""Critical-path stall attribution over merged per-batch trace spans (the
port's own copy of ``petastorm_tpu/telemetry/critical_path.py``).

``input_stall_pct`` says the trainer waited; it never says on WHOM. This
module decomposes the measured wait: every ``loader.wait`` interval in a
(fleet-merged, clock-aligned) trace is swept against the spans active at
the same instants, and each elementary sub-interval is charged to the
**latest-started** active upstream span — the stage actually holding the
batch the consumer is about to receive. Latest-started is the truthful
head-of-line rule: while the consumer waits on batch X, the worker may
still be decoding X (same bid) or already decoding X+1 after a send that
was the real bottleneck — whichever stage most recently went active is
the one the wait is pinned behind. Wait time overlapping NO upstream
span is reported as unattributed residue (tracing gaps, untraced work),
so the coverage number is honest instead of silently renormalized.

The output is a ranked bottleneck report — per (stage, peer) self-times
as shares of the total wait — plus a per-stage profile (span counts,
total/mean durations) shaped for the dispatcher's journaled
``stage_profile`` records.

Pure functions over event lists: no clocks, no sockets, no service
imports — unit-testable with fabricated spans.
"""

from __future__ import annotations

#: The consumer-side wait stage the attribution decomposes.
WAIT_STAGE = "loader.wait"

#: Stages never charged for a wait: the wait itself, and the training
#: step (serial with the wait on the consumer thread — it cannot be what
#: the wait is pending on).
NON_CAUSAL_STAGES = frozenset({WAIT_STAGE, "loader.consumer"})


def pair_spans(events):
    """Chrome ``B``/``E`` event pairs → completed span dicts
    (``name``/``pid``/``tid``/``ts``/``dur``/``bid``). Unbalanced
    begins (still-open at export) are dropped — a half-span has no
    duration to attribute."""
    spans = []
    stacks = {}
    for event in sorted(events, key=lambda e: (e.get("ts", 0.0),
                                               e.get("ph") != "B")):
        ph = event.get("ph")
        if ph not in ("B", "E"):
            continue
        key = (event.get("pid"), event.get("tid"), event.get("name"))
        if ph == "B":
            stacks.setdefault(key, []).append(event)
            continue
        stack = stacks.get(key)
        if not stack:
            continue  # orphan end (begin rolled off the ring)
        begin = stack.pop()
        args = begin.get("args") or {}
        spans.append({"name": begin.get("name"),
                      "pid": begin.get("pid"), "tid": begin.get("tid"),
                      "ts": begin.get("ts", 0.0),
                      "dur": max(0.0, event.get("ts", 0.0)
                                 - begin.get("ts", 0.0)),
                      "bid": args.get("bid"), "args": args})
    return spans


def process_names(events):
    """pid → display name from Chrome ``M`` ``process_name`` metadata
    (the merge step stamps each peer's buffer with its id)."""
    names = {}
    for event in events:
        if event.get("ph") == "M" \
                and event.get("name") == "process_name":
            name = (event.get("args") or {}).get("name")
            if name:
                names[event.get("pid")] = str(name)
    return names


def _attribute_window(w0, w1, active, charges):
    """Charge the [w0, w1) window to the latest-started span among
    ``active`` at each instant, splitting at span starts/ends."""
    bounds = {w0, w1}
    for span in active:
        if w0 < span["ts"] < w1:
            bounds.add(span["ts"])
        end = span["ts"] + span["dur"]
        if w0 < end < w1:
            bounds.add(end)
    edges = sorted(bounds)
    unattributed = 0.0
    for seg0, seg1 in zip(edges, edges[1:]):
        mid = (seg0 + seg1) / 2.0
        holder = None
        for span in active:
            if span["ts"] <= mid < span["ts"] + span["dur"]:
                if holder is None or span["ts"] > holder["ts"]:
                    holder = span
        if holder is None:
            unattributed += seg1 - seg0
        else:
            key = (holder["name"], holder["pid"])
            charges[key] = charges.get(key, 0.0) + (seg1 - seg0)
    return unattributed


def attribute_stalls(events, wait_stage=WAIT_STAGE):
    """Sweep every ``wait_stage`` interval against concurrently-active
    upstream spans. Returns the raw attribution:
    ``{"wait_total_us", "attributed_us", "unattributed_us",
    "coverage_pct", "charges": {(stage, pid): us}, "pid_names"}``."""
    spans = pair_spans(events)
    waits = sorted((s for s in spans if s["name"] == wait_stage),
                   key=lambda s: s["ts"])
    upstream = sorted((s for s in spans
                       if s["name"] not in NON_CAUSAL_STAGES),
                      key=lambda s: s["ts"])
    charges = {}
    wait_total = unattributed = 0.0
    cursor = 0            # first upstream span not yet started at w0
    active = []           # spans overlapping the current window
    for wait in waits:
        w0, w1 = wait["ts"], wait["ts"] + wait["dur"]
        if wait["dur"] <= 0:
            continue
        wait_total += wait["dur"]
        while cursor < len(upstream) and upstream[cursor]["ts"] < w1:
            active.append(upstream[cursor])
            cursor += 1
        active = [s for s in active if s["ts"] + s["dur"] > w0]
        unattributed += _attribute_window(w0, w1, active, charges)
    covered = wait_total - unattributed
    return {
        "wait_total_us": wait_total,
        "attributed_us": covered,
        "unattributed_us": unattributed,
        "coverage_pct": (100.0 * covered / wait_total
                         if wait_total > 0 else None),
        "charges": charges,
        "pid_names": process_names(events),
    }


def stage_profile(events):
    """Per-stage span statistics over the WHOLE trace (not just stall
    windows): ``{stage: {"count", "total_us", "mean_us"}}`` — the
    journaled profile."""
    profile = {}
    for span in pair_spans(events):
        entry = profile.setdefault(span["name"],
                                   {"count": 0, "total_us": 0.0})
        entry["count"] += 1
        entry["total_us"] += span["dur"]
    for entry in profile.values():
        entry["mean_us"] = entry["total_us"] / entry["count"]
    return profile


def diagnose(events, measured_stall_pct=None, wait_stage=WAIT_STAGE):
    """The full bottleneck report: ranked (stage, peer) self-times as
    shares of the total consumer wait, the unattributed residue, the
    per-stage profile, and — when the caller supplies the bench's
    measured ``input_stall_pct`` — each bottleneck's decomposed share of
    it (``stall_pct`` per row sums to ≈ the measured number times
    coverage)."""
    attribution = attribute_stalls(events, wait_stage=wait_stage)
    names = attribution["pid_names"]
    wait_total = attribution["wait_total_us"]
    bottlenecks = []
    for (stage, pid), self_us in sorted(attribution["charges"].items(),
                                        key=lambda kv: -kv[1]):
        share = (100.0 * self_us / wait_total) if wait_total > 0 else 0.0
        row = {"stage": stage,
               "peer": names.get(pid, f"pid:{pid}"),
               "self_us": self_us, "share_pct": share}
        if measured_stall_pct is not None:
            row["stall_pct"] = measured_stall_pct * share / 100.0
        bottlenecks.append(row)
    return {
        "wait_total_us": wait_total,
        "attributed_us": attribution["attributed_us"],
        "unattributed_us": attribution["unattributed_us"],
        "coverage_pct": attribution["coverage_pct"],
        "measured_stall_pct": measured_stall_pct,
        "bottlenecks": bottlenecks,
        "stage_profile": stage_profile(events),
    }


def render(report):
    """The human rendering of :func:`diagnose` — ranked table plus the
    coverage line ``diagnose`` prints without ``--json``."""
    lines = []
    wait_ms = report["wait_total_us"] / 1000.0
    coverage = report["coverage_pct"]
    header = f"consumer wait: {wait_ms:.1f} ms"
    if coverage is not None:
        header += f", {coverage:.1f}% attributed"
    if report.get("measured_stall_pct") is not None:
        header += (f" (measured input_stall_pct="
                   f"{report['measured_stall_pct']:.1f})")
    lines.append(header)
    lines.append(f"{'STAGE':<24} {'PEER':<20} {'SELF_MS':>10} "
                 f"{'SHARE%':>8}" + (f" {'STALL%':>8}"
                                     if report.get("measured_stall_pct")
                                     is not None else ""))
    for row in report["bottlenecks"]:
        line = (f"{row['stage']:<24} {row['peer']:<20} "
                f"{row['self_us'] / 1000.0:>10.1f} "
                f"{row['share_pct']:>8.1f}")
        if "stall_pct" in row:
            line += f" {row['stall_pct']:>8.1f}"
        lines.append(line)
    residue = report["unattributed_us"] / 1000.0
    if residue > 0:
        lines.append(f"{'(unattributed)':<24} {'-':<20} "
                     f"{residue:>10.1f} "
                     f"{100.0 - (coverage or 0.0):>8.1f}")
    return "\n".join(lines)
