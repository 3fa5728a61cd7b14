"""Graph-rewrite catalog and pure trigger economics (the port's own copy
of ``petastorm_tpu/pipeline/rewrites.py``).

The autotuner's action space beyond knob nudges: structural changes to the
pipeline topology, applied through the same plan → probe →
revert-on-regression → journal machinery as every knob, with a longer
``rewrite_hysteresis`` and trigger predicates gating each rewrite on the
measured economics that make it worth probing. A rewrite whose trigger
does not fire is skipped (the planner falls through to the class's knob
levers), so knob-only workloads never pay a wasted probe.

The port's local loader binds no rewrite knob yet: all four act on the
data service's streams, which are not ported. The catalog and the
triggers are here whole because the planner gates on them, and so that
both packages' planners decide alike on the same profiles.

Everything here is a pure function of the window profile.
"""

from __future__ import annotations

#: The rewrite catalog: every kind the planner may apply, its graph knob,
#: and the knob value that means "rewrite in force" (the other value is
#: the baseline topology.
REWRITE_KINDS = {
    "fuse_worker_stages": {
        "knob": "stage_fusion",
        "applied_value": "fused",
        "description": (
            "Collapse the worker-side collate→transform(→pack)→serialize "
            "chain into the decode pool task (one fused task per piece): "
            "per-output hand-off cost disappears and serialization "
            "parallelizes across pool workers. Byte-identical output."),
    },
    "hoist_filter": {
        "knob": "filter_placement",
        "applied_value": "worker",
        "description": (
            "Move the declared row filter (and column projection) from "
            "trainer-side batch masking to the workers' two-phase "
            "predicate read BELOW decode: dropped rows never decode, "
            "never serialize, never cross the wire."),
    },
    "cache_placement": {
        "knob": "cache_placement",
        "applied_value": "post-decode",
        "description": (
            "Choose the worker batch cache's insertion point relative to "
            "the batch transform: post-transform (warm serves are "
            "zero-work) vs post-decode (entries hold smaller/shareable "
            "pre-transform bytes; warm serves re-apply the transform)."),
    },
    "row_vs_columnar": {
        "knob": "reader_family",
        "applied_value": "columnar",
        "description": (
            "Serve the stream through the columnar reader family: codec "
            "decode runs as vectorized per-column kernels over whole "
            "Arrow batches instead of per-row Python materialization "
            "(no to_pylist on the hot path). Decoded bytes are "
            "identical; exotic codecs/readers fall back to the row "
            "path per piece, still byte-identical."),
    },
}

#: Trigger thresholds (override via ``autotune={'rewrite_thresholds':
#: {...}}``). Semantics per trigger below.
DEFAULT_THRESHOLDS = {
    # fuse: the stream-thread work fusion would move into the pool task
    # (collation + serialization hand-off, plus the batch transform when
    # it runs worker-side) must be at least this fraction of the measured
    # decode cost (the tf.data fused-map economics: fusing only pays when
    # the single serving thread's serial work is a visible share of the
    # parallelizable work).
    "fuse_overhead_frac": 0.15,
    # hoist: the client-side filter must be dropping at least this
    # fraction of decoded rows (below it, the saved decode does not cover
    # the risk of a probe round).
    "hoist_min_drop_frac": 0.25,
    # cache → post-decode: only when the transform is CHEAP to re-apply —
    # its window cost at most this fraction of worker decode cost — and
    # the cache shows eviction pressure (entry bytes are the constraint).
    "cache_cheap_transform_frac": 0.25,
    # cache → post-transform: only when warm serving dominates (hit rate
    # at least cache_min_hit_rate) and re-applying the transform per
    # serve costs at least this fraction of the window wall.
    "cache_hot_transform_frac": 0.20,
    "cache_min_hit_rate": 0.5,
    # row→columnar: worker decode must dominate the window wall — the
    # vectorized kernels only move the needle when per-row decode IS the
    # bottleneck (a transport- or consumer-bound stream gains nothing and
    # pays a cache re-fill, since the two families key entries apart).
    "columnar_min_decode_frac": 0.30,
}


def _get(profile, key):
    value = profile.get(key)
    return float(value) if value else 0.0


def rewrite_triggered(kind, want, profile, thresholds=None):
    """Does the window's measured profile justify probing this rewrite?

    Returns ``(triggered, reason)`` — ``reason`` is the journal string
    explaining the economics (empty when not triggered). Pure: reads only
    the profile dict and thresholds.
    """
    t = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        t.update(thresholds)
    if kind == "fuse_worker_stages":
        handoff = _get(profile, "handoff_s")
        movable = handoff
        if profile.get("knobs", {}).get("transform_placement", "remote") \
                == "remote":
            # A worker-side transform runs on the same single serving
            # thread the hand-off work does — fusion moves it into the
            # pool task too (parallel across pool workers).
            movable += _get(profile, "transform_s")
        decode = _get(profile, "worker_decode_s")
        if handoff > 0 and movable >= t["fuse_overhead_frac"] * max(
                decode, 1e-9):
            return True, (f"serving-thread work {movable:.3f}s (handoff "
                          f"{handoff:.3f}s) >= "
                          f"{t['fuse_overhead_frac']:.0%} of decode "
                          f"{decode:.3f}s")
        return False, ""
    if kind == "hoist_filter":
        rows_in = _get(profile, "filter_rows_in")
        kept = _get(profile, "filter_rows_kept")
        if rows_in > 0:
            drop_frac = 1.0 - kept / rows_in
            if drop_frac >= t["hoist_min_drop_frac"]:
                return True, (f"client filter drops {drop_frac:.0%} of "
                              f"decoded rows")
        return False, ""
    if kind == "cache_placement":
        hits = _get(profile, "cache_hits")
        misses = _get(profile, "cache_misses")
        lookups = hits + misses
        transform_s = _get(profile, "transform_s")
        if want == "post-decode":
            evictions = _get(profile, "cache_evictions")
            decode_s = _get(profile, "worker_decode_s")
            if lookups > 0 and evictions > 0 \
                    and transform_s <= t["cache_cheap_transform_frac"] \
                    * max(decode_s, 1e-9):
                return True, (f"eviction pressure ({evictions:.0f} in "
                              f"window) with cheap transform "
                              f"({transform_s:.3f}s vs decode "
                              f"{decode_s:.3f}s): pre-transform entries "
                              f"admit more")
            return False, ""
        # want == "post-transform": warm serving pays the transform per
        # serve — move the cache above it once that cost is visible.
        wall = _get(profile, "wall_s")
        if lookups > 0 and wall > 0:
            hit_rate = hits / lookups
            if hit_rate >= t["cache_min_hit_rate"] \
                    and transform_s >= t["cache_hot_transform_frac"] * wall:
                return True, (f"warm serves (hit rate {hit_rate:.0%}) "
                              f"re-pay the transform "
                              f"({transform_s:.3f}s of {wall:.3f}s wall)")
        return False, ""
    if kind == "row_vs_columnar":
        decode_s = _get(profile, "worker_decode_s")
        wall = _get(profile, "wall_s")
        if decode_s > 0 and wall > 0 \
                and decode_s >= t["columnar_min_decode_frac"] * wall:
            return True, (f"worker decode {decode_s:.3f}s is "
                          f"{decode_s / wall:.0%} of the {wall:.3f}s "
                          f"window: vectorized columnar kernels replace "
                          f"per-row decode")
        return False, ""
    raise ValueError(f"unknown rewrite kind {kind!r}")


def rewrite_kind_for_knob(knob_name):
    """The catalog kind a knob belongs to, or ``None``."""
    for kind, info in REWRITE_KINDS.items():
        if info["knob"] == knob_name:
            return kind
    return None
