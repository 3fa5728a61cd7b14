"""Profile-driven online autotuner for the pipeline stage graph (the
port's own copy of ``petastorm_tpu/pipeline/autotune.py``).

Two layers, split so the decision logic is a pure function of its inputs:

- :class:`Planner`: ``plan(profile) -> [decision]``. A profile is one
  measurement window (a plain dict: per-stage seconds, graph signals,
  current knob values). The planner classifies the bottleneck,
  hill-climbs ONE knob at a time toward it (geometric steps: double going
  up, halve going down), and evaluates every change it made against the
  next window's throughput: a probe that regressed throughput beyond
  tolerance is reverted and the knob settled. Hysteresis: a bottleneck
  class must persist ``hysteresis`` consecutive windows before the first
  probe, and a reverted (or neutral-settled) knob is not probed again
  until the bottleneck class changes, so two adjacent values can never
  oscillate.

- :class:`AutotuneController`: the online loop, a thread that windows
  consecutive :meth:`PipelineGraph.snapshot` s into profiles, feeds the
  planner, applies its decisions through the graph's knob bindings
  (clamped to declared bounds at apply time, again), and journals every
  decision to telemetry (``petastorm_autotune_decisions_total``, current
  values as ``petastorm_autotune_knob_value`` gauges) and an in-memory
  ``trail``.

Both decide as the JAX package's do on the same profiles. The planner
skips a probe while the data service's level-2 brownout is in force
(:func:`petastorm_tpu_torch.service.resilience.optional_stages_shed`): a
probe perturbs a knob to measure, and measurement is optional work a
drowning fleet sheds.

Disabled is the default everywhere: a loader without ``autotune=`` builds
no graph and starts no thread.
"""

from __future__ import annotations

import itertools
import threading
import time

from petastorm_tpu_torch.pipeline.rewrites import (
    REWRITE_KINDS,
    rewrite_triggered,
)
from petastorm_tpu_torch.telemetry.metrics import (
    AUTOTUNE_DECISIONS,
    AUTOTUNE_KNOB_VALUE,
    AUTOTUNE_ROUNDS,
    REWRITE_ACTIVE,
    REWRITE_DECISIONS,
)

#: Bottleneck classes → the ordered knob candidates that attack them.
#: (``transform_placement``/``packing_placement`` entries carry the
#: placement the class wants: worker-bound pipelines shed the movable
#: stage to the trainer, consumer-bound ones push it back to the
#: workers. Absent knobs — no transform armed, no packing wrapper — are
#: skipped, so each class falls through to its next lever.)
#:
#: Rewrite knobs (``stage_fusion`` / ``filter_placement`` /
#: ``cache_placement`` / ``reader_family`` — ``pipeline/rewrites.py``)
#: come FIRST in the
#: classes whose wall they attack structurally: they change the topology
#: instead of rebalancing around it, so when their trigger economics fire
#: they are the primary lever. Untriggered rewrites are skipped outright
#: (the class falls through to its capacity knobs — knob-only workloads
#: never pay a rewrite probe).
_CLASS_KNOBS = {
    "decode-bound": ("filter_placement:worker", "reader_family:columnar",
                     "stage_fusion:fused", "cache_placement:post-decode",
                     "workers_count", "host_prefetch"),
    "dispatch-bound": ("device_prefetch", "host_prefetch"),
    "credit-bound": ("credits", "ready_queue_depth"),
    "worker-bound": ("filter_placement:worker", "reader_family:columnar",
                     "stage_fusion:fused", "cache_placement:post-decode",
                     "transform_placement:local",
                     "packing_placement:trainer", "credits"),
    "consumer-bound": ("transform_placement:remote",
                       "packing_placement:worker",
                       "cache_placement:post-transform"),
    "balanced": (),
    "idle": (),
}

#: Upward-first classes: raising the knob is the natural first move.
#: (Every class here starts its hill-climb upward; a bad default that is
#: too HIGH — e.g. 10 decode threads on one core — is found by the
#: probe-evaluate-revert loop flipping the trend after the first
#: regressing probe.)


def classify(profile, stall_ok_pct=5.0, queue_hot_pct=25.0,
             credit_hot_pct=25.0, recv_hot_pct=50.0, min_wall_s=0.05):
    """Name the pipeline's bottleneck for one measurement window.

    Pure: reads only the profile dict. Classes:

    - ``idle`` — window too short or nothing moved; never tune on it.
    - ``balanced`` — consumer stall within ``stall_ok_pct``; leave the
      knobs alone (the no-op a converged pipeline settles into).
    - ``consumer-bound`` — stall low but the pipeline is visibly backed
      up behind the trainer: the producer spends ``queue_hot_pct`` of
      the wall blocked on a full queue, or (service path, where the
      direct drain has no producer thread and ``queue_wait_s`` is
      structurally 0) workers spend ``credit_hot_pct`` of the wall
      blocked on credit replenishment while the consumer never stalls.
    - ``credit-bound`` — consumer stalls while workers measurably wait
      on credit replenishment: the flow-control window is the limit.
    - ``worker-bound`` — consumer stalls and the client's stream
      readers spend most of the wall blocked on workers (service path).
    - ``decode-bound`` / ``dispatch-bound`` — consumer stalls on the
      local pipeline; whichever of decode vs device-dispatch cost
      dominates names the class.
    """
    wall = profile.get("wall_s") or 0.0
    rows = profile.get("rows") or 0
    if wall < min_wall_s or rows <= 0:
        return "idle"
    stall_pct = 100.0 * (profile.get("stall_s") or 0.0) / wall
    queue_pct = 100.0 * (profile.get("queue_wait_s") or 0.0) / wall
    credit_pct = 100.0 * (profile.get("credit_wait_s") or 0.0) / wall
    if stall_pct < stall_ok_pct:
        if queue_pct > queue_hot_pct or credit_pct > credit_hot_pct:
            return "consumer-bound"
        return "balanced"
    credit_wait = profile.get("credit_wait_s")
    if credit_wait is not None \
            and 100.0 * credit_wait / wall > credit_hot_pct:
        return "credit-bound"
    recv_stall = profile.get("recv_stall_s")
    if recv_stall is not None and 100.0 * recv_stall / wall > recv_hot_pct:
        return "worker-bound"
    decode = profile.get("decode_s") or 0.0
    dispatch = profile.get("dispatch_s") or 0.0
    return "decode-bound" if decode >= dispatch else "dispatch-bound"


class Planner:
    """Pure hill-climbing planner with hysteresis and probe evaluation.

    :param knobs: ``{name: descriptor}`` — the graph's
        :meth:`Knob.descriptor` dicts (bounds, kind, choices).
    :param hysteresis: consecutive windows a bottleneck class must
        persist before the first probe of a knob (placement flips wait
        ``placement_hysteresis``).
    :param tolerance: relative throughput change treated as noise when
        evaluating a probe: improvements above it keep climbing,
        regressions below it revert + settle, anything between keeps
        the value but settles the knob.
    :param probe_defer: non-idle windows to WAIT before evaluating a
        probe of a knob whose change is not live (``applies`` of
        ``next-stream``/``next-iteration`` — credits, transform
        placement): judging those one window later would measure a
        window the change had not landed in yet, settling or reverting
        on pure noise while the real effect arrives unevaluated. This
        counts *windows*, not landings: size it so
        ``interval_s × probe_defer`` covers the boundary the change
        waits for (for placement flips, an epoch) — with epochs much
        longer than that product the evaluation may still precede the
        landing and judge the knob neutral, leaving the landed change
        unevaluated until the bottleneck class next moves.
    :param classify_kwargs: threshold overrides for :func:`classify`.
    """

    def __init__(self, knobs, hysteresis=2, placement_hysteresis=4,
                 tolerance=0.05, probe_defer=3, classify_kwargs=None,
                 rewrite_hysteresis=6, rewrites=True,
                 rewrite_thresholds=None):
        self.knobs = dict(knobs)
        self.hysteresis = max(1, int(hysteresis))
        self.placement_hysteresis = max(self.hysteresis,
                                        int(placement_hysteresis))
        #: Rewrites change the topology, not a buffer depth: they wait out
        #: the LONGEST hysteresis before the first probe (and their
        #: trigger economics must hold through it).
        self.rewrite_hysteresis = max(self.placement_hysteresis,
                                      int(rewrite_hysteresis))
        #: ``rewrites=False`` = knob-only planning: every rewrite candidate
        #: is skipped as if untriggered.
        self.rewrites_enabled = bool(rewrites)
        self.rewrite_thresholds = dict(rewrite_thresholds or {})
        self.tolerance = float(tolerance)
        self.probe_defer = max(0, int(probe_defer))
        self._classify_kwargs = dict(classify_kwargs or {})
        self._round = 0
        self._streak = 0
        self._last_class = None
        #: name -> {"trend": +1|-1, "settled": bool}
        self._state = {name: {"trend": +1, "settled": False}
                       for name in self.knobs}
        #: outstanding probe: {"knob", "prev", "baseline_rows_s"} or None
        self._probe = None
        self.last_outcome = None
        self.last_class = None

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _throughput(profile):
        wall = profile.get("wall_s") or 0.0
        return (profile.get("rows") or 0) / wall if wall > 0 else 0.0

    def _decision(self, knob, direction, prev, target, reason):
        out = {"round": self._round, "knob": knob, "direction": direction,
               "from": prev, "to": target, "reason": reason,
               "applies": self.knobs[knob].get("applies", "live")}
        rewrite = self.knobs[knob].get("rewrite")
        if rewrite:
            out["rewrite"] = rewrite
        return out

    def _next_value(self, name, current):
        """The next hill-climb step for an int knob: geometric (double up,
        halve down), clamped; flips the trend at a bound; ``None`` when
        both directions are exhausted (the knob settles)."""
        desc = self.knobs[name]
        lo, hi = desc["lo"], desc["hi"]
        state = self._state[name]
        for _ in range(2):
            trend = state["trend"]
            target = min(hi, max(current * 2, current + 1)) if trend > 0 \
                else max(lo, current // 2)
            if target != current:
                return target
            state["trend"] = -trend  # at this bound: try the other way
        return None

    # -- the planning step -------------------------------------------------

    def plan(self, profile):
        """One planning round over one measurement window.

        Returns a (possibly empty) list of decision dicts with explicit
        target values; mutates only planner-internal state. Sets
        ``last_outcome`` to ``applied``/``reverted``/``noop``/``idle``
        and ``last_class`` to the window's bottleneck class.
        """
        self._round += 1
        cls = classify(profile, **self._classify_kwargs)
        self.last_class = cls
        decisions = []

        # 1. Evaluate the outstanding probe. Probes of non-live knobs
        # (credits apply to the NEXT streams, placement to the NEXT
        # iteration) hold for `probe_defer` informative windows first —
        # evaluating the window right after the decision would measure
        # one the change had not landed in. While a probe is pending,
        # nothing else is probed (single-probe invariant).
        if self._probe is not None and cls != "idle" \
                and self._probe["wait"] > 0:
            self._probe["wait"] -= 1
            self.last_outcome = "noop"
            self.last_class = cls
            return decisions
        if self._probe is not None and cls != "idle":
            probe, self._probe = self._probe, None
            name = probe["knob"]
            state = self._state[name]
            ratio = ((self._throughput(profile) / probe["baseline_rows_s"])
                     if probe["baseline_rows_s"] > 0 else 1.0)
            current = profile["knobs"].get(name)
            if ratio < 1.0 - self.tolerance:
                # Regression: roll back and flip the climb direction;
                # settled until the bottleneck class changes, so two
                # adjacent values cannot ping-pong.
                state["trend"] = -state["trend"]
                state["settled"] = True
                direction = ("flip" if self.knobs[name]["kind"] == "choice"
                             else "revert")
                if self.knobs[name].get("rewrite"):
                    # Rewrite rollbacks are journaled as reverts — the
                    # topology returned to baseline, not "another flip".
                    direction = "revert"
                decisions.append(self._decision(
                    name, direction, current, probe["prev"],
                    f"probe regressed throughput {ratio:.2f}x"))
                self.last_outcome = "reverted"
                return decisions
            if ratio <= 1.0 + self.tolerance:
                # Neutral: keep the value, stop probing this knob — the
                # knob does not matter at this operating point.
                state["settled"] = True
            # Improvement: keep climbing the same knob on later rounds.

        # 2. Hysteresis bookkeeping on the bottleneck class. Idle windows
        # carry no information (nothing moved, or the window was too
        # short — e.g. an epoch-boundary gap): they must not reset the
        # class streak or re-open settled knobs, or every blip would
        # restart the probe cycle from scratch.
        if cls == "idle":
            self.last_outcome = "idle"
            return decisions
        if cls != self._last_class:
            self._last_class = cls
            self._streak = 1
            # A new bottleneck re-opens the knobs that attack it.
            for entry in _CLASS_KNOBS.get(cls, ()):
                self._state.get(entry.split(":")[0], {})["settled"] = False
        else:
            self._streak += 1

        if cls == "balanced":
            self.last_outcome = "noop"
            return decisions
        if self._streak < self.hysteresis:
            self.last_outcome = "noop"
            return decisions

        # 3. Probe the first un-settled candidate knob for this class, unless
        # a level-2 brownout is in force (an outstanding probe's evaluation
        # above still completes).
        from petastorm_tpu_torch.service.resilience import optional_stages_shed
        if optional_stages_shed():
            self.last_outcome = "noop"
            return decisions
        for entry in _CLASS_KNOBS.get(cls, ()):
            name, _, want = entry.partition(":")
            desc = self.knobs.get(name)
            if desc is None or self._state[name]["settled"]:
                continue
            current = profile["knobs"].get(name)
            if current is None:
                continue
            rewrite = desc.get("rewrite")
            if desc["kind"] == "choice":
                if current == want:
                    continue
                if rewrite is not None:
                    # Graph rewrite: gated on its trigger economics. An
                    # untriggered (or disabled) rewrite falls through to
                    # the class's next lever — no wasted probe; a
                    # TRIGGERED one is the primary lever and holds the
                    # class until its (longest) hysteresis matures.
                    if not self.rewrites_enabled:
                        continue
                    triggered, why = rewrite_triggered(
                        rewrite, want, profile,
                        self.rewrite_thresholds)
                    if not triggered:
                        continue
                    if self._streak < self.rewrite_hysteresis:
                        self.last_outcome = "noop"
                        return decisions
                    decisions.append(self._decision(
                        name, "flip", current, want, f"{cls}: {why}"))
                    self._probe = {
                        "knob": name, "prev": current,
                        "baseline_rows_s": self._throughput(profile),
                        "wait": (0 if desc.get("applies",
                                               "live") == "live"
                                 else self.probe_defer)}
                    self.last_outcome = "applied"
                    return decisions
                if self._streak < self.placement_hysteresis:
                    # A placement flip is pending but its (longer)
                    # hysteresis has not matured: HOLD rather than fall
                    # through to a secondary knob — placement is the
                    # class's primary lever, and probing around it first
                    # would poison the flip's baseline.
                    self.last_outcome = "noop"
                    return decisions
                decisions.append(self._decision(
                    name, "flip", current, want, cls))
            else:
                target = self._next_value(name, current)
                if target is None:
                    self._state[name]["settled"] = True
                    continue
                decisions.append(self._decision(
                    name, "up" if target > current else "down", current,
                    target, cls))
            self._probe = {"knob": name, "prev": current,
                           "baseline_rows_s": self._throughput(profile),
                           "wait": (0 if desc.get("applies",
                                                  "live") == "live"
                                    else self.probe_defer)}
            self.last_outcome = "applied"
            return decisions
        self.last_outcome = "noop"
        return decisions


_CONTROLLER_IDS = itertools.count()


def _release_controller_gauges(controller_id, knob_names):
    """weakref.finalize callback: retire a dead controller's gauge
    series (the decision/round counters are process-cumulative journal
    counters and stay — Prometheus-idiomatic for counters)."""
    for name in knob_names:
        AUTOTUNE_KNOB_VALUE.remove(controller_id, name)
    for kind in REWRITE_KINDS:
        REWRITE_ACTIVE.remove(controller_id, kind)

#: Controller thread-name prefix: the JAX package's ``pipeline-autotune``
#: extended as the port's worker threads extend theirs, so a watch for
#: orphaned controllers of either package matches it.
CONTROLLER_THREAD_PREFIX = "pipeline-autotune-torch"


class AutotuneController:
    """The online re-planning loop over a :class:`PipelineGraph`.

    Periodically windows the graph's cumulative snapshots into profiles,
    runs the planner, applies decisions through the knob bindings
    (re-clamped to their declared bounds — no knob ever leaves its
    range), and journals everything: telemetry counters/gauges plus the
    in-memory ``trail`` (one entry per round that decided or reverted
    something, newest last, bounded). A round that raises is logged
    ("autotune round failed", through ``telemetry/log.py``) and the loop
    goes on: tuning must never kill the pipeline.

    :param graph: the :class:`PipelineGraph` to tune.
    :param interval_s: seconds between planning rounds.
    :param planner: a :class:`Planner` (default: one built from the
        graph's knob descriptors).
    :param max_trail: trail entries kept (oldest dropped).
    """

    def __init__(self, graph, interval_s=0.5, planner=None, max_trail=512):
        self.graph = graph
        self.interval_s = float(interval_s)
        self.planner = planner or Planner(
            {name: knob.descriptor()
             for name, knob in graph.knobs.items()})
        self.trail = []
        self._max_trail = int(max_trail)
        self._rounds = 0
        self._noop_streak = 0
        self._stop = threading.Event()
        self._thread = None
        self._prev = None        # (perf_counter, cumulative snapshot)
        self._lock = threading.Lock()
        self._id = str(next(_CONTROLLER_IDS))
        for name, knob in graph.knobs.items():
            AUTOTUNE_KNOB_VALUE.labels(self._id, name).set(
                _gauge_value(knob.get()))
        # The gauge is per-controller (two autotuned loaders must not
        # clobber each other); retire this controller's series when it
        # is garbage-collected so registry cardinality tracks live
        # controllers — the same contract as the loader's own series.
        import weakref

        self._gauge_finalizer = weakref.finalize(
            self, _release_controller_gauges, self._id,
            tuple(graph.knobs))
        self._gauge_finalizer.atexit = False

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        old = self._thread
        if old is not None and old.is_alive():
            if not self._stop.is_set():
                return self  # genuinely running
            # stop() was called but the thread has not observed it yet
            # (it observes within one interval tick). Clearing the flag
            # under it would race its exit check — leaving NO controller
            # running while start() reports success — so wait the tick
            # out and spawn fresh.
            old.join(timeout=max(5.0, 2 * self.interval_s))
            if old.is_alive():  # stuck inside a long step: let it
                self._stop.clear()  # resume looping instead of dying
                return self
        self._stop.clear()
        self._prev = (time.perf_counter(), self.graph.snapshot())
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"{CONTROLLER_THREAD_PREFIX}-{self._id}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def join(self, timeout=5.0):
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # tuning must never kill the pipeline
                from petastorm_tpu_torch.telemetry.log import service_logger

                service_logger("petastorm_tpu_torch.pipeline.autotune").warning(
                    "autotune round failed", exc_info=True)

    # -- one round (callable directly in tests) ----------------------------

    def window_profile(self):
        """Window the graph's cumulative snapshot against the previous
        round's — the delta profile the planner consumes."""
        now = time.perf_counter()
        cur = self.graph.snapshot()
        prev_t, prev = self._prev if self._prev is not None else (now, cur)
        self._prev = (now, cur)
        profile = {"wall_s": max(0.0, now - prev_t),
                   "knobs": dict(cur["knobs"])}
        for name in ("rows", "stall_s", "queue_wait_s", "decode_s",
                     "dispatch_s", "consumer_s", "recv_stall_s",
                     "credit_wait_s", "worker_decode_s", "handoff_s",
                     "transform_s", "cache_hits", "cache_misses",
                     "cache_evictions", "filter_rows_in",
                     "filter_rows_kept"):
            cur_v = cur["signals"].get(name)
            if cur_v is None:
                continue
            prev_v = prev["signals"].get(name) or 0.0
            profile[name] = max(0.0, cur_v - prev_v)
        profile["stages"] = {
            name: {"count": info["count"]
                   - prev["stages"].get(name, {}).get("count", 0),
                   "seconds": info["seconds"]
                   - prev["stages"].get(name, {}).get("seconds", 0.0),
                   "placement": info["placement"]}
            for name, info in cur["stages"].items()}
        return profile

    def step(self):
        """One planning round: window → plan → apply → journal."""
        profile = self.window_profile()
        decisions = self.planner.plan(profile)
        with self._lock:
            self._rounds += 1
            applied = []
            for decision in decisions:
                knob = self.graph.knobs.get(decision["knob"])
                if knob is None:
                    continue
                target = knob.clamp(decision["to"])
                knob.set(target)
                decision = dict(decision, to=target)
                AUTOTUNE_DECISIONS.labels(decision["knob"],
                                          decision["direction"]).inc()
                AUTOTUNE_KNOB_VALUE.labels(self._id, decision["knob"]).set(
                    _gauge_value(target))
                rewrite = decision.get("rewrite")
                if rewrite:
                    # Rewrites journal twice: in the shared autotune
                    # counter above AND in the rewrite-specific family
                    # (with an in-force gauge), so "what topology is this
                    # pipeline running" is one scrape away.
                    REWRITE_DECISIONS.labels(
                        rewrite, decision["direction"]).inc()
                    REWRITE_ACTIVE.labels(self._id, rewrite).set(
                        1.0 if target
                        == REWRITE_KINDS[rewrite]["applied_value"]
                        else 0.0)
                applied.append(decision)
            outcome = self.planner.last_outcome or "noop"
            AUTOTUNE_ROUNDS.labels(outcome).inc()
            self._noop_streak = (0 if applied
                                 else self._noop_streak + 1)
            if applied or not self.trail \
                    or self.trail[-1]["outcome"] not in ("noop", "idle"):
                self.trail.append({
                    "round": self._rounds,
                    "outcome": outcome,
                    "bottleneck": self.planner.last_class,
                    "throughput_rows_s": round(
                        Planner._throughput(profile), 1),
                    "decisions": applied,
                })
                del self.trail[:-self._max_trail]
        return applied

    # -- audit surface -----------------------------------------------------

    @property
    def rounds(self):
        return self._rounds

    @property
    def noop_streak(self):
        """Consecutive trailing rounds that changed nothing — the
        convergence signal."""
        return self._noop_streak

    def knob_values(self):
        return {name: knob.get() for name, knob in self.graph.knobs.items()}

    def report(self):
        """Knob values in force, convergence state, and the full decision
        trail (plain data)."""
        with self._lock:
            return {
                "rounds": self._rounds,
                "noop_streak": self._noop_streak,
                "knobs": self.knob_values(),
                "trail": [dict(entry) for entry in self.trail],
            }


def _gauge_value(value):
    """Knob value → gauge float. Placement knobs render 0 = the service
    side, 1 = the trainer host (transform: remote/local; packing:
    worker/trainer; filter: worker/client). Rewrite topology knobs render
    0 = baseline, 1 = rewrite in force (stage_fusion: off/fused;
    cache_placement: post-transform/post-decode; reader_family:
    row/columnar)."""
    if value in ("remote", "worker", "off", "post-transform", "row"):
        return 0.0
    if value in ("local", "trainer", "client", "fused", "post-decode",
                 "columnar"):
        return 1.0
    try:
        return float(value)
    except (TypeError, ValueError):
        return 0.0
