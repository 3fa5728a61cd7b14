"""Overload-robust serving: deadlines, retry budgets, circuit breakers,
hedging and brownout (the port's own copy of
``petastorm_tpu/service/resilience.py``).

The pure pieces of the resilience layer: no sockets, and no clock unless
one is injected, so the same seeded sequence of events gives the same
decisions in both packages.

- **Deadline propagation**: a control RPC carries the caller's remaining
  budget as a relative ``deadline_left_s`` header field; the handler
  re-anchors it on its own monotonic clock and answers a retryable
  ``DEADLINE_EXCEEDED`` instead of starting work nobody waits for.
- :class:`RetryBudget`: a per-peer token bucket that retries spend and
  successes refill, so a failing peer gets a bounded retry rate.
- :class:`CircuitBreaker`: a consecutive-failure trip, a cooldown, one
  half-open probe and a symmetric close; time is an explicit ``now``.
- :class:`GapTracker`: the hedged re-serve trigger, a threshold fit from
  the observed inter-batch gaps in the registry's log-spaced buckets.
- :class:`BrownoutConfig` / :class:`BrownoutPlanner`: the dispatcher's
  degraded state machine under sustained overload; level 1 scales
  low-weight jobs' credit windows, level 2 also sheds optional stages
  (tracing spans, autotune probes). Every transition is a WAL op.

The dispatcher journals breaker-open exclusions and brownout transitions;
the client keeps per-peer breakers and budgets and hedges; the worker
gates stream requests on their deadline and hosts the ``slow-peer``
failpoint.
"""

from __future__ import annotations

import logging
import threading
import time

from petastorm_tpu_torch.telemetry.metrics import RESILIENCE_DEADLINE_EXCEEDED
from petastorm_tpu_torch.telemetry.registry import log_buckets

logger = logging.getLogger(__name__)

#: The wire field carrying the caller's REMAINING budget in seconds.
#: Relative, not absolute: monotonic clocks (and wall clocks, under NTP
#: steps) do not transfer across hosts, so the caller ships "how long I
#: will still wait" and the handler re-anchors it locally on arrival.
DEADLINE_FIELD = "deadline_left_s"


# -- deadline propagation ----------------------------------------------------

def attach_deadline(header, deadline, clock=time.monotonic):
    """Stamp the remaining budget onto an outbound header (in place).

    ``deadline`` is a LOCAL monotonic deadline (``None`` = no budget —
    the field is omitted and handlers apply no gate). Stamped per
    attempt, so a retry after backoff ships the smaller remaining
    budget, never the original one.
    """
    if deadline is not None:
        header[DEADLINE_FIELD] = max(0.0, round(deadline - clock(), 4))
    return header


def arrival_deadline(header, clock=time.monotonic):
    """The caller's budget as a LOCAL monotonic deadline, or ``None``
    when the request carries none (or an unparseable value — an old or
    foreign caller must not be refused over an optional field)."""
    left = header.get(DEADLINE_FIELD)
    if left is None:
        return None
    try:
        return clock() + max(0.0, float(left))
    except (TypeError, ValueError):
        return None


def deadline_expired(deadline, clock=time.monotonic):
    """``True`` when a (local monotonic) deadline has passed."""
    return deadline is not None and clock() >= deadline


def deadline_exceeded_reply(site, clock=time.monotonic):
    """The retryable error reply a handler returns instead of starting
    (or continuing) work the caller has stopped waiting for. Retryable:
    the CALLER's ``retry_with_backoff(deadline_s=)`` is the budget's
    source of truth — it re-attempts while its own budget lasts and
    raises the moment it is exhausted."""
    RESILIENCE_DEADLINE_EXCEEDED.labels(site).inc()
    return {"type": "error", "retryable": True,
            "error": (f"DEADLINE_EXCEEDED: {site}: the request's "
                      f"propagated budget expired before the work "
                      f"finished — refused so capacity goes to requests "
                      f"someone still waits for")}


# -- retry budget ------------------------------------------------------------

class RetryBudget:
    """Per-peer retry token bucket: retries SPEND, successes REFILL.

    Bounds the retry rate against a failing peer to
    ``refill_per_success`` retries per successful call (plus the initial
    ``capacity`` burst) — the standard antidote to retry storms: when a
    peer degrades, clients collectively stop multiplying its load.
    Thread-safe; arithmetic only, no clocks.
    """

    def __init__(self, capacity=10.0, refill_per_success=0.5,
                 initial=None):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self.capacity = float(capacity)
        self.refill_per_success = float(refill_per_success)
        self._balance = float(capacity if initial is None else initial)
        self._denied = 0
        self._lock = threading.Lock()

    @property
    def balance(self):
        with self._lock:
            return self._balance

    @property
    def denied(self):
        """Retries refused because the bucket was empty."""
        with self._lock:
            return self._denied

    def try_spend(self, cost=1.0):
        """Take ``cost`` tokens for one retry; ``False`` (and nothing
        taken) when the bucket cannot cover it."""
        with self._lock:
            if self._balance < cost:
                self._denied += 1
                return False
            self._balance -= cost
            return True

    def record_success(self):
        """A successful call refills a fraction of the bucket."""
        with self._lock:
            self._balance = min(self.capacity,
                                self._balance + self.refill_per_success)

    def snapshot(self):
        with self._lock:
            return {"capacity": self.capacity,
                    "balance": round(self._balance, 3),
                    "denied": self._denied}


# -- circuit breaker ---------------------------------------------------------

#: Breaker states, with the numeric codes the
#: ``petastorm_resilience_breaker_state`` gauge exports.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
BREAKER_STATE_CODES = {BREAKER_CLOSED: 0, BREAKER_OPEN: 1,
                       BREAKER_HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed → open → half-open).

    Pure and golden-testable: time enters ONLY as the explicit ``now``
    argument (any monotonic float), so canned-sequence tests drive the
    full state machine deterministically.

    - **closed**: calls allowed; ``threshold`` CONSECUTIVE failures trip
      it open (one success resets the streak — a flapping peer must
      actually fail in a row to trip).
    - **open**: calls refused (fail fast, route around) until
      ``cooldown_s`` has elapsed since the trip.
    - **half-open**: after the cooldown, exactly ONE probe call is
      allowed through; its success closes the breaker, its failure
      re-opens (and restarts the cooldown).
    """

    def __init__(self, threshold=5, cooldown_s=5.0):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = None
        self._probe_inflight = False
        self._lock = threading.Lock()

    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def state_code(self):
        return BREAKER_STATE_CODES[self.state]

    @property
    def consecutive_failures(self):
        with self._lock:
            return self._failures

    def allow(self, now):
        """Whether a call to the peer may proceed at ``now``. Moving an
        open breaker past its cooldown transitions to half-open and
        admits exactly one probe."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._state = BREAKER_HALF_OPEN
                self._probe_inflight = True
                return True
            # half-open: one probe at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_failure(self, now):
        """Count one failure; ``True`` exactly when this failure TRIPPED
        the breaker open (the caller's report/journal edge)."""
        with self._lock:
            if self._state == BREAKER_HALF_OPEN:
                # The probe failed: back to open, cooldown restarts.
                self._state = BREAKER_OPEN
                self._opened_at = now
                self._probe_inflight = False
                return False
            if self._state == BREAKER_OPEN:
                return False
            self._failures += 1
            if self._failures >= self.threshold:
                self._state = BREAKER_OPEN
                self._opened_at = now
                self._failures = 0
                return True
            return False

    def record_success(self, now=None):
        """A successful call: closes a half-open breaker, resets the
        failure streak of a closed one. (``now`` accepted for signature
        symmetry; the transition needs no clock.)"""
        del now
        with self._lock:
            self._state = BREAKER_CLOSED
            self._failures = 0
            self._opened_at = None
            self._probe_inflight = False

    def snapshot(self):
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._failures}


# -- hedged re-serve threshold ------------------------------------------------

class GapTracker:
    """Dynamic hedge threshold fit from observed inter-batch gaps.

    Counts every observed gap into the telemetry registry's log-spaced
    latency buckets (:func:`petastorm_tpu_torch.telemetry.registry.
    log_buckets`) and derives the hedge trigger as
    ``clamp(multiplier × quantile(q), floor_s, cap_s)``: a stream whose
    silence exceeds several times the fleet's own p99 gap is an outlier
    worth hedging, whatever that p99 happens to be — no magic latency
    constant that would misfire on both a fast local fleet and a slow
    remote one.

    Returns ``None`` (hedging disarmed) until ``min_samples`` gaps have
    been observed: an empty histogram has no p99 to fit.
    """

    def __init__(self, quantile=0.99, multiplier=4.0, min_samples=16,
                 floor_s=0.25, cap_s=30.0, buckets=None):
        if not 0.0 < quantile <= 1.0:
            raise ValueError("quantile must be in (0, 1]")
        if multiplier <= 0:
            raise ValueError("multiplier must be > 0")
        self.quantile = float(quantile)
        self.multiplier = float(multiplier)
        self.min_samples = int(min_samples)
        self.floor_s = float(floor_s)
        self.cap_s = float(cap_s)
        self._bounds = tuple(buckets) if buckets is not None \
            else log_buckets()
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, gap_s):
        gap_s = float(gap_s)
        with self._lock:
            for i, bound in enumerate(self._bounds):
                if gap_s <= bound:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    def threshold_s(self):
        """The current hedge trigger in seconds, or ``None`` while too
        few gaps have been observed to fit one."""
        with self._lock:
            total = self._count
            if total < self.min_samples:
                return None
            # Histogram-quantile estimate: linear interpolation inside
            # the bucket that crosses rank q×count (the registry
            # HistogramChild.quantile construction).
            rank = self.quantile * total
            seen = 0
            prev_bound = 0.0
            fitted = self._bounds[-1]
            for i, bound in enumerate(self._bounds):
                in_bucket = self._counts[i]
                if seen + in_bucket >= rank:
                    if in_bucket:
                        frac = (rank - seen) / in_bucket
                        fitted = prev_bound + frac * (bound - prev_bound)
                    else:
                        fitted = bound
                    break
                seen += in_bucket
                prev_bound = bound
        return min(max(fitted * self.multiplier, self.floor_s), self.cap_s)


# -- brownout ----------------------------------------------------------------

#: Brownout levels, in shed order. Level 1 sheds low-weight/sideband
#: jobs' credit windows (the fleet's credit scales, slice (d)); level 2
#: also sheds optional stages (tracing spans, autotune probes).
BROWNOUT_MAX_LEVEL = 2


class BrownoutConfig:
    """Knobs of the brownout state machine (windows are evaluation
    rounds — the dispatcher evaluates at most once per
    ``interval_s``).

    :param interval_s: minimum seconds between evaluations.
    :param enter_credit_wait_s: overload when the fleet's credit-wait
        accumulates faster than this many seconds per second (workers
        blocked on client flow control — consumers can't keep up).
    :param enter_ready_saturation: overload when any client reports its
        ready queue at or above this fullness fraction.
    :param exit_fraction: calm when BOTH signals sit below this fraction
        of their enter thresholds (a strictly lower bar, so the machine
        cannot flap on a signal hovering at the threshold).
    :param up_windows/down_windows: hysteresis streak lengths for
        entering/recovering one level.
    :param cooldown_windows: evaluation rounds after any transition in
        which neither streak accumulates.
    :param max_level: deepest shed level.
    """

    def __init__(self, interval_s=1.0, enter_credit_wait_s=0.5,
                 enter_ready_saturation=0.9, exit_fraction=0.5,
                 up_windows=3, down_windows=3, cooldown_windows=1,
                 max_level=BROWNOUT_MAX_LEVEL):
        if not 0.0 < exit_fraction < 1.0:
            raise ValueError("exit_fraction must be in (0, 1)")
        if max_level < 1:
            raise ValueError("max_level must be >= 1")
        self.interval_s = float(interval_s)
        self.enter_credit_wait_s = float(enter_credit_wait_s)
        self.enter_ready_saturation = float(enter_ready_saturation)
        self.exit_fraction = float(exit_fraction)
        self.up_windows = int(up_windows)
        self.down_windows = int(down_windows)
        self.cooldown_windows = int(cooldown_windows)
        self.max_level = int(max_level)

    @classmethod
    def coerce(cls, value):
        """``True``/dict/config → a :class:`BrownoutConfig`."""
        if isinstance(value, cls):
            return value
        if value is True:
            return cls()
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            f"brownout must be True, a dict of BrownoutConfig kwargs, or "
            f"a BrownoutConfig — got {value!r}")


class BrownoutPlanner:
    """Pure shed/recover planner over one overload-signals snapshot.

    ``plan(signals)`` consumes::

        {"level": int,                   # current (journaled) level
         "credit_wait_rate": float,      # fleet credit-wait s/s
         "ready_saturation": float}      # max client queue fullness 0..1

    and returns at most one transition,
    ``[{"action": "shed"|"recover", "level": new_level, "reason": str}]``
    — the dispatcher applies it through a journaled ``brownout`` WAL op. Stateful only in its
    hysteresis streaks; no clocks, no randomness — canned-signal goldens
    pin shed order, hysteresis, and symmetric recovery exactly.

    Hysteresis: ``up_windows`` consecutive overloaded rounds shed
    one level, ``down_windows`` consecutive calm rounds recover one, a
    round that is neither resets both streaks, and any transition starts
    a cooldown in which neither streak accumulates. Recovery requires
    BOTH signals below ``exit_fraction`` of their enter thresholds — a
    strictly lower bar than entry, so a signal hovering at the threshold
    cannot flap the level.
    """

    def __init__(self, config=None):
        self.config = config or BrownoutConfig()
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0

    def plan(self, signals):
        cfg = self.config
        level = int(signals.get("level", 0))
        wait_rate = float(signals.get("credit_wait_rate", 0.0))
        saturation = float(signals.get("ready_saturation", 0.0))
        if self._cooldown > 0:
            self._cooldown -= 1
            return []
        overloaded = (wait_rate >= cfg.enter_credit_wait_s
                      or saturation >= cfg.enter_ready_saturation)
        calm = (wait_rate < cfg.enter_credit_wait_s * cfg.exit_fraction
                and saturation < (cfg.enter_ready_saturation
                                  * cfg.exit_fraction))
        if overloaded and level < cfg.max_level:
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= cfg.up_windows:
                self._up_streak = 0
                self._cooldown = cfg.cooldown_windows
                return [{
                    "action": "shed", "level": level + 1,
                    "reason": (f"overload for {cfg.up_windows} windows "
                               f"(credit_wait {wait_rate:.2f}s/s, "
                               f"ready {saturation:.0%})")}]
        elif calm and level > 0:
            self._down_streak += 1
            self._up_streak = 0
            if self._down_streak >= cfg.down_windows:
                self._down_streak = 0
                self._cooldown = cfg.cooldown_windows
                return [{
                    "action": "recover", "level": level - 1,
                    "reason": (f"calm for {cfg.down_windows} windows "
                               f"(credit_wait {wait_rate:.2f}s/s, "
                               f"ready {saturation:.0%})")}]
        else:
            self._up_streak = 0
            self._down_streak = 0
        return []


# -- optional-stage shedding (brownout level 2) ------------------------------

#: Process-local view of the dispatcher's brownout level, updated by
#: clients/workers from reply fields. Read by the optional stages the
#: level-2 brownout sheds: batch-lifecycle trace spans and autotune
#: probes consult :func:`optional_stages_shed` before doing optional
#: work. A plain int behind a lock — the hot-path read is one attribute
#: load.
_BROWNOUT_LEVEL = 0
_BROWNOUT_LOCK = threading.Lock()
_SHED_TRACING = False  # we disabled the trace collector; restore on recovery


def note_brownout_level(level):
    """Record the dispatcher-reported brownout level (idempotent).

    Level 2 sheds the process's batch-lifecycle trace collector (span
    recording is pure overhead when the fleet is drowning); recovery
    below 2 restores it IF this function disabled it — an operator's own
    enable/disable outside a brownout is never overridden."""
    global _BROWNOUT_LEVEL, _SHED_TRACING
    level = int(level)
    with _BROWNOUT_LOCK:
        changed, _BROWNOUT_LEVEL = (_BROWNOUT_LEVEL != level), level
        if changed:
            from petastorm_tpu_torch.telemetry import tracing
            if level >= 2 and tracing.COLLECTOR.enabled:
                _SHED_TRACING = True
                tracing.COLLECTOR.enabled = False
            elif level < 2 and _SHED_TRACING:
                _SHED_TRACING = False
                tracing.COLLECTOR.enabled = True
    if changed:
        logger.warning("brownout level is now %d (%s)", level,
                       "optional stages shed" if level >= 2 else
                       "low-weight jobs' credits scaled" if level == 1
                       else "normal service")


def brownout_level():
    return _BROWNOUT_LEVEL


def optional_stages_shed():
    """Whether level-2 brownout is in force: optional stages (tracing
    spans, autotune probes) should skip their work this call."""
    return _BROWNOUT_LEVEL >= 2
