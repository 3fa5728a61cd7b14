"""Chaos-schedule fuzzer: seeded failpoint soaks + reproducer shrinking.

The port's own copy of ``petastorm_tpu/service/fuzz.py``: the same runs,
geometry and shrinker over the port's loopback service scenario, and a
reproducer that replays through the port's CLI.

The failpoint substrate (:mod:`petastorm_tpu_torch.failpoints`) makes every fault
schedule a pure function of a seed — which turns robustness testing from a
flaky soak into a **fuzzer**: run the loopback service under K seeded
schedules, assert the delivery invariants (zero lost rows, zero duplicate
rows) and digest-determinism (two runs of one seed produce byte-identical
stream digests and identical injection logs) per seed, and when a seed
fails, SHRINK the schedule — re-run with subsets of the failpoint
vocabulary until only the points needed to reproduce the failure remain —
then print a one-line reproducer::

    python -m petastorm_tpu_torch.benchmark scenario service \\
        --chaos failpoints --chaos-seed 17   # points: transport.send

``fuzz()`` takes an injectable ``run_fn(seed, points)`` so the shrinker is
unit-testable without sockets; the default runner is the real loopback
service scenario, sized small (the soak is slow-marked in tier-1's terms —
each seed is a full service epoch under fire). Each seed runs on a
dedicated ``failpoint-fuzz-*`` thread with a hard join timeout, so one
hung run fails its seed instead of hanging the whole soak (the tests'
conftest leak guard tracks the thread prefix).
"""

from __future__ import annotations

import threading

from petastorm_tpu_torch.telemetry.log import service_logger

logger = service_logger(__name__)

#: Thread-name prefix for per-seed runs — tracked by the tests' resource
#: leak guard (a surviving fuzz thread means a hung, never-joined run).
FUZZ_THREAD_PREFIX = "failpoint-fuzz"

#: Hard per-seed wall budget: a run that neither finishes nor raises
#: inside it counts as a failure ("hung") and the soak moves on.
DEFAULT_RUN_TIMEOUT_S = 120.0


class FuzzFailure(AssertionError):
    """A seed's run violated an invariant (or hung). Carries the shrunk,
    seed-stamped reproducer in ``.report``."""

    def __init__(self, message, report):
        super().__init__(message)
        self.report = report


def default_run_fn(seed, points):
    """One loopback service epoch under the seeded failpoint schedule,
    restricted to ``points`` (``None`` = the full vocabulary). Raises on
    any delivery-invariant violation (the scenario's own contract) and
    returns the scenario result dict. Sized small: the soak multiplies
    this by ``2 × len(seeds)``."""
    from petastorm_tpu_torch.benchmark.scenarios import service_loopback_scenario

    return service_loopback_scenario(
        rows=1536, days=8, workers=2, batch_size=64,
        chaos="failpoints", chaos_seed=seed, failpoint_points=points,
        # Narrow fire window, sized against the run's actual call counts.
        # With the data plane on the shm tier (the loopback default) the
        # TCP points see only control traffic — credits, piece reports,
        # dispatcher RPCs — the shm points count one check per ring-sent
        # batch, and the resilience points (``slow-peer``) one check per
        # worker batch send — so the geometry must yield enough batches
        # (24 here, the per-batch points' whole call budget) and control
        # round-trips (>24) that seeded indices in [4, 24) actually land;
        # a run whose counts never reach its indices fires nothing and
        # trips the scenario's fired-nothing guard.
        failpoint_window=24,
        # Fleet cache tier armed with a deterministic mid-stream drain:
        # this is what puts the ``cache-peer-gone`` (peer fetch/push/serve
        # paths) and ``handoff-torn`` (drain handoff shipping) points on
        # exercised code paths — without it their call counts stay at
        # zero and their fire windows are unreachable. Digest stays the
        # seeded contract: remote-warm, local-warm and cold fills serve
        # byte-identical batches, and the drain happens at a fixed
        # consumed-batch position, not a timer.
        cache="mem", fleet_cache=True, fleet_cache_drain_after=12,
        shuffle_seed=seed, ordered=True)


def hedged_run_fn(seed, points):
    """:func:`default_run_fn` with the resilience layer ARMED: hedged
    watermark re-serves on (threshold fitted from a short epoch, so the
    quantile is the median and the floor sits below the injected
    ``slow-peer`` stalls), breakers and retry budgets live on the client
    by default. The hedged soak's contract is strictly stronger than the
    plain one: hedges may launch, win, or lose differently run-to-run
    (they race wall-clock timing), yet the digest must stay byte-identical
    — exactly-once delivery is watermark-deduped, not schedule-lucky."""
    from petastorm_tpu_torch.benchmark.scenarios import service_loopback_scenario

    return service_loopback_scenario(
        rows=1536, days=8, workers=2, batch_size=64,
        chaos="failpoints", chaos_seed=seed, failpoint_points=points,
        failpoint_window=24,
        # Stretch the generic delay action past the hedge floor so the
        # injected stalls are hedgeable, not just observable.
        failpoint_delay_s=0.3,
        hedging=True, hedge_floor_s=0.2, hedge_min_samples=6,
        hedge_quantile=0.5,
        shuffle_seed=seed, ordered=True)


def _run_guarded(run_fn, seed, points, timeout_s):
    """Run one seed on a named, join-bounded thread. Returns
    ``(result, error)`` — ``error`` is the exception repr, or a "hung"
    marker when the join timed out (the daemon thread is abandoned)."""
    box = {}

    def target():
        try:
            box["result"] = run_fn(seed, points)
        except BaseException as exc:  # noqa: BLE001 — the soak must go on
            box["error"] = f"{type(exc).__name__}: {exc}"

    thread = threading.Thread(
        target=target, daemon=True,
        name=f"{FUZZ_THREAD_PREFIX}-{seed}")
    thread.start()
    thread.join(timeout=timeout_s)
    if thread.is_alive():
        from petastorm_tpu_torch import failpoints

        # The abandoned run may still hold the armed schedule: disarm so
        # the NEXT seed can arm (its own failure is already recorded).
        failpoints.disarm()
        return None, f"hung: run exceeded {timeout_s:.0f}s"
    return box.get("result"), box.get("error")


def shrink_points(run_fn, seed, points, timeout_s=DEFAULT_RUN_TIMEOUT_S):
    """Greedy ddmin-lite: drop one failpoint at a time while the failure
    still reproduces; the fixpoint is a (locally) minimal failing subset.
    Worst case O(n²) runs of ``run_fn`` — fine for a vocabulary of ~10
    points, and the reproducer it emits is what turns a fuzz hit into a
    targeted regression test."""
    points = list(points)
    changed = True
    while changed and len(points) > 1:
        changed = False
        for candidate in list(points):
            trial = [p for p in points if p != candidate]
            _, error = _run_guarded(run_fn, seed, trial, timeout_s)
            if error is not None and error.startswith("hung"):
                # The abandoned thread still holds a live topology and
                # may arm/fire/disarm the process-global schedule under
                # later trials — further shrinking would race it and
                # produce a nondeterministic (wrong) minimal set. Stop
                # here with what we have.
                logger.error(
                    "fuzz shrink aborted: a trial hung past %.0fs — "
                    "returning the current %d-point set un-shrunk",
                    timeout_s, len(points))
                return points
            if error is not None:
                points = trial
                changed = True
                logger.warning(
                    "fuzz shrink: still fails without %r — %d point(s) "
                    "remain", candidate, len(points))
                break
    return points


def reproducer_command(seed, points):
    """The EXACT command that replays a failing fuzz run: the seed, the
    (possibly shrunk) point set, and every geometry knob
    :func:`default_run_fn` used — a reproducer that ran under a different
    window, dataset size, or vocabulary would have a different
    call-count/fire profile and not replay the bug."""
    return ("python -m petastorm_tpu_torch.benchmark scenario service "
            f"--chaos failpoints --chaos-seed {seed} "
            f"--failpoint-points {','.join(points)} "
            "--failpoint-window 24 --rows 1536 --days 8 --workers 2 "
            "--batch-size 64 --cache mem --fleet-cache "
            f"--fleet-cache-drain-after 12 --shuffle-seed {seed} "
            "--ordered")


def fuzz(seeds, run_fn=None, shrink=True, check_determinism=True,
         compare_logs=False, timeout_s=DEFAULT_RUN_TIMEOUT_S):
    """Run the soak: every seed in ``seeds`` once (twice with
    ``check_determinism`` — the second run must produce the identical
    ``stream_digest``). Returns the report dict on an all-green soak;
    raises :class:`FuzzFailure` carrying the shrunk, seed-stamped
    reproducer on the first failing seed.

    :param run_fn: ``(seed, points) -> result dict`` (``points=None`` =
        full vocabulary); raises on invariant violation. Defaults to the
        real loopback service scenario.
    :param compare_logs: additionally require the two runs' injection
        logs to match (sorted). Off by default in the soak: a fire index
        sitting exactly at a point's run-to-run call-count boundary
        (wall-clock-paced heartbeats move totals by ±a few) can
        legitimately fire in one run and not the other without any
        determinism bug — the *digest* is the contract; the pinned
        replay test compares logs under a seed chosen away from such
        boundaries.
    """
    from petastorm_tpu_torch.failpoints import POINTS

    run_fn = run_fn if run_fn is not None else default_run_fn
    report = {"seeds": [int(s) for s in seeds], "runs": 0, "failures": []}
    for seed in report["seeds"]:
        result, error = _run_guarded(run_fn, seed, None, timeout_s)
        report["runs"] += 1
        if error is None and check_determinism:
            replay, error = _run_guarded(run_fn, seed, None, timeout_s)
            report["runs"] += 1
            if error is None and isinstance(result, dict) \
                    and isinstance(replay, dict):
                if replay.get("stream_digest") \
                        != result.get("stream_digest"):
                    error = ("digest-determinism violated: two runs of "
                             f"seed {seed} produced digests "
                             f"{result.get('stream_digest')} vs "
                             f"{replay.get('stream_digest')}")
                elif compare_logs and (
                        sorted(map(tuple,
                                   replay.get("failpoint_injections")
                                   or []))
                        != sorted(map(
                            tuple,
                            result.get("failpoint_injections") or []))):
                    error = ("injection-log determinism violated for "
                             f"seed {seed}")
        if error is None:
            logger.info("fuzz: seed %d green", seed)
            continue
        points = sorted(POINTS)
        if shrink and not error.startswith("hung"):
            # A hung run's abandoned thread still drives the process-
            # global schedule (it will arm-race and disarm it whenever it
            # finally unblocks) — shrink trials after it would be
            # nondeterministic, so a hang reports the full set.
            points = shrink_points(run_fn, seed, points,
                                   timeout_s=timeout_s)
        failure = {"seed": seed, "error": error, "points": points,
                   "reproducer": reproducer_command(seed, points)}
        # Attach the flight recorder's ring (telemetry/flight.py): the
        # scenario's structured event log right up to the violation —
        # what the fleet was DOING when the shrunk reproducer fails,
        # correlated by fencing epoch + batch id.
        from petastorm_tpu_torch.telemetry.flight import RECORDER

        failure["flight_dump"] = RECORDER.dump(
            f"fuzz-seed-{seed}")
        report["failures"].append(failure)
        logger.error("FUZZ REPRODUCER: %s (%s)", failure["reproducer"],
                     error)
        raise FuzzFailure(
            f"fuzz seed {seed} failed ({error}); shrunk reproducer: "
            f"{failure['reproducer']}", report)
    return report
