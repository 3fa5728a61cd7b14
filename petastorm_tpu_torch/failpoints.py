"""Deterministic in-process fault injection: named failpoints and seeded
schedules (the port's own copy of ``petastorm_tpu/failpoints.py``).

A :class:`FaultSchedule` derives, per failpoint, the call indices at which
it fires and the action it takes there, purely from ``(seed, point)``
through the seed tree's blake2b fold-in, so the i-th call of a point takes
the same action in every run of the same seed, in this package and in the
JAX package alike. Sites read the module global :data:`ACTIVE` once and
branch on ``None``: a disarmed schedule costs nothing else.

Failpoint vocabulary (point → actions a schedule may choose):

====================== =============================================
``transport.send``     ``reset``, ``torn``, ``delay``
``transport.recv``     ``reset``, ``delay``
``journal.append``     ``enospc`` (the WAL append fails: the
                       dispatcher degrades read-only)
``journal.fsync``      ``enospc``
``journal.compact``    ``torn_rename`` (a crash between the snapshot's
                       tmp write and its rename)
``cache.write``        ``oserror``, ``partial``
``cache.read``         ``oserror``
``decode.columnar``    ``fallback``, ``delay``
``dispatcher.reply``   ``drop`` (the reply vanishes after the handler
                       mutated state), ``delay``
``worker.heartbeat``   ``drop`` (one lease-renewal tick lost)
``piece.decode``       ``poison`` (only via ``poison_pieces=``)
``packing.state``      ``torn``
``shm-detach``         ``detach``
``torn-doorbell``      ``torn``
``stale-arena``        ``stale``
``slow-peer``          ``delay`` (one worker's batch send)
``breaker-trip``       ``reset`` (a client's stream reconnect)
``hedge-race``         ``delay`` (a hedge's launch)
``handoff-torn``       ``torn``
``cache-peer-gone``    ``gone``
====================== =============================================

The vocabulary is the JAX package's whole, so a schedule's decisions
match across the packages for any point set, and every point has its JAX
site: the framed transport's send and receives, the journal's three,
``dispatcher.reply``, ``worker.heartbeat``, ``slow-peer``,
``breaker-trip``, ``hedge-race``, the batch cache's ``cache.write`` and
``cache.read``, ``decode.columnar`` (the columnar payload encode and the
columnar decode worker), ``packing.state``, the shm ring's three, and the
fleet cache tier's ``handoff-torn`` and ``cache-peer-gone``.

Arming is process-wide and scoped::

    with failpoints.armed(FaultSchedule(seed=7)) as schedule:
        ...   # run the workload; schedule.log is the injection record
"""

from __future__ import annotations

import errno
import hashlib
import logging
import threading
import time
from contextlib import contextmanager

from petastorm_tpu_torch.telemetry.metrics import FAILPOINT_ARMED, FAILPOINT_FIRES

logger = logging.getLogger(__name__)

#: The full failpoint vocabulary: point name → the actions a schedule may
#: derive for it. ``generic`` actions (reset/delay/enospc/oserror) are
#: performed by :meth:`FaultSchedule.fire` itself; the rest are returned
#: to the call site, which implements the site-specific damage (a torn
#: prefix needs the socket, a partial entry needs the file).
POINTS = {
    "transport.send": ("reset", "torn", "delay"),
    "transport.recv": ("reset", "delay"),
    "journal.append": ("enospc",),
    "journal.fsync": ("enospc",),
    "journal.compact": ("torn_rename",),
    "cache.write": ("oserror", "partial"),
    "cache.read": ("oserror",),
    # Columnar hot path (framed_socket payload encode + the columnar
    # reader worker's vectorized decode): "fallback" exercises the
    # row/pickle degradation the path promises is byte-identical — the
    # soak's digest gate proves it.
    "decode.columnar": ("fallback", "delay"),
    "dispatcher.reply": ("drop", "delay"),
    "worker.heartbeat": ("drop",),
    "packing.state": ("torn",),
    # Shared-memory ring tier (service/shm_ring.py). All three are
    # site-specific: the ring producer implements the damage (flags,
    # garbage record, generation bump) and resets the paired socket so
    # the fault funnels into the same broken-stream recovery TCP faults
    # use.
    "shm-detach": ("detach",),
    "torn-doorbell": ("torn",),
    "stale-arena": ("stale",),
    # Resilience layer (service/resilience.py + client/worker wiring).
    # "slow-peer" delays one worker's batch send (the straggler the
    # hedged re-serve exists for); "breaker-trip" resets a client's
    # stream reconnect attempt (feeding the per-peer circuit breaker);
    # "hedge-race" delays the hedge launch so the original and the hedge
    # finish as close together as the schedule can arrange — hammering
    # the first-wins/loser-cancelled dedup claim.
    "slow-peer": ("delay",),
    "breaker-trip": ("reset",),
    "hedge-race": ("delay",),
    # Fleet cache tier (cache_impl/fleet_tier.py). "handoff-torn" aborts
    # a drain's warm handoff mid-entry-list (some entries shipped, the
    # rest left behind — the inheriting peer must cold-fill them, never
    # serve a torn one); "cache-peer-gone" makes a remote fetch/push see
    # a dead peer (feeding the per-peer breaker: the stream degrades to
    # a local fill, never an error).
    "handoff-torn": ("torn",),
    "cache-peer-gone": ("gone",),
}

#: ``piece.decode`` is separate: it only ever fires for explicitly named
#: ``poison_pieces`` — a schedule must not randomly poison data.
POISON_POINT = "piece.decode"

_KEY_BYTES = 8
_KEY_MASK = (1 << (8 * _KEY_BYTES)) - 1


def _fold_in(key, data):
    """Seed-tree key derivation: the blake2b construction of
    :func:`petastorm_tpu_torch.service.seedtree.fold_in`, repeated here so
    the transport layer can import this module without the service
    package."""
    h = hashlib.blake2b(digest_size=_KEY_BYTES)
    h.update((int(key) & _KEY_MASK).to_bytes(_KEY_BYTES, "big",
                                             signed=False))
    h.update(repr(data).encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


class FaultSchedule:
    """One seeded, replayable fault schedule over the failpoint vocabulary.

    :param seed: the reproducer seed. Everything the schedule will ever do
        — which call index of which point fires which action — is a pure
        function of it (and the ``points``/``max_fires``/``window``
        shape knobs).
    :param points: iterable restricting which failpoints are armed
        (default: every name in :data:`POINTS`); a failing schedule is
        narrowed by re-running with subsets.
    :param max_fires_per_point: fire indices derived per point.
    :param window: fire indices land in ``[min_index, window)`` — calls
        past the window never fire, so a run converges instead of
        re-injecting forever (retries re-enter the same points).
    :param min_index: the first few calls of every point are fault-free,
        so service bring-up (registration, the first plan) is never
        permanently wedged — faults land mid-flight, where they belong.
    :param poison_pieces: piece indices :meth:`poison_piece` reports as
        undecodable (the quarantine policy's injection vector). Never
        derived from the seed: poisoning is an explicit, named choice.
    :param delay_s: sleep for ``delay`` actions.
    :param fires: explicit ``{point: {call_index: action}}`` override for
        tests that need a fault at an exact call (bypasses derivation for
        the named points).
    :param targets: optional ``{point: key}`` pinning a point to one call
        site: sites pass their identity (e.g. a worker id) as
        ``check(point, key=...)``, and calls whose key does not match are
        invisible to the schedule — the counter does not advance, so the
        targeted site's call indices stay deterministic regardless of how
        peers interleave: one worker can be made the straggler.
    """

    def __init__(self, seed, points=None, max_fires_per_point=2,
                 window=400, min_index=4, poison_pieces=None,
                 delay_s=0.05, fires=None, targets=None):
        self.seed = int(seed)
        self.points = tuple(points) if points is not None \
            else tuple(sorted(POINTS))
        unknown = [p for p in self.points
                   if p not in POINTS and p != POISON_POINT]
        if unknown:
            raise ValueError(
                f"unknown failpoint(s) {unknown}; choose from "
                f"{sorted(POINTS)} + [{POISON_POINT!r}]")
        self.poison_pieces = frozenset(
            int(p) for p in (poison_pieces or ()))
        self.targets = dict(targets or {})
        self.delay_s = float(delay_s)
        self._lock = threading.Lock()
        self._calls = {}    # point -> call counter
        self._fires = {}    # point -> {call_index: action}
        self.log = []       # [(point, call_index, action)] in fire order
        for point in self.points:
            if point == POISON_POINT:
                continue
            plan = {}
            actions = POINTS[point]
            for k in range(int(max_fires_per_point)):
                index = min_index + _fold_in(
                    self.seed, ("fire", point, k)) % max(
                        1, int(window) - int(min_index))
                action = actions[_fold_in(
                    self.seed, ("action", point, k)) % len(actions)]
                plan.setdefault(index, action)  # collisions: first wins
            self._fires[point] = plan
        for point, plan in (fires or {}).items():
            self._fires[point] = {int(i): a for i, a in plan.items()}

    def check(self, point, key=None):
        """Advance ``point``'s call counter; return the action firing at
        this call (logged), or ``None``. Pure bookkeeping — the caller
        (or :meth:`fire`) performs the action. When the schedule pins
        ``point`` to a target, calls from other keys do not even advance
        the counter (see ``targets``)."""
        target = self.targets.get(point)
        if target is not None and key != target:
            return None
        with self._lock:
            index = self._calls.get(point, 0)
            self._calls[point] = index + 1
            action = self._fires.get(point, {}).get(index)
            if action is not None:
                self.log.append((point, index, action))
        if action is not None:
            FAILPOINT_FIRES.labels(point, action).inc()
            logger.warning("failpoint %s fired action %r (call %d, "
                           "seed %d)", point, action, index, self.seed)
        return action

    def fire(self, point, key=None):
        """:meth:`check`, then perform the generic actions in place:
        ``delay`` sleeps, ``enospc``/``oserror`` raise :class:`OSError`,
        ``reset`` raises :class:`ConnectionResetError`. Site-specific
        actions (``torn``/``partial``/``drop``/``torn_rename``/
        ``detach``/``stale``) are returned for the call site to
        implement."""
        action = self.check(point, key=key)
        if action is None:
            return None
        if action == "delay":
            time.sleep(self.delay_s)
            return "delay"
        if action == "enospc":
            raise OSError(errno.ENOSPC,
                          f"failpoint {point}: injected ENOSPC")
        if action == "oserror":
            raise OSError(f"failpoint {point}: injected I/O error")
        if action == "reset":
            raise ConnectionResetError(
                f"failpoint {point}: injected connection reset")
        return action

    def poison_piece(self, piece):
        """Whether ``piece`` is in the schedule's poison set (the
        streaming engine asks before decoding). Logged per query that
        answers yes, so the injection record shows every poisoned serve
        attempt."""
        if int(piece) not in self.poison_pieces:
            return False
        with self._lock:
            index = self._calls.get(POISON_POINT, 0)
            self._calls[POISON_POINT] = index + 1
            self.log.append((POISON_POINT, index, f"poison:{int(piece)}"))
        FAILPOINT_FIRES.labels(POISON_POINT, "poison").inc()
        return True

    def log_snapshot(self):
        """The injection log as JSON-ready rows (point, call index,
        action)."""
        with self._lock:
            return [list(entry) for entry in self.log]


#: The armed schedule, or ``None``. Hot-path sites read this ONCE and
#: branch on ``None`` — the entire disarmed cost.
ACTIVE = None

_ARM_LOCK = threading.Lock()


def arm(schedule):
    """Arm ``schedule`` process-wide. Exactly one schedule may be armed;
    arming over a live one raises (a leaked schedule must be loud)."""
    global ACTIVE
    with _ARM_LOCK:
        if ACTIVE is not None:
            raise RuntimeError(
                "a FaultSchedule is already armed — disarm() it first "
                "(overlapping schedules would make the injection log "
                "unattributable)")
        ACTIVE = schedule
    FAILPOINT_ARMED.set(1)
    logger.warning("failpoints armed (seed=%d, points=%s, poison=%s)",
                   schedule.seed, ",".join(schedule.points),
                   sorted(schedule.poison_pieces))
    return schedule


def disarm():
    """Disarm whatever is armed (idempotent); returns the schedule."""
    global ACTIVE
    with _ARM_LOCK:
        schedule, ACTIVE = ACTIVE, None
    FAILPOINT_ARMED.set(0)
    return schedule


@contextmanager
def armed(schedule):
    """``with failpoints.armed(FaultSchedule(seed)):`` — arm for a scope,
    always disarm on the way out (the leak guard checks)."""
    arm(schedule)
    try:
        yield schedule
    finally:
        disarm()
