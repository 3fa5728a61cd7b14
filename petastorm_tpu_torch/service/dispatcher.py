"""The dispatcher: the data service's control plane (the port's own copy of
``petastorm_tpu/service/dispatcher.py``: static, fcfs and dynamic sharding
with the journal, breakers, brownout, quarantine and fleet tracing).

It owns the split plan and nothing else: no sample bytes flow through it.
Workers register their address and the dataset's row-group count; clients
ask which pieces to stream from which workers. Every request is one framed
message with one framed reply (``type`` names the request):

- ``register_worker`` ``{worker_id, host, port, num_pieces[, re_register]}``
  → ``ok`` (a piece count other than the registered workers' is refused);
- ``worker_heartbeat`` ``{worker_id[, credit_wait_s]}`` → ``ok`` (lease
  renewed; the reply carries the brownout level, the clock-alignment
  beacon ``dispatcher_time_us`` and whether fleet tracing is armed) or
  ``unknown_worker`` (re-register);
- ``client_heartbeat`` ``{client_id[, epoch, watermarks,
  ready_saturation]}`` → ``ok`` with the fencing epoch and the recovery
  counters (a client resyncs when the epoch moved past its own);
- ``list_workers`` → ``workers`` (serving workers and the service config);
- ``get_assignment`` ``{client_id, client_index, num_clients, epoch}``
  (static) → ``assignment``: the client's shard (``pieces[index::n]``)
  round-robined across the serving workers, each share in the epoch's
  seed-tree order of ``shuffle_seed``;
- ``report_failure`` ``{client_id, worker_id, pieces[, fencing_epoch]}`` →
  ``assignment``: the dead worker's pieces re-partitioned across the
  survivors (``stale_fencing`` for a token older than the fencing epoch);
- ``next_split`` ``{client_id}`` (fcfs) → ``split`` or ``end_of_stream``
  (the shared queue refills until ``num_epochs`` are served);
- ``dynamic_plan`` ``{client_id, client_index, num_clients, epoch}``
  (dynamic) → ``plan``: the client's shard round-robined across the serving
  workers, every piece stamped with an ownership ``generation``;
- ``dynamic_sync`` ``{client_id, epoch, done, owned, stealable, rates,
  failed_steals}`` (dynamic) → ``deltas``: the work-stealing loop. The
  client reports its progress and each worker's backlog; the dispatcher
  reconciles its (journaled) ownership with the client's view as
  corrective steals, plans fresh steals (:func:`plan_steals`) away from
  drained or straggling workers, journals them and replies with the moves
  (``unknown_plan`` when it has no plan for that epoch);
- ``report_poison_piece`` ``{client_id, piece, worker_id, error, epoch}``
  → ``ok``: the piece is journaled into the quarantine set and excluded
  from every later grant;
- ``report_breaker`` ``{client_id, worker_id, error, epoch}`` → ``ok``: a
  client's circuit breaker tripped on the worker; it is journaled and left
  out of new grants until its own heartbeat, after ``breaker_cooldown_s``,
  closes the breaker;
- ``trace`` ``{action: arm|collect|disarm}``, ``trace_push`` (a peer's
  span ring) and ``stage_profile`` (a diagnosed per-stage profile,
  journaled): fleet tracing;
- ``worker_diagnostics`` → every live worker's ``diagnostics``, fetched
  concurrently; ``status`` → the control-plane state; ``ping`` → ``pong``.

With ``journal_dir`` every mutation is appended to a write-ahead log
(:mod:`petastorm_tpu_torch.service.journal`) after it applied, with
periodic compacted snapshots. A restarted dispatcher replays it, then bumps
the fencing epoch, so every client resyncs; the files are the JAX
dispatcher's, so either package recovers the other's journal. A failed
journal write flips the dispatcher read-only: mutating requests are refused
(retryable) until a full snapshot succeeds. A worker whose lease
(``lease_timeout_s``) expires is marked dead, and a client's
``report_failure`` does the same; either bumps the fencing epoch.

Autoscaling, jobs, corpora, mixtures and the fleet cache raise
NotImplementedError (or an ``error`` reply) naming the service slice that
brings them; their keys stand in the state at their empty values, so a
snapshot equals the JAX dispatcher's, and a journal record of theirs is
refused by name on replay.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.reader_impl.framed_socket import (
    ConnectionClosedError,
    FramedReader,
    FramedServer,
    send_framed,
)
from petastorm_tpu_torch.service.resilience import (
    BrownoutConfig,
    BrownoutPlanner,
    arrival_deadline,
    deadline_exceeded_reply,
    deadline_expired,
)
from petastorm_tpu_torch.service.seedtree import piece_order
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.flight import RECORDER as FLIGHT
from petastorm_tpu_torch.telemetry.metrics import (
    CLOCK_OFFSET_US,
    DISPATCHER_BACKLOG_PIECES,
    DISPATCHER_FENCING_EPOCH,
    DISPATCHER_GENERATION,
    DISPATCHER_RECOVERY_EVENTS,
    DISPATCHER_REQUESTS,
    DISPATCHER_STEALS,
    DISPATCHER_WORKERS,
    FLEET_BROWNOUT_LEVEL,
    QUARANTINE_PIECES,
    QUARANTINE_REPORTS,
    TRACE_SHIP_EVENTS,
)

logger = logging.getLogger(__name__)

MODES = ("static", "fcfs", "dynamic")

#: The job every request belongs to (multi-tenant jobs come with slice (d)).
DEFAULT_JOB = "default"

#: A worker missing heartbeats this long is evicted.
DEFAULT_LEASE_TIMEOUT_S = 30.0

#: Cap on the per-probe ``timeout`` of ``worker_diagnostics`` and ``trace``.
PROBE_TIMEOUT_CAP_S = 30.0

#: Journaled ``stage_profile`` records ``status`` keeps in memory.
STAGE_PROFILES_KEPT = 8

#: ``Dispatcher`` arguments this slice does not take: the value that asks
#: for nothing, and the slice that ports the feature.
UNPORTED_DISPATCHER_ARGS = {
    "autoscale": (None, "the fleet autoscaler comes with slice (d)"),
}

#: Requests of later slices, answered with an error naming the slice.
_UNPORTED_REQUESTS = {
    "register_job": "jobs come with the fleet, slice (d)",
    "end_job": "jobs come with the fleet, slice (d)",
    "set_mixture_weights": "mixtures come with the LLM stages, slice (f)",
    "get_mixture": "mixtures come with the LLM stages, slice (f)",
    "cache_handoff": "the fleet cache tier comes with slice (d)",
}

#: Journal record ops of later slices: a replay that meets one is refused
#: with the slice that writes it.
_UNPORTED_RECORD_OPS = {
    "job_register": "jobs come with the fleet, slice (d)",
    "job_end": "jobs come with the fleet, slice (d)",
    "autoscale": "the fleet autoscaler comes with slice (d)",
    "mixture_weights": "mixtures come with the LLM stages, slice (f)",
    "cache_handoff": "the fleet cache tier comes with slice (d)",
    "fleet_plan": "the fleet's model planner comes with slice (d)",
}

#: Dynamic mode: a worker delivering below this fraction of the fleet
#: median (while it still holds stealable backlog) is a straggler even
#: before any peer's deque drains.
STRAGGLER_RATE_FACTOR = 0.5


def plan_steals(pending, stealable, rates, straggler_factor=STRAGGLER_RATE_FACTOR,
                receivers=None):
    """The work-stealing planner (pure).

    :param pending: ``{worker_id: not-done piece count}`` over live workers.
    :param stealable: ``{worker_id: [pieces]}`` the client reports as not
        started: the only pieces a steal may touch (the revoke handshake
        guards a piece that starts between report and revoke).
    :param rates: ``{worker_id: rows_per_s}``, the client's delivery rates
        (maybe empty early in an epoch).
    :param receivers: the workers that may receive (``None``: every worker
        in ``pending``).
    :returns: ``[(piece, from_worker, to_worker), ...]``, taken from the
        donor's tail.

    Two triggers: a worker with no pending pieces receives from the most
    backlogged donor (**drain**); otherwise a donor below
    ``straggler_factor`` × the median rate sheds to a median-or-faster
    worker with materially less backlog (**straggler**). With both rates
    known the joint backlog splits in proportion to rate in one sync; a
    receiver that is itself a straggler takes at most a 2-piece probe (none
    for a share of 2 or less); a donor that delivered nothing against a
    moving receiver sheds down to one piece; without rates the midpoint.
    Every move is bounded by what is stealable, and the donor keeps at
    least one piece."""
    pending = dict(pending)
    stealable = {wid: list(ps) for wid, ps in stealable.items()}
    eligible = set(pending) if receivers is None else set(receivers)
    moves = []
    while True:
        donors = [wid for wid, ps in stealable.items() if ps and pending.get(wid, 0) > 1]
        if not donors:
            return moves
        donor = max(donors, key=lambda w: (pending[w], w))
        receivers_now = [wid for wid in pending
                         if wid != donor and wid in eligible and pending[wid] == 0]
        if not receivers_now:
            working = sorted(r for wid, r in rates.items() if pending.get(wid, 0) > 0)
            median = working[len(working) // 2] if working else None
            donor_rate = rates.get(donor)
            if median and donor_rate is not None and donor_rate < straggler_factor * median:
                receivers_now = [
                    wid for wid in pending
                    if wid != donor and wid in eligible and rates.get(wid, 0.0) >= median
                    # "Materially less backlog", waived while the donor has
                    # delivered nothing (equal backlogs say nothing then).
                    and (pending[wid] < pending[donor] - 1 or not donor_rate)]
        if not receivers_now:
            return moves
        recv = min(receivers_now, key=lambda w: (pending[w], -rates.get(w, 0.0), w))
        donor_rate, recv_rate = rates.get(donor), rates.get(recv)
        if donor_rate and recv_rate:
            joint = pending[donor] + pending[recv]
            keep = max(1, round(joint * donor_rate / (donor_rate + recv_rate)))
            count = pending[donor] - keep
            if count < 1:
                # The proportional share leaves the receiver idle: a drained
                # straggler near the epoch's tail.
                return moves
            working = sorted(r for wid, r in rates.items() if pending.get(wid, 0) > 0)
            tail_median = working[len(working) // 2] if working else None
            if tail_median and recv_rate < straggler_factor * tail_median:
                # The receiver is itself a straggler (it drained because it
                # was shed): a small share stays put, a large one moves as a
                # 2-piece probe until its rate matures.
                if count <= 2:
                    return moves
                count = 2
        elif not donor_rate and recv_rate and pending[donor] >= 4:
            # A donor that delivered nothing against a moving receiver:
            # shed to a one-piece floor in one sync.
            count = pending[donor] - 1
        else:
            count = max(1, (pending[donor] - pending[recv]) // 2)
        count = min(count, len(stealable[donor]))
        for _ in range(count):
            piece = stealable[donor].pop()
            moves.append((piece, donor, recv))
            pending[donor] -= 1
            pending[recv] += 1


class Dispatcher:
    """Split-assignment server; :meth:`start`, :meth:`stop` (a context
    manager too).

    :param mode: ``"static"`` (per-client shards), ``"fcfs"`` (one shared
        queue of splits) or ``"dynamic"`` (per-client shards rebalanced by
        work stealing).
    :param num_epochs: epochs the service serves (``None``: forever).
    :param journal_dir: directory of the crash-recovery journal (WAL and
        snapshots); ``None`` keeps the state in memory only.
    :param lease_timeout_s: evict a worker whose last heartbeat (or
        registration) is older; ``None`` or 0 disables expiry.
    :param journal_compact_every: WAL records between compactions.
    :param journal_fsync: fsync the WAL per append and the snapshot before
        its rename.
    :param max_frame_bytes: receive frame cap per connection.
    :param shuffle_seed: seed-tree order: each client epoch's piece order
        is a pure function of the seed, the epoch and the piece; ``None``
        orders pieces ascending. fcfs ignores it.
    :param brownout: arm the brownout state machine: ``True``, a dict of
        :class:`~petastorm_tpu_torch.service.resilience.BrownoutConfig`
        arguments or a config. It is evaluated on client heartbeats.
    :param breaker_cooldown_s: seconds a breaker-open worker stays out of
        new grants before its heartbeat may close the breaker.

    ``autoscale`` raises NotImplementedError naming its slice.
    """

    def __init__(self, host="127.0.0.1", port=0, mode="static", num_epochs=1,
                 journal_dir=None, lease_timeout_s=DEFAULT_LEASE_TIMEOUT_S,
                 journal_compact_every=256, journal_fsync=False, max_frame_bytes=None,
                 shuffle_seed=None, autoscale=None, brownout=None, breaker_cooldown_s=10.0):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        for name, value in {"autoscale": autoscale or None}.items():
            default, reason = UNPORTED_DISPATCHER_ARGS[name]
            if value != default:
                raise NotImplementedError(f"Dispatcher({name}=...) is not ported yet: "
                                          f"{reason}")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError("num_epochs must be a positive integer or None")
        self.mode = mode
        self.num_epochs = num_epochs
        self.shuffle_seed = int(shuffle_seed) if shuffle_seed is not None else None
        self.journal_dir = journal_dir
        self.lease_timeout_s = lease_timeout_s or None
        self._max_frame_bytes = max_frame_bytes
        self._lock = threading.Lock()
        self._workers = {}  # worker_id -> {address, num_pieces, alive, state}
        self._clients = {}  # client_id -> {epoch, client_index, num_clients}
        # The default job materializes on a client's first touch, as in the
        # JAX dispatcher, so the snapshots agree; other jobs are refused.
        self._jobs = {}
        self._job_recovery = {}
        # client_id -> {"epoch", "watermarks": {piece: next ordinal}}, from
        # client heartbeats, journaled at piece granularity.
        self._client_watermarks = {}
        self._num_pieces = None
        self._fcfs_queue = None
        self._fcfs_epoch = 0
        # Dynamic mode: per-client ownership of the epoch in flight
        # (client_id -> {"epoch", "owner": {piece: [wid, gen]}, "done",
        # "steals": {wid: {"in", "out"}}}) and the ownership generation
        # every grant and steal bumps: the token clients dedup batches by.
        self._dyn = {}
        self._generation = 0
        # The per-worker gauges and the per-job books walk every owner map:
        # recomputed only after a request that changed dynamic state.
        self._dyn_dirty = True
        self._per_job_memo = None
        # Runtime only: the last delivery rates dynamic_sync reported.
        self._last_rates = {}
        # Runtime only: leases and heartbeats restart from "now" on recovery.
        self._worker_leases = {}  # worker_id -> monotonic expiry
        self._client_heartbeats = {}
        self._fencing_epoch = 0
        self._recovery = {
            "journal_replays": 0, "fencing_bumps": 0, "evictions": 0,
            "failures_reported": 0, "re_registrations": 0, "stale_fencing_rejections": 0,
            "journal_write_failures": 0, "pieces_quarantined": 0}
        # Breaker-open workers (journaled) and their runtime trip clocks.
        self._breaker_open = {}
        self._breaker_opened_at = {}
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        # Brownout: the level and counts are journaled; the planner's streaks
        # and the windowed signals are runtime only.
        self._brownout_level = 0
        self._brownout_counts = {"shed": 0, "recover": 0}
        self._brownout_reason = None
        self._brownout = BrownoutConfig.coerce(brownout) if brownout else None
        self._brownout_planner = BrownoutPlanner(self._brownout) if self._brownout else None
        self._brownout_last_eval = None
        self._worker_credit_wait = {}  # wid -> last cumulative credit-wait seconds
        self._credit_wait_window = {}  # wid -> its value at the last evaluation
        self._client_ready_saturation = {}  # cid -> last ready-queue fullness
        # Quarantined pieces: piece -> report info, journaled.
        self._quarantined = {}
        # None, or why a failed journal write made this dispatcher read-only.
        self._degraded = None
        self._journal = None
        if journal_dir is not None:
            from petastorm_tpu_torch.service.journal import Journal

            self._journal = Journal(journal_dir, compact_every=journal_compact_every,
                                    fsync=journal_fsync)
        # Fleet tracing (runtime only): armed by the `trace` request; peers
        # learn it from heartbeat replies and push their rings here.
        self._trace_armed = False
        self._trace_buffers = {}  # peer -> {events, dropped, offset_us, min_rtt_us}
        self._stage_profiles = []
        #: The dispatcher's metrics endpoint, when the CLI serves one.
        self.metrics_address = None
        self._lease_thread = None
        self._server = FramedServer(self._serve_connection, host=host, port=port,
                                    name="service-dispatcher")

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._journal is not None:
            self._recover()
        self._server.start()
        if self.lease_timeout_s is not None:
            self._lease_thread = threading.Thread(target=self._lease_loop, daemon=True,
                                                  name="service-dispatcher-leases")
            self._lease_thread.start()
        return self

    @property
    def address(self):
        """``(host, port)`` clients and workers connect to."""
        return self._server.address

    def stop(self):
        self._server.stop()
        # In-flight handlers finish (and journal) before the journal closes.
        self._server.join(timeout=5)
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=5)
        if self._journal is not None:
            self._journal.close()

    def drop_connections(self):
        """Drop every open connection and keep serving (a network blip)."""
        self._server.close_connections()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

    # -- durability --------------------------------------------------------

    def state_snapshot(self):
        """The full persistable state (what a compacted snapshot holds),
        JSON-round-trippable and equal to the JAX dispatcher's for the same
        requests."""
        with self._lock:
            return self._state_dict_locked()

    def _state_dict_locked(self):
        return {
            "mode": self.mode,
            "num_epochs": self.num_epochs,
            "shuffle_seed": self.shuffle_seed,
            "num_pieces": self._num_pieces,
            "corpus_pieces": ({"": self._num_pieces} if self._num_pieces is not None
                              else {}),
            "mixtures": {},
            "workers": {wid: dict(w) for wid, w in self._workers.items()},
            "clients": {cid: dict(c) for cid, c in self._clients.items()},
            "jobs": {jid: dict(j) for jid, j in self._jobs.items()},
            "job_recovery": {jid: dict(r) for jid, r in self._job_recovery.items()},
            "job_fence_floor": 0,
            "autoscale": {"admit": 0, "drain": 0, "retire": 0},
            "cache_handoffs": [],
            "fleet_plans": [],
            "client_watermarks": {
                cid: {"epoch": entry["epoch"],
                      "watermarks": {str(p): n for p, n in entry["watermarks"].items()}}
                for cid, entry in self._client_watermarks.items()},
            "fcfs_epoch": self._fcfs_epoch,
            "fcfs_queue": list(self._fcfs_queue) if self._fcfs_queue is not None else None,
            "fencing_epoch": self._fencing_epoch,
            "recovery": dict(self._recovery),
            "quarantined": {str(p): dict(info) for p, info in self._quarantined.items()},
            "breaker_open": {wid: dict(info) for wid, info in self._breaker_open.items()},
            "brownout": {"level": self._brownout_level,
                         "counts": dict(self._brownout_counts),
                         "reason": self._brownout_reason},
            "generation": self._generation,
            # Owner maps as [piece, wid, gen] triplets (JSON keys are strings).
            "dyn": {
                cid: {"epoch": state["epoch"],
                      "owner": [[piece, wid, gen]
                                for piece, (wid, gen) in sorted(state["owner"].items())],
                      "done": sorted(state["done"]),
                      "steals": {wid: dict(counts) for wid, counts in state["steals"].items()}}
                for cid, state in self._dyn.items()},
        }

    def _recover(self):
        """Rebuild the state from the journal (snapshot, then WAL replay) and
        record the recovery: the fencing epoch bumps, so every pre-crash
        assignment must resync, and the replay is journaled."""
        state, records = self._journal.load()
        if state is None and not records:
            # A fresh journal: anchor it with the initial state.
            with self._lock:
                self._journal.snapshot(self._state_dict_locked())
            return
        with self._lock:
            if state is not None:
                self._install_state_locked(state)
            for record in records:
                self._apply_record_locked(record)
            now = time.monotonic()
            for wid, worker in self._workers.items():
                if worker["alive"]:
                    self._worker_leases[wid] = now + (self.lease_timeout_s or 0.0)
            self._recovery["journal_replays"] += 1
            self._journal.append({"op": "replayed"})
            self._bump_fencing_locked("journal_replay")
            self._sync_telemetry_locked()
        logger.warning("dispatcher recovered from journal %s: %d workers, %d clients, %d WAL "
                       "records replayed (fencing epoch %d)", self.journal_dir,
                       len(self._workers), len(self._clients), len(records),
                       self._fencing_epoch)

    def _refuse_later_slice(self, what, reason):
        raise NotImplementedError(f"journal at {self.journal_dir!r} holds {what}, which is "
                                  f"not ported yet: {reason}")

    def _install_state_locked(self, state):
        if state.get("mode") != self.mode:
            raise ValueError(
                f"journal at {self.journal_dir!r} was written by a {state.get('mode')!r}-"
                f"mode dispatcher; this one runs {self.mode!r} — refusing to mix split-plan "
                "semantics")
        if state.get("shuffle_seed") != self.shuffle_seed:
            raise ValueError(
                f"journal at {self.journal_dir!r} was written under shuffle_seed="
                f"{state.get('shuffle_seed')!r}; this dispatcher runs {self.shuffle_seed!r} — "
                "restarting with a different seed would silently change the piece order "
                "mid-run and break the determinism contract")
        later = {"mixtures": "mixtures come with the LLM stages, slice (f)",
                 "cache_handoffs": "the fleet cache tier comes with slice (d)",
                 "fleet_plans": "the fleet's model planner comes with slice (d)"}
        for key, reason in later.items():
            if state.get(key):
                self._refuse_later_slice(f"{key!r} state", reason)
        if any(jid != DEFAULT_JOB for jid in state.get("jobs") or {}):
            self._refuse_later_slice("jobs other than the default one",
                                     "jobs come with the fleet, slice (d)")
        if any(c for c in state.get("corpus_pieces") or {}):
            self._refuse_later_slice("corpora", "multi-corpus fleets come with the LLM "
                                                "stages, slice (f)")
        if any((state.get("autoscale") or {}).values()):
            self._refuse_later_slice("autoscale decisions",
                                     "the fleet autoscaler comes with slice (d)")
        self._num_pieces = state.get("num_pieces")
        self._client_watermarks = {
            cid: {"epoch": int(entry.get("epoch", 0)),
                  "watermarks": {int(p): int(n)
                                 for p, n in (entry.get("watermarks") or {}).items()}}
            for cid, entry in (state.get("client_watermarks") or {}).items()}
        self._workers = {wid: dict(w) for wid, w in state.get("workers", {}).items()}
        for wid, worker in self._workers.items():
            worker.setdefault("state", "serving")
            self._check_worker_record(wid, worker.get("state") == "standby",
                                      worker.get("corpus"), worker.get("cache_fleet"))
        self._clients = {cid: dict(c) for cid, c in state.get("clients", {}).items()}
        self._jobs = {jid: dict(j) for jid, j in (state.get("jobs") or {}).items()}
        self._job_recovery = {jid: dict(r)
                              for jid, r in (state.get("job_recovery") or {}).items()}
        self._fcfs_epoch = int(state.get("fcfs_epoch", 0))
        queue = state.get("fcfs_queue")
        self._fcfs_queue = deque(queue) if queue is not None else None
        self._fencing_epoch = int(state.get("fencing_epoch", 0))
        recovered = state.get("recovery", {})
        for key in self._recovery:
            self._recovery[key] = int(recovered.get(key, 0))
        self._quarantined = {}
        for key, info in (state.get("quarantined") or {}).items():
            if info.get("corpus"):
                self._refuse_later_slice("a quarantined piece of a corpus", "multi-corpus "
                                         "fleets come with the LLM stages, slice (f)")
            self._quarantined[int(key)] = dict(info)
        now = time.monotonic()
        self._breaker_open = {str(wid): dict(info)
                              for wid, info in (state.get("breaker_open") or {}).items()}
        # Like leases, a restored breaker starts a fresh cooldown.
        self._breaker_opened_at = {wid: now for wid in self._breaker_open}
        brownout = state.get("brownout") or {}
        self._brownout_level = int(brownout.get("level", 0))
        counts = brownout.get("counts") or {}
        for key in self._brownout_counts:
            self._brownout_counts[key] = int(counts.get(key, 0))
        self._brownout_reason = brownout.get("reason")
        self._generation = int(state.get("generation", 0))
        self._dyn = {}
        self._mark_dyn_dirty_locked()
        for cid, dyn in (state.get("dyn") or {}).items():
            self._dyn[cid] = {
                "epoch": int(dyn["epoch"]),
                "owner": {int(piece): [wid, int(gen)] for piece, wid, gen in dyn.get("owner", [])},
                "done": set(int(p) for p in dyn.get("done", [])),
                "steals": {wid: {"in": int(counts.get("in", 0)), "out": int(counts.get("out", 0))}
                           for wid, counts in dyn.get("steals", {}).items()}}

    def _check_worker_record(self, worker_id, standby, corpus, cache_fleet):
        if standby:
            self._refuse_later_slice(f"standby worker {worker_id!r}",
                                     "standby capacity comes with slice (d)")
        if corpus:
            self._refuse_later_slice(f"worker {worker_id!r} of corpus {corpus!r}",
                                     "multi-corpus fleets come with the LLM stages, "
                                     "slice (f)")
        if cache_fleet:
            self._refuse_later_slice(f"fleet-cache worker {worker_id!r}",
                                     "the fleet cache tier comes with slice (d)")

    def _apply_record_locked(self, record):
        """Replay one WAL record through the mutations the live handlers
        perform (without journaling: the record is the journal)."""
        op = record.get("op")
        if op in _UNPORTED_RECORD_OPS:
            self._refuse_later_slice(f"a {op!r} record", _UNPORTED_RECORD_OPS[op])
        if op == "register_worker":
            self._check_worker_record(record["worker_id"], record.get("standby"),
                                      record.get("corpus"), record.get("cache_fleet"))
            self._install_worker_locked(record["worker_id"],
                                        [record["host"], int(record["port"])],
                                        int(record["num_pieces"]),
                                        re_register=bool(record.get("re_register")),
                                        metrics_port=record.get("metrics_port"))
        elif op == "worker_dead":
            self._mark_worker_dead_locked(record["worker_id"],
                                          record.get("reason", "reported"),
                                          job_id=record.get("job_id"))
        elif op == "client":
            if record.get("job_id") or record.get("corpus"):
                self._refuse_later_slice("a client of a job or a corpus",
                                         "jobs come with the fleet, slice (d), corpora "
                                         "with the LLM stages, slice (f)")
            self._install_client_locked(record["client_id"], int(record["epoch"]),
                                        int(record["client_index"]),
                                        int(record["num_clients"]))
        elif op == "next_split":
            self._replay_next_split_locked(int(record["piece"]), int(record["epoch"]))
        elif op == "dynamic_plan":
            self._install_dynamic_plan_locked(
                record["client_id"], int(record["epoch"]),
                {int(p): [wid, int(gen)] for p, wid, gen in record["owner"]},
                int(record["generation"]))
        elif op == "steal":
            self._apply_steal_locked(record["client_id"], int(record["piece"]), record["from"],
                                     record["to"], int(record["generation"]))
        elif op == "steal_failed":
            self._apply_steal_failed_locked(record["client_id"], int(record["piece"]),
                                            record["worker_id"], int(record["generation"]))
        elif op == "dynamic_done":
            state = self._dyn.get(record["client_id"])
            if state is not None:
                state["done"].update(int(p) for p in record["pieces"])
        elif op == "watermarks":
            self._client_watermarks[record["client_id"]] = {
                "epoch": int(record.get("epoch", 0)),
                "watermarks": {int(p): int(n)
                               for p, n in (record.get("watermarks") or {}).items()}}
        elif op == "quarantine":
            if record.get("corpus"):
                self._refuse_later_slice("a quarantined piece of a corpus", "multi-corpus "
                                         "fleets come with the LLM stages, slice (f)")
            self._quarantine_piece_locked(int(record["piece"]), {
                "worker_id": record.get("worker_id"), "client_id": record.get("client_id"),
                "error": record.get("error"), "epoch": int(record.get("epoch", 0))})
        elif op == "breaker":
            if record.get("state") == "open":
                self._breaker_open_locked(record["worker_id"], {
                    "client_id": record.get("client_id"), "error": record.get("error"),
                    "epoch": int(record.get("epoch", 0))})
            else:
                self._breaker_close_locked(record["worker_id"])
        elif op == "brownout":
            self._apply_brownout_locked(record["action"], int(record["level"]),
                                        record.get("reason"))
        elif op == "fencing":
            self._fencing_epoch = int(record["fencing_epoch"])
            self._recovery["fencing_bumps"] += 1
        elif op == "stage_profile":
            self._stage_profiles.append({"profile": record.get("profile") or {},
                                         "coverage_pct": record.get("coverage_pct"),
                                         "source": record.get("source", "diagnose")})
            del self._stage_profiles[:-STAGE_PROFILES_KEPT]
        elif op == "replayed":
            self._recovery["journal_replays"] += 1
        else:
            logger.warning("journal: skipping unknown record op %r", op)

    def _replay_next_split_locked(self, piece, epoch):
        if self._fcfs_queue is None:
            self._fcfs_queue = deque(range(self._num_pieces or 0))
        if epoch > self._fcfs_epoch:
            self._fcfs_epoch = epoch
            self._fcfs_queue = deque(range(self._num_pieces or 0))
        if self._fcfs_queue and self._fcfs_queue[0] == piece:
            self._fcfs_queue.popleft()
        else:  # a hand-edited journal must not corrupt the queue
            try:
                self._fcfs_queue.remove(piece)
            except ValueError:
                pass

    def _journal_locked(self, record):
        if self._journal is None or self._degraded is not None:
            # A WAL that lost a record takes no further appends: only a full
            # snapshot (_check_writable_locked) resumes journaling.
            return
        try:
            self._journal.append(record)
            self._journal.maybe_compact(self._state_dict_locked)
        except OSError as exc:
            # The mutation applied in memory, but durability is gone: go
            # read-only until a full snapshot supersedes the lost record.
            self._degraded = f"journal write failed: {exc}"
            self._recovery["journal_write_failures"] += 1
            logger.error("journal write failed (%s) — dispatcher is now READ-ONLY: "
                         "state-mutating requests will be refused until a recovery snapshot "
                         "succeeds", exc)

    def _check_writable_locked(self):
        """The read-only gate of mutating handlers: ``None`` when the journal
        is healthy or a recovery snapshot just succeeded, else the
        (retryable) error reply."""
        if self._degraded is None:
            return None
        try:
            self._journal.snapshot(self._state_dict_locked())
        except OSError as exc:
            self._recovery["journal_write_failures"] += 1
            return {"type": "error", "retryable": True, "error": (
                f"dispatcher is read-only (degraded: {self._degraded}; recovery snapshot "
                f"failed: {exc}) — state-mutating requests are refused so the control "
                "plane cannot diverge from its journal")}
        logger.warning("journal recovered via full snapshot — leaving degraded read-only "
                       "mode (was: %s)", self._degraded)
        self._degraded = None
        return None

    def _bump_fencing_locked(self, reason):
        self._fencing_epoch += 1
        self._recovery["fencing_bumps"] += 1
        self._journal_locked({"op": "fencing", "fencing_epoch": self._fencing_epoch,
                              "reason": reason})
        self._trace_instant("dispatcher.fencing_bump", fencing_epoch=self._fencing_epoch,
                            reason=reason)
        FLIGHT.set_context(fencing_epoch=self._fencing_epoch)
        logger.info("fencing epoch bumped to %d (%s)", self._fencing_epoch, reason)

    # -- poison-piece quarantine -------------------------------------------

    def _quarantine_piece_locked(self, piece, info):
        """One mutation site (live and replay): record the piece and mark it
        done in every client's dynamic books, so neither the steal planner
        nor reconciliation grants it again. A duplicate report is a no-op."""
        if piece in self._quarantined:
            return False
        self._quarantined[piece] = dict(info)
        self._recovery["pieces_quarantined"] += 1
        for state in self._dyn.values():
            if piece in state["owner"] and piece not in state["done"]:
                state["done"].add(piece)
                self._mark_dyn_dirty_locked()
        return True

    def _grantable_pieces_locked(self, pieces):
        """``pieces`` less the quarantined ones: the one exclusion rule of
        every grant (assignment, takeover re-partition, fcfs split)."""
        if not self._quarantined:
            return list(pieces)
        return [p for p in pieces if p not in self._quarantined]

    def _handle_report_poison_piece(self, header):
        piece = int(header["piece"])
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            info = {"worker_id": header.get("worker_id"),
                    "client_id": header.get("client_id"),
                    "error": str(header.get("error", ""))[:512],
                    "epoch": int(header.get("epoch", 0))}
            fresh = self._quarantine_piece_locked(piece, info)
            if fresh:
                self._journal_locked(dict(info, op="quarantine", piece=piece))
            quarantined = sorted(self._quarantined)
        if fresh:
            QUARANTINE_REPORTS.labels("dispatcher").inc()
            logger.warning("piece %d quarantined (worker %s: %s) — excluded from all "
                           "future grants", piece, info["worker_id"], info["error"])
        return {"type": "ok", "piece": piece, "fresh": fresh, "quarantined": quarantined}

    # -- circuit breakers ----------------------------------------------------

    def _breaker_open_locked(self, worker_id, info):
        if worker_id in self._breaker_open:
            return False
        self._breaker_open[worker_id] = dict(info)
        self._breaker_opened_at[worker_id] = time.monotonic()
        self._trace_instant("dispatcher.breaker_open", worker=worker_id,
                            error=info.get("error"))
        return True

    def _breaker_close_locked(self, worker_id):
        self._breaker_opened_at.pop(worker_id, None)
        closed = self._breaker_open.pop(worker_id, None) is not None
        if closed:
            self._trace_instant("dispatcher.breaker_close", worker=worker_id)
        return closed

    def _handle_report_breaker(self, header):
        """A client's breaker tripped on a worker: journal the exclusion and
        route new grants around it until its heartbeat, after the cooldown,
        closes the breaker."""
        worker_id = str(header["worker_id"])
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            if worker_id not in self._workers:
                return {"type": "error", "error": f"unknown worker {worker_id!r}"}
            info = {"client_id": header.get("client_id"),
                    "error": str(header.get("error", ""))[:512],
                    "epoch": int(header.get("epoch", 0))}
            fresh = self._breaker_open_locked(worker_id, info)
            if fresh:
                self._journal_locked(dict(info, op="breaker", worker_id=worker_id,
                                          state="open"))
            open_now = sorted(self._breaker_open)
        if fresh:
            logger.warning("circuit breaker OPEN for worker %s (%s) — excluded from new "
                           "grants until its heartbeat probe closes it", worker_id,
                           info["error"])
        return {"type": "ok", "worker_id": worker_id, "fresh": fresh,
                "breaker_open": open_now}

    def _maybe_close_breaker_locked(self, worker_id):
        """The half-open probe, on the worker's own heartbeat: past the
        cooldown a still-heartbeating worker rejoins (journaled)."""
        if worker_id not in self._breaker_open:
            return
        opened = self._breaker_opened_at.get(worker_id)
        if opened is not None and time.monotonic() - opened < self.breaker_cooldown_s:
            return
        if self._check_writable_locked() is not None:
            return  # retried on a later heartbeat
        if self._breaker_close_locked(worker_id):
            self._journal_locked({"op": "breaker", "worker_id": worker_id,
                                  "state": "closed"})
            logger.warning("circuit breaker CLOSED for worker %s — heartbeat probe after "
                           "%.1fs cooldown; rejoining the serving set", worker_id,
                           self.breaker_cooldown_s)

    # -- brownout ------------------------------------------------------------

    def _apply_brownout_locked(self, action, level, reason=None):
        """One level at a time (live and replay); a stale transition is a
        no-op, so replays converge."""
        if action == "shed" and level == self._brownout_level + 1:
            self._brownout_level = level
        elif action == "recover" and level == self._brownout_level - 1:
            self._brownout_level = level
        else:
            return False
        self._brownout_counts[action] += 1
        self._brownout_reason = reason
        self._trace_instant("dispatcher.brownout", action=action, level=level, reason=reason)
        return True

    def apply_brownout(self, action, level, reason=None):
        """Apply one brownout transition, journaled; the level rides every
        heartbeat reply, and level 2 sheds optional stages peer-side."""
        with self._lock:
            if self._check_writable_locked() is not None:
                return False
            applied = self._apply_brownout_locked(action, level, reason)
            if applied:
                self._journal_locked({"op": "brownout", "action": action, "level": level,
                                      "reason": reason})
                self._sync_telemetry_locked()
        if applied:
            logger.warning("brownout: %s to level %d (%s)", action, level,
                           reason or "operator")
        return applied

    def _overload_signals_locked(self, now):
        """The fleet's credit-wait accumulation rate over the window (from
        worker heartbeats) and the fullest client ready-queue."""
        elapsed = (now - self._brownout_last_eval
                   if self._brownout_last_eval is not None else None)
        wait_delta = 0.0
        for wid, total in self._worker_credit_wait.items():
            wait_delta += max(0.0, total - self._credit_wait_window.get(wid, total))
        self._credit_wait_window = dict(self._worker_credit_wait)
        rate = wait_delta / elapsed if elapsed and elapsed > 0 else 0.0
        saturation = max(self._client_ready_saturation.values(), default=0.0)
        return {"level": self._brownout_level, "credit_wait_rate": rate,
                "ready_saturation": saturation}

    def _maybe_evaluate_brownout_locked(self):
        """Brownout evaluation, on client-heartbeat arrivals, at most once
        per ``interval_s``; decisions are journaled."""
        if self._brownout_planner is None:
            return
        now = time.monotonic()
        if self._brownout_last_eval is not None \
                and now - self._brownout_last_eval < self._brownout.interval_s:
            return
        signals = self._overload_signals_locked(now)
        self._brownout_last_eval = now
        for decision in self._brownout_planner.plan(signals):
            if self._check_writable_locked() is not None:
                return
            if self._apply_brownout_locked(decision["action"], decision["level"],
                                           decision.get("reason")):
                self._journal_locked({"op": "brownout", "action": decision["action"],
                                      "level": decision["level"],
                                      "reason": decision.get("reason")})
                logger.warning("brownout: %s to level %d (%s)", decision["action"],
                               decision["level"], decision.get("reason"))

    # -- liveness ----------------------------------------------------------

    def _lease_loop(self):
        interval = max(0.05, (self.lease_timeout_s or 1.0) / 4.0)
        while not self._server.stopped.wait(interval):
            now = time.monotonic()
            with self._lock:
                expired = [wid for wid, worker in self._workers.items()
                           if worker["alive"] and self._worker_leases.get(wid, now) <= now]
                for wid in expired:
                    logger.warning("worker %s missed its %.1fs lease — evicting (its "
                                   "splits re-assign via the takeover path)", wid,
                                   self.lease_timeout_s)
                    self._mark_worker_dead_locked(wid, "lease_expired")
                    self._journal_locked({"op": "worker_dead", "worker_id": wid,
                                          "reason": "lease_expired"})
                if expired:
                    self._bump_fencing_locked("lease_expiry")
                    self._sync_telemetry_locked()

    def _mark_worker_dead_locked(self, worker_id, reason, job_id=None):
        worker = self._workers.get(worker_id)
        if worker is None or not worker["alive"]:
            return False
        worker["alive"] = False
        self._worker_leases.pop(worker_id, None)
        self._last_rates.pop(worker_id, None)
        self._worker_credit_wait.pop(worker_id, None)
        self._credit_wait_window.pop(worker_id, None)
        self._trace_instant("dispatcher.worker_dead", worker=worker_id, reason=reason)
        if reason == "lease_expired":
            self._recovery["evictions"] += 1
        else:
            self._recovery["failures_reported"] += 1
            if job_id is not None:
                self._job_recovery_locked(job_id)["failures_reported"] += 1
        return True

    def _install_worker_locked(self, worker_id, address, num_pieces, re_register=False,
                               metrics_port=None):
        known = worker_id in self._workers
        prev_state = self._workers[worker_id].get("state") if known else None
        self._num_pieces = num_pieces
        self._workers[worker_id] = {"address": list(address), "num_pieces": num_pieces,
                                    "alive": True, "state": prev_state or "serving"}
        if metrics_port is not None:
            self._workers[worker_id]["metrics_port"] = int(metrics_port)
        if known or re_register:
            self._recovery["re_registrations"] += 1
        self._worker_leases[worker_id] = time.monotonic() + (self.lease_timeout_s or 0.0)
        return known

    def _job_recovery_locked(self, job_id):
        return self._job_recovery.setdefault(
            job_id, {"failures_reported": 0, "stale_fencing_rejections": 0,
                     "fencing_bumps": 0})

    def _install_client_locked(self, client_id, epoch, client_index, num_clients):
        entry = {"epoch": int(epoch), "client_index": int(client_index),
                 "num_clients": int(num_clients)}
        if self._clients.get(client_id) != entry:
            self._per_job_memo = None
        self._clients[client_id] = entry
        job = self._jobs.setdefault(DEFAULT_JOB, {"weight": 1.0, "quota": None,
                                                  "fencing_offset": 0, "epoch": 0})
        job["epoch"] = max(job["epoch"], int(epoch))

    def _default_job_share_locked(self):
        """The default job's max-min fair share of the serving capacity:
        its demand (the dynamic backlog, else the whole capacity while it
        has clients) capped at the capacity."""
        capacity = float(max(1, len(self._serving_workers())))
        backlog = (self._dynamic_per_job_locked().get(DEFAULT_JOB, {}).get("backlog", 0)
                   if self.mode == "dynamic" else 0)
        demand = float(backlog) if backlog else (capacity if self._clients else 0.0)
        return round(min(demand, capacity), 4)

    # -- dynamic-mode mutations (live handlers and WAL replay) ---------------

    def _install_dynamic_plan_locked(self, client_id, epoch, owner, generation):
        self._mark_dyn_dirty_locked()
        self._dyn[client_id] = {"epoch": epoch, "owner": dict(owner), "done": set(),
                                "steals": {}}
        self._generation = max(self._generation, generation)

    def _steal_counts_locked(self, state, worker_id):
        return state["steals"].setdefault(worker_id, {"in": 0, "out": 0})

    def _apply_steal_locked(self, client_id, piece, from_wid, to_wid, generation):
        state = self._dyn.get(client_id)
        if state is None:
            return
        self._mark_dyn_dirty_locked()
        state["owner"][piece] = [to_wid, generation]
        self._generation = max(self._generation, generation)
        self._steal_counts_locked(state, from_wid)["out"] += 1
        self._steal_counts_locked(state, to_wid)["in"] += 1
        self._trace_instant("dispatcher.steal", piece=piece, src=from_wid, dst=to_wid,
                            generation=generation)

    def _apply_steal_failed_locked(self, client_id, piece, kept_wid, generation):
        """A steal the client could not apply (the donor had already sent a
        batch of the piece, or its stream was mid-takeover): ownership goes
        back to where the piece stayed."""
        state = self._dyn.get(client_id)
        if state is None:
            return
        self._mark_dyn_dirty_locked()
        state["owner"][piece] = [kept_wid, generation]
        self._generation = max(self._generation, generation)

    def _mark_dyn_dirty_locked(self):
        """Dynamic state changed: re-arm the gauge aggregation and drop the
        per-job memo (both derive from the owner maps)."""
        self._dyn_dirty = True
        self._per_job_memo = None

    def _dynamic_per_worker_locked(self):
        """Per-worker backlog and steals over every client's plan: the one
        definition ``status`` and the gauges share."""
        per_worker = {}

        def entry(wid):
            return per_worker.setdefault(wid, {"backlog": 0, "steals_in": 0, "steals_out": 0})

        for state in self._dyn.values():
            for piece, (wid, _gen) in state["owner"].items():
                e = entry(wid)
                if piece not in state["done"]:
                    e["backlog"] += 1
            for wid, counts in state["steals"].items():
                e = entry(wid)
                e["steals_in"] += counts["in"]
                e["steals_out"] += counts["out"]
        return per_worker

    def _dynamic_per_job_locked(self):
        """The same books keyed by each client's job (every client is the
        default job's until slice (d)), memoized until the next dynamic
        mutation. Read-only for callers."""
        if self._per_job_memo is not None:
            return self._per_job_memo
        per_job = {}
        for state in self._dyn.values():
            entry = per_job.setdefault(DEFAULT_JOB, {
                "backlog": 0, "steals_in": 0, "steals_out": 0, "pieces_done": 0,
                "pieces_total": 0, "active_clients": 0})
            entry["active_clients"] += 1
            entry["pieces_done"] += len(state["done"])
            entry["pieces_total"] += len(state["owner"])
            entry["backlog"] += sum(1 for piece in state["owner"] if piece not in state["done"])
            for counts in state["steals"].values():
                entry["steals_in"] += counts["in"]
                entry["steals_out"] += counts["out"]
        self._per_job_memo = per_job
        return per_job

    def _dynamic_status_locked(self):
        return {
            "generation": self._generation,
            "per_worker": self._dynamic_per_worker_locked(),
            "per_job": self._dynamic_per_job_locked(),
            "clients": {cid: {"epoch": state["epoch"], "job_id": DEFAULT_JOB,
                              "pieces_done": len(state["done"]),
                              "pieces_total": len(state["owner"])}
                        for cid, state in self._dyn.items()},
        }

    def fleet_signals(self):
        """The autoscaler's input (the autoscaler comes with slice (d)):
        worker lifecycle states, the live backlog and the last delivery
        rates. ``backlog_known`` is False outside dynamic mode, which tracks
        no per-worker progress: zero backlog there is not an idle fleet."""
        with self._lock:
            by_state = {"serving": [], "standby": [], "draining": []}
            for wid, worker in sorted(self._workers.items()):
                if worker["alive"]:
                    by_state.setdefault(worker.get("state", "serving"), []).append(wid)
            backlog = ({wid: entry["backlog"]
                        for wid, entry in self._dynamic_per_worker_locked().items()}
                       if self.mode == "dynamic" else {})
            return {"serving": by_state["serving"], "standby": by_state["standby"],
                    "draining": by_state["draining"], "backlog": backlog,
                    "backlog_known": self.mode == "dynamic",
                    "rates": dict(self._last_rates),
                    "stage_profiles": [dict(p) for p in self._stage_profiles]}

    # -- request handling --------------------------------------------------

    def _serve_connection(self, sock):
        reader = FramedReader(sock, max_frame_bytes=self._max_frame_bytes)
        while not self._server.stopped.is_set():
            header, _ = reader.recv()
            try:
                reply = self._handle(header)
            except Exception as exc:  # reply instead of killing the connection
                logger.exception("dispatcher request %r failed", header)
                reply = {"type": "error", "error": str(exc)}
            fp = failpoints.ACTIVE
            if fp is not None and fp.fire("dispatcher.reply") == "drop":
                # The handler ran (state mutated, journal appended) and only
                # the reply vanishes: the client's retry repeats the request.
                raise ConnectionClosedError("failpoint dispatcher.reply: reply dropped after "
                                            "the state mutation applied")
            # A handler may return (header, payload): worker_diagnostics and
            # trace carry arbitrary data as their payload.
            if isinstance(reply, tuple):
                send_framed(sock, reply[0], reply[1])
            else:
                send_framed(sock, reply)

    def _handle(self, header):
        kind = header.get("type")
        if kind in _UNPORTED_REQUESTS:
            DISPATCHER_REQUESTS.labels(kind).inc()
            return {"type": "error", "error": f"request {kind!r} is not ported yet: "
                                              f"{_UNPORTED_REQUESTS[kind]}"}
        handler = getattr(self, f"_handle_{kind}", None)
        if handler is None:
            DISPATCHER_REQUESTS.labels("unknown").inc()
            return {"type": "error", "error": f"unknown request {kind!r}"}
        DISPATCHER_REQUESTS.labels(kind).inc()
        refusal = self._scope_refusal(header)
        if refusal is not None:
            return refusal
        t_rpc = time.perf_counter()
        try:
            # A request whose propagated budget already expired is refused
            # (retryable) before the handler runs.
            if deadline_expired(arrival_deadline(header)):
                return deadline_exceeded_reply(f"dispatcher.{kind}")
            return handler(header)
        finally:
            self._record_rpc_span(kind, header, t_rpc)
            with self._lock:
                self._sync_telemetry_locked()

    @staticmethod
    def _scope_refusal(header):
        """An error reply for a request scoped to a job or a corpus."""
        job = header.get("job_id")
        if job and str(job) != DEFAULT_JOB:
            return {"type": "error", "error": "job_id is not ported yet: jobs come with "
                                              "the fleet, slice (d)"}
        if header.get("corpus"):
            return {"type": "error", "error": "corpus is not ported yet: multi-corpus "
                                              "fleets come with the LLM stages, slice (f)"}
        return None

    @staticmethod
    def _record_rpc_span(kind, header, t_start):
        """One ``dispatcher.<kind>`` span per request, with the caller's
        propagated trace context as its args."""
        collector = tracing.COLLECTOR
        if not collector.enabled:
            return
        ctx = header.get("trace")
        args = {k: v for k, v in ctx.items() if k in ("peer", "job_id")} \
            if isinstance(ctx, dict) else {}
        bid = ctx.get("bid") if isinstance(ctx, dict) else None
        collector.record_span(f"dispatcher.{kind}", t_start, time.perf_counter(), bid=bid,
                              args=args or None)

    @staticmethod
    def _trace_instant(name, **args):
        """A control-plane decision as a zero-duration trace marker and a
        flight-recorder note."""
        collector = tracing.COLLECTOR
        if collector.enabled:
            collector.instant(name, time.perf_counter(), args=args)
        FLIGHT.note(name, **args)

    def _sync_telemetry_locked(self):
        DISPATCHER_FENCING_EPOCH.set(self._fencing_epoch)
        alive = sum(1 for w in self._workers.values() if w["alive"])
        DISPATCHER_WORKERS.labels("alive").set(alive)
        DISPATCHER_WORKERS.labels("dead").set(len(self._workers) - alive)
        for event, count in self._recovery.items():
            DISPATCHER_RECOVERY_EVENTS.labels(event).set(count)
        QUARANTINE_PIECES.set(len(self._quarantined))
        FLEET_BROWNOUT_LEVEL.set(self._brownout_level)
        if self.mode != "dynamic":
            return
        DISPATCHER_GENERATION.set(self._generation)
        if not self._dyn_dirty:
            return  # the gauges below are still exact
        self._dyn_dirty = False
        per_worker = self._dynamic_per_worker_locked()
        for wid in set(self._workers) | set(per_worker):
            entry = per_worker.get(wid)
            DISPATCHER_BACKLOG_PIECES.labels(wid).set(entry["backlog"] if entry else 0)
        for wid, entry in per_worker.items():
            DISPATCHER_STEALS.labels(wid, "in").set(entry["steals_in"])
            DISPATCHER_STEALS.labels(wid, "out").set(entry["steals_out"])

    def _handle_ping(self, header):
        return {"type": "pong"}

    def _handle_register_worker(self, header):
        worker_id = header["worker_id"]
        num_pieces = int(header["num_pieces"])
        re_register = bool(header.get("re_register"))
        if header.get("standby"):
            return {"type": "error", "error": "standby workers are not ported yet: "
                                              "standby capacity comes with slice (d)"}
        if header.get("cache_fleet"):
            return {"type": "error", "error": "fleet-cache workers are not ported yet: the "
                                              "fleet cache tier comes with slice (d)"}
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            if self._num_pieces is not None and self._num_pieces != num_pieces:
                return {"type": "error", "error": (
                    f"worker {worker_id!r} enumerated {num_pieces} row-group pieces but "
                    f"corpus 'default''s service plan has {self._num_pieces} — all of a "
                    "corpus's workers must read the same dataset with the same planning "
                    "config")}
            metrics_port = header.get("metrics_port")
            self._install_worker_locked(worker_id, [header["host"], int(header["port"])],
                                        num_pieces, re_register=re_register,
                                        metrics_port=metrics_port)
            record = {"op": "register_worker", "worker_id": worker_id,
                      "host": header["host"], "port": int(header["port"]),
                      "num_pieces": num_pieces, "re_register": re_register,
                      "standby": False}
            if metrics_port is not None:
                record["metrics_port"] = int(metrics_port)
            self._journal_locked(record)
            fencing = self._fencing_epoch
            state = self._workers[worker_id]["state"]
        logger.info("worker %s %sregistered at %s:%s (%d pieces)", worker_id,
                    "re-" if re_register else "", header["host"], header["port"],
                    num_pieces)
        return {"type": "ok", "fencing_epoch": fencing, "state": state}

    def _handle_worker_heartbeat(self, header):
        worker_id = header["worker_id"]
        with self._lock:
            worker = self._workers.get(worker_id)
            if worker is None or not worker["alive"]:
                return {"type": "unknown_worker", "fencing_epoch": self._fencing_epoch}
            self._worker_leases[worker_id] = time.monotonic() + (self.lease_timeout_s or 0.0)
            if "credit_wait_s" in header:
                try:
                    self._worker_credit_wait[worker_id] = float(header["credit_wait_s"])
                except (TypeError, ValueError):
                    pass
            self._maybe_close_breaker_locked(worker_id)
            return {"type": "ok", "fencing_epoch": self._fencing_epoch,
                    "brownout_level": self._brownout_level,
                    "worker_state": worker.get("state", "serving"),
                    "cache_peers": [],
                    # The clock-alignment beacon: this dispatcher's trace
                    # timebase "now", and whether fleet tracing is armed.
                    "dispatcher_time_us": tracing.COLLECTOR.now_us(),
                    "trace": self._trace_armed}

    def _handle_client_heartbeat(self, header):
        client_id = header.get("client_id")
        with self._lock:
            known = client_id in self._clients
            self._client_heartbeats[client_id] = time.monotonic()
            if "ready_saturation" in header:
                try:
                    self._client_ready_saturation[client_id] = min(
                        1.0, max(0.0, float(header["ready_saturation"])))
                except (TypeError, ValueError):
                    pass
            self._maybe_evaluate_brownout_locked()
            if "watermarks" in header:
                # Journaled at piece granularity only (the epoch or the set
                # of pieces mid-flight moved): ordinals tick per batch.
                entry = {"epoch": int(header.get("epoch", 0)),
                         "watermarks": {int(p): int(n)
                                        for p, n in (header.get("watermarks") or {}).items()}}
                prev = self._client_watermarks.get(client_id)
                if prev != entry:
                    self._client_watermarks[client_id] = entry
                    if prev is None or prev["epoch"] != entry["epoch"] \
                            or set(prev["watermarks"]) != set(entry["watermarks"]):
                        self._journal_locked({
                            "op": "watermarks", "client_id": client_id,
                            "epoch": entry["epoch"],
                            "watermarks": {str(p): n
                                           for p, n in entry["watermarks"].items()}})
            return {"type": "ok", "known": known, "fencing_epoch": self._fencing_epoch,
                    "recovery": dict(self._recovery),
                    "brownout_level": self._brownout_level, "credit_scale": 1.0,
                    "dispatcher_time_us": tracing.COLLECTOR.now_us(),
                    "trace": self._trace_armed}

    def _alive_workers(self):
        return {wid: w for wid, w in self._workers.items() if w["alive"]}

    def _serving_workers(self):
        """Workers eligible for new grants: alive and not breaker-open;
        when every one is breaker-open the exclusion yields."""
        workers = self._alive_workers()
        if self._breaker_open:
            healthy = {wid: w for wid, w in workers.items() if wid not in self._breaker_open}
            if healthy:
                return healthy
        return workers

    def _handle_list_workers(self, header):
        with self._lock:
            return {"type": "workers",
                    "workers": {wid: w["address"]
                                for wid, w in self._serving_workers().items()},
                    "mode": self.mode, "num_epochs": self.num_epochs,
                    "num_pieces": self._num_pieces, "shuffle_seed": self.shuffle_seed,
                    "fencing_epoch": self._fencing_epoch}

    @staticmethod
    def _partition(pieces, worker_ids):
        """Round-robin a piece list across workers; empty shares dropped."""
        assignments = {wid: list(pieces[i::len(worker_ids)])
                       for i, wid in enumerate(worker_ids)}
        return {wid: ps for wid, ps in assignments.items() if ps}

    def _handle_get_assignment(self, header):
        if self.mode != "static":
            return {"type": "error", "error":
                    "get_assignment is a static-mode request; fcfs clients use next_split, "
                    "dynamic clients use dynamic_plan"}
        client_index = int(header["client_index"])
        num_clients = int(header["num_clients"])
        if not 0 <= client_index < num_clients:
            return {"type": "error", "error": f"client_index {client_index} out of range "
                                              f"[0, {num_clients})"}
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            if self._num_pieces is None:
                return {"type": "error", "error": "no workers have registered yet"}
            alive = self._serving_workers()
            if not alive:
                return {"type": "error", "error": "no live workers"}
            # Partition the ascending piece list (the same workers serve the
            # same pieces every epoch), then order each share by the epoch's
            # seed-tree keys.
            epoch = int(header.get("epoch", 0))
            client_pieces = self._grantable_pieces_locked(
                list(range(self._num_pieces))[client_index::num_clients])
            assignments = {wid: piece_order(self.shuffle_seed, epoch, pieces)
                           for wid, pieces in self._partition(client_pieces,
                                                              sorted(alive)).items()}
            self._install_client_locked(header["client_id"], epoch, client_index,
                                        num_clients)
            self._client_heartbeats[header["client_id"]] = time.monotonic()
            self._journal_locked({"op": "client", "client_id": header["client_id"],
                                  "epoch": epoch, "client_index": client_index,
                                  "num_clients": num_clients})
            return {"type": "assignment", "epoch": epoch,
                    "fencing_epoch": self._fencing_epoch, "credit_scale": 1.0,
                    "assignments": assignments,
                    "workers": {wid: alive[wid]["address"] for wid in assignments}}

    def _handle_report_failure(self, header):
        worker_id = header["worker_id"]
        token = header.get("fencing_epoch")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            # A quarantined piece must not ride a takeover back into a plan.
            pieces = self._grantable_pieces_locked(int(p) for p in header.get("pieces", []))
            if token is not None and int(token) < self._fencing_epoch:
                # The client acts on a plan a later event invalidated: it
                # must re-fetch its assignment instead of taking over.
                self._recovery["stale_fencing_rejections"] += 1
                self._job_recovery_locked(DEFAULT_JOB)["stale_fencing_rejections"] += 1
                logger.warning("rejecting stale report_failure (token %s) from %s", token,
                               header.get("client_id"))
                return {"type": "stale_fencing", "fencing_epoch": self._fencing_epoch}
            if self._mark_worker_dead_locked(worker_id, "reported", job_id=DEFAULT_JOB):
                self._journal_locked({"op": "worker_dead", "worker_id": worker_id,
                                      "reason": "reported", "job_id": DEFAULT_JOB})
                self._bump_fencing_locked("report_failure")
            alive = self._serving_workers()
            if not alive:
                return {"type": "error", "error": (
                    f"worker {worker_id!r} reported dead and no live workers remain — the "
                    "service cannot make progress")}
            worker_ids = sorted(alive)
            assignments = self._partition(pieces, worker_ids)
            logger.warning("worker %s reported failed; reassigning %d pieces across %d "
                           "survivors", worker_id, len(pieces), len(worker_ids))
            if self.mode == "dynamic":
                # Takeovers are steals from the dead worker: journaled and
                # generation-stamped, so a replay and the client's dedup
                # agree on who serves what.
                client_id = header.get("client_id")
                pairs = {}
                for wid, ws_pieces in assignments.items():
                    pairs[wid] = []
                    for piece in ws_pieces:
                        self._generation += 1
                        self._apply_steal_locked(client_id, piece, worker_id, wid,
                                                 self._generation)
                        self._journal_locked({"op": "steal", "client_id": client_id,
                                              "piece": piece, "from": worker_id, "to": wid,
                                              "generation": self._generation})
                        pairs[wid].append([piece, self._generation])
                return {"type": "assignment", "fencing_epoch": self._fencing_epoch,
                        "generation": self._generation, "assignments": pairs,
                        "workers": {wid: alive[wid]["address"] for wid in pairs}}
            return {"type": "assignment", "fencing_epoch": self._fencing_epoch,
                    "assignments": assignments,
                    "workers": {wid: alive[wid]["address"] for wid in assignments}}

    def _handle_next_split(self, header):
        if self.mode != "fcfs":
            return {"type": "error", "error":
                    "next_split is an fcfs-mode request; static clients use get_assignment"}
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            if self._num_pieces is None:
                return {"type": "error", "error": "no workers have registered yet"}
            if self._fcfs_queue is None:
                self._fcfs_queue = deque(range(self._num_pieces))
            if self._quarantined and len(self._quarantined) >= self._num_pieces:
                # Nothing will ever be grantable again: end the stream
                # instead of spinning the refill-and-skip loop.
                return {"type": "end_of_stream", "epochs_completed": self._fcfs_epoch,
                        "reason": "all pieces quarantined"}
            while True:
                if not self._fcfs_queue:
                    # Epoch boundary: refill while epochs remain (None: forever).
                    if self.num_epochs is not None \
                            and self._fcfs_epoch + 1 >= self.num_epochs:
                        return {"type": "end_of_stream",
                                "epochs_completed": self._fcfs_epoch + 1}
                    self._fcfs_epoch += 1
                    self._fcfs_queue.extend(range(self._num_pieces))
                piece = self._fcfs_queue.popleft()
                if piece not in self._quarantined:
                    break  # quarantined splits are skipped
            self._journal_locked({"op": "next_split", "piece": piece,
                                  "epoch": self._fcfs_epoch})
            return {"type": "split", "piece": piece, "epoch": self._fcfs_epoch}

    # -- dynamic mode ------------------------------------------------------

    def _handle_dynamic_plan(self, header):
        """A client epoch's initial per-worker deques: its static shard
        round-robined across the serving workers, each share in the seed-tree
        order, every piece stamped with one fresh generation. A plan for a
        new epoch replaces the client's previous epoch state."""
        if self.mode != "dynamic":
            return {"type": "error", "error": "dynamic_plan is a dynamic-mode request"}
        client_index = int(header["client_index"])
        num_clients = int(header["num_clients"])
        epoch = int(header.get("epoch", 0))
        if not 0 <= client_index < num_clients:
            return {"type": "error", "error": f"client_index {client_index} out of range "
                                              f"[0, {num_clients})"}
        client_id = header["client_id"]
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            if self._num_pieces is None:
                return {"type": "error", "error": "no workers have registered yet"}
            alive = self._serving_workers()
            if not alive:
                return {"type": "error", "error": "no live workers"}
            # Sticky deques in canonical per-deque order, like static: cache
            # warmth survives shuffled epochs.
            client_pieces = self._grantable_pieces_locked(
                list(range(self._num_pieces))[client_index::num_clients])
            assignments = {wid: piece_order(self.shuffle_seed, epoch, pieces)
                           for wid, pieces in self._partition(client_pieces,
                                                              sorted(alive)).items()}
            self._generation += 1
            generation = self._generation
            owner = {piece: [wid, generation]
                     for wid, pieces in assignments.items() for piece in pieces}
            self._install_dynamic_plan_locked(client_id, epoch, owner, generation)
            self._install_client_locked(client_id, epoch, client_index, num_clients)
            self._client_heartbeats[client_id] = time.monotonic()
            self._journal_locked({"op": "client", "client_id": client_id, "epoch": epoch,
                                  "client_index": client_index, "num_clients": num_clients})
            self._journal_locked({"op": "dynamic_plan", "client_id": client_id,
                                  "epoch": epoch,
                                  "owner": [[piece, wid, gen]
                                            for piece, (wid, gen) in sorted(owner.items())],
                                  "generation": generation})
            return {"type": "plan", "epoch": epoch, "generation": generation,
                    "fencing_epoch": self._fencing_epoch, "credit_scale": 1.0,
                    "assignments": {wid: [[piece, generation] for piece in pieces]
                                    for wid, pieces in assignments.items()},
                    "workers": {wid: alive[wid]["address"] for wid in assignments}}

    def _handle_dynamic_sync(self, header):
        """The rebalance loop's tick: fold the client's progress into the
        ownership state, turn divergences into corrective deltas (a steal
        journaled before a restart that the client never saw), and plan
        fresh steals. The client reports absolute state (the whole done
        set, its whole ownership view), so a lost reply or a repeated
        request converges."""
        if self.mode != "dynamic":
            return {"type": "error", "error": "dynamic_sync is a dynamic-mode request"}
        client_id = header["client_id"]
        epoch = int(header.get("epoch", 0))
        done = set(int(p) for p in header.get("done", []))
        owned = {wid: set(int(p) for p in pieces)
                 for wid, pieces in (header.get("owned") or {}).items()}
        stealable = {wid: [int(p) for p in pieces]
                     for wid, pieces in (header.get("stealable") or {}).items()}
        rates = {wid: float(r) for wid, r in (header.get("rates") or {}).items()}
        failed = [(int(p), wid, int(gen), int(failed_gen))
                  for p, wid, gen, failed_gen in header.get("failed_steals", [])]
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            self._last_rates.update(rates)
            state = self._dyn.get(client_id)
            if state is None or state["epoch"] != epoch:
                # No plan for this epoch (restarted without a journal): the
                # client re-plans while its streams keep flowing.
                return {"type": "unknown_plan", "fencing_epoch": self._fencing_epoch}
            for piece, kept_wid, kept_gen, failed_gen in failed:
                # A revert holds only against the assignment the failed steal
                # made: a report retried past a newer grant is stale.
                cur = state["owner"].get(piece)
                if cur is None or int(cur[1]) != failed_gen:
                    continue
                self._apply_steal_failed_locked(client_id, piece, kept_wid, kept_gen)
                self._journal_locked({"op": "steal_failed", "client_id": client_id,
                                      "piece": piece, "worker_id": kept_wid,
                                      "generation": kept_gen})
            fresh_done = done - state["done"]
            if fresh_done:
                self._mark_dyn_dirty_locked()
                state["done"].update(fresh_done)
                self._journal_locked({"op": "dynamic_done", "client_id": client_id,
                                      "pieces": sorted(fresh_done)})
            alive = self._alive_workers()
            # Reconcile: a piece the dispatcher places on another worker than
            # the client's view is re-issued as a corrective steal, applied
            # through the same revoke-then-extend handshake.
            client_owner = {piece: wid for wid, pieces in owned.items() for piece in pieces}
            deltas = []
            for piece, (wid, gen) in sorted(state["owner"].items()):
                if piece in state["done"] or wid not in alive:
                    continue
                seen = client_owner.get(piece)
                if seen is not None and seen != wid:
                    deltas.append({"piece": piece, "from": seen, "to": wid, "generation": gen})
            # Plan over every live worker, not only those the client holds
            # streams to: a worker that joined mid-epoch is the drained
            # receiver stealing exists for (its address rides the reply).
            pending = {wid: 0 for wid in alive}
            for piece, (wid, gen) in state["owner"].items():
                if piece not in state["done"] and wid in pending:
                    pending[wid] += 1
            live_stealable = {
                wid: [p for p in pieces
                      if p not in state["done"] and state["owner"].get(p, (None,))[0] == wid]
                for wid, pieces in stealable.items() if wid in pending}
            serving_ids = set(self._serving_workers())
            moves = []
            draining_ids = sorted(wid for wid in alive if wid not in serving_ids)
            if draining_ids and serving_ids:
                # A worker out of the serving set (breaker-open) sheds its
                # whole unstarted backlog to the least-loaded serving peers.
                for dwid in draining_ids:
                    for piece in sorted(live_stealable.get(dwid, [])):
                        recv = min(serving_ids, key=lambda w: (pending[w], w))
                        moves.append((piece, dwid, recv))
                        pending[dwid] -= 1
                        pending[recv] += 1
                    live_stealable[dwid] = []
            moves.extend(plan_steals(pending, live_stealable, rates, receivers=serving_ids))
            for piece, from_wid, to_wid in moves:
                self._generation += 1
                self._apply_steal_locked(client_id, piece, from_wid, to_wid, self._generation)
                self._journal_locked({"op": "steal", "client_id": client_id, "piece": piece,
                                      "from": from_wid, "to": to_wid,
                                      "generation": self._generation})
                deltas.append({"piece": piece, "from": from_wid, "to": to_wid,
                               "generation": self._generation})
            if moves:
                logger.info("work stealing for %s: moved %d piece(s) (%s)", client_id,
                            len(moves), "; ".join(f"{p}:{f}->{t}" for p, f, t in moves[:8]))
            referenced = {d["to"] for d in deltas} | {d["from"] for d in deltas}
            return {"type": "deltas", "steals": deltas, "generation": self._generation,
                    "fencing_epoch": self._fencing_epoch, "credit_scale": 1.0,
                    # A steal target may be a worker the client has no
                    # stream to yet: its address lets the grant open one.
                    "workers": {wid: alive[wid]["address"] for wid in referenced
                                if wid in alive}}

    @staticmethod
    def _probe_timeout(header):
        try:
            timeout = float(header.get("timeout", 5.0))
        except (TypeError, ValueError):
            return 5.0
        return min(max(timeout, 0.1), PROBE_TIMEOUT_CAP_S)

    def _fan_out(self, request, timeout):
        """``request`` to every live worker concurrently: ``{worker_id:
        (reply, payload)}``, an unreachable worker as ``({"error": ...},
        None)``."""
        from concurrent.futures import ThreadPoolExecutor

        from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

        with self._lock:
            workers = {wid: tuple(w["address"]) for wid, w in self._alive_workers().items()}

        def probe(address):
            try:
                with FramedConnection.connect(address, timeout=timeout) as conn:
                    return conn.request(dict(request))
            except (ConnectionError, OSError) as exc:
                return {"error": f"unreachable: {exc}"}, None

        if not workers:
            return {}
        with ThreadPoolExecutor(max_workers=min(16, len(workers))) as pool:
            return dict(zip(workers, pool.map(probe, workers.values())))

    def _handle_worker_diagnostics(self, header):
        """Every live worker's ``diagnostics``, fetched concurrently (one
        round trip of latency); an unreachable worker is reported in place."""
        replies = self._fan_out({"type": "diagnostics"}, self._probe_timeout(header))
        out = {wid: (payload if "error" not in reply else reply)
               for wid, (reply, payload) in replies.items()}
        return {"type": "diagnostics", "workers": sorted(replies)}, out

    # -- fleet tracing ---------------------------------------------------------

    def _handle_trace(self, header):
        """``arm`` (this collector, and peers through heartbeat replies),
        ``collect`` (the dispatcher's ring and every peer buffer, topped up
        by one live pull from each worker) or ``disarm``. Runtime only: a
        restarted dispatcher comes back disarmed."""
        action = str(header.get("action", "collect"))
        if action == "arm":
            with self._lock:
                fresh = not self._trace_armed
                if fresh:
                    self._trace_armed = True
                    self._trace_buffers = {}
            if fresh:
                tracing.COLLECTOR.acquire()
                logger.info("fleet tracing ARMED — peers arm on their next heartbeat")
            return {"type": "ok", "armed": True, "fresh": fresh}
        if action == "disarm":
            with self._lock:
                was, self._trace_armed = self._trace_armed, False
            if was:
                tracing.COLLECTOR.release()
                logger.info("fleet tracing disarmed")
            return {"type": "ok", "armed": False}
        if action != "collect":
            return {"type": "error", "error": f"unknown trace action {action!r}"}
        with self._lock:
            buffers = {peer: {"events": list(buf["events"]), "dropped": buf["dropped"],
                              "offset_us": buf.get("offset_us"),
                              "min_rtt_us": buf.get("min_rtt_us")}
                       for peer, buf in self._trace_buffers.items()}
            armed = self._trace_armed
        # A worker ships and clears on a pull, so pushes and pulls never
        # hand the same event over twice.
        for wid, (reply, _) in self._fan_out({"type": "trace"},
                                             self._probe_timeout(header)).items():
            if not isinstance(reply, dict) or "error" in reply:
                continue
            buf = buffers.setdefault(wid, {"events": [], "dropped": 0, "offset_us": None,
                                           "min_rtt_us": None})
            buf["events"].extend(reply.get("events") or [])
            buf["dropped"] += int(reply.get("dropped") or 0)
            for key in ("offset_us", "min_rtt_us"):
                if reply.get(key) is not None:
                    buf[key] = reply[key]
        local = tracing.COLLECTOR.events()
        TRACE_SHIP_EVENTS.labels("collect").inc(
            len(local) + sum(len(b["events"]) for b in buffers.values()))
        return ({"type": "trace", "armed": armed},
                {"local": {"events": local, "dropped": tracing.COLLECTOR.dropped},
                 "peers": buffers})

    def _handle_trace_push(self, header):
        """An armed peer shipping its span ring; bounded per peer by the
        collector's ring budget, the overflow counted as ``dropped``."""
        peer = str(header.get("peer") or "?")
        events = header.get("events") or []
        offset_us = header.get("offset_us")
        with self._lock:
            if not self._trace_armed:
                return {"type": "ok", "trace": False, "accepted": 0}
            buf = self._trace_buffers.setdefault(
                peer, {"events": [], "dropped": 0, "offset_us": None, "min_rtt_us": None})
            accepted = events[:max(0, tracing.DEFAULT_MAX_EVENTS - len(buf["events"]))]
            buf["events"].extend(accepted)
            buf["dropped"] += int(header.get("dropped") or 0) + len(events) - len(accepted)
            if offset_us is not None:
                buf["offset_us"] = float(offset_us)
                CLOCK_OFFSET_US.labels(peer).set(float(offset_us))
            if header.get("min_rtt_us") is not None:
                buf["min_rtt_us"] = float(header["min_rtt_us"])
        TRACE_SHIP_EVENTS.labels("push").inc(len(accepted))
        return {"type": "ok", "trace": True, "accepted": len(accepted)}

    def _handle_stage_profile(self, header):
        """A diagnosed per-stage profile: journaled, and the last few kept
        for ``status``."""
        profile = header.get("profile")
        if not isinstance(profile, dict):
            return {"type": "error", "error": "stage_profile requires a profile dict"}
        entry = {"profile": profile, "coverage_pct": header.get("coverage_pct"),
                 "source": str(header.get("source", "diagnose"))}
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            self._stage_profiles.append(entry)
            del self._stage_profiles[:-STAGE_PROFILES_KEPT]
            self._journal_locked(dict(entry, op="stage_profile"))
            kept = len(self._stage_profiles)
        return {"type": "ok", "kept": kept}

    def _handle_status(self, header):
        now = time.monotonic()
        with self._lock:
            alive = sorted(wid for wid, w in self._workers.items() if w["alive"])
            return {
                "type": "status",
                "mode": self.mode,
                "num_epochs": self.num_epochs,
                "num_pieces": self._num_pieces,
                "shuffle_seed": self.shuffle_seed,
                "fencing_epoch": self._fencing_epoch,
                "degraded": self._degraded,
                "quarantined": {str(p): dict(info)
                                for p, info in sorted(self._quarantined.items())},
                "client_watermarks": {
                    cid: {"epoch": entry["epoch"],
                          "watermarks": {str(p): n for p, n in entry["watermarks"].items()}}
                    for cid, entry in self._client_watermarks.items()},
                "recovery": dict(self._recovery),
                "journal": self._journal.stats if self._journal is not None else None,
                "workers": {
                    wid: {"address": w["address"], "alive": w["alive"],
                          "state": w.get("state", "serving"),
                          "metrics_port": w.get("metrics_port"), "cache_fleet": False,
                          "lease_expires_in_s": (round(self._worker_leases[wid] - now, 3)
                                                 if wid in self._worker_leases else None)}
                    for wid, w in self._workers.items()},
                "observability": {"trace_armed": self._trace_armed,
                                  "trace_peers": sorted(self._trace_buffers),
                                  "metrics_address": self.metrics_address,
                                  "stage_profiles": list(self._stage_profiles)},
                "metrics_address": self.metrics_address,
                "clients": {cid: dict(c) for cid, c in self._clients.items()},
                "fleet": {
                    "workers_by_state": {"serving": alive, "standby": [], "draining": []},
                    "autoscale": {"admit": 0, "drain": 0, "retire": 0},
                    "autoscaler_armed": False,
                    "breaker_open": {wid: dict(info)
                                     for wid, info in sorted(self._breaker_open.items())},
                    "brownout": {"level": self._brownout_level,
                                 "counts": dict(self._brownout_counts),
                                 "reason": self._brownout_reason,
                                 "armed": self._brownout is not None},
                    "cache_peers": [], "cache_handoffs": [], "fleet_plans": []},
                "jobs": {
                    jid: {"weight": job["weight"], "quota": job["quota"],
                          "epoch": job["epoch"],
                          "fencing_epoch": self._fencing_epoch + job["fencing_offset"],
                          "fair_share": self._default_job_share_locked(),
                          "clients": sorted(self._clients),
                          "recovery": dict(self._job_recovery.get(jid, {})),
                          **(self._dynamic_per_job_locked().get(jid, {})
                             if self.mode == "dynamic" else {})}
                    for jid, job in self._jobs.items()},
                "fcfs_epoch": self._fcfs_epoch,
                "fcfs_remaining": (len(self._fcfs_queue)
                                   if self._fcfs_queue is not None else None),
                "dynamic": (self._dynamic_status_locked() if self.mode == "dynamic"
                            else None),
                "corpora": {"": self._num_pieces} if self._num_pieces is not None else {},
                "mixtures": {},
            }
