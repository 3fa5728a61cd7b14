"""The dispatcher: the data service's control plane (the port's own copy of
``petastorm_tpu/service/dispatcher.py``: static, fcfs and dynamic sharding
with the journal, breakers, brownout, quarantine and fleet tracing).

It owns the split plan and nothing else: no sample bytes flow through it.
Workers register their address and the dataset's row-group count; clients
ask which pieces to stream from which workers. Every request is one framed
message with one framed reply (``type`` names the request):

- ``register_worker`` ``{worker_id, host, port, num_pieces[, re_register,
  standby, cache_fleet]}`` → ``ok`` (a piece count other than the
  registered workers' is refused; a ``standby`` worker is pool capacity
  that receives nothing until admitted; a ``cache_fleet`` worker joins the
  fleet cache tier and the reply seeds its ``cache_peers``);
- ``worker_heartbeat`` ``{worker_id[, credit_wait_s]}`` → ``ok`` (lease
  renewed; the reply carries the worker's lifecycle state, the fleet cache
  tier's serving ``cache_peers``, the brownout level, the clock-alignment
  beacon ``dispatcher_time_us`` and whether fleet tracing is armed) or
  ``unknown_worker`` (re-register);
- ``client_heartbeat`` ``{client_id[, job_id, epoch, watermarks,
  ready_saturation]}`` → ``ok`` with the job's fencing epoch, its
  ``credit_scale`` and the recovery counters (a client resyncs when the
  epoch moved past its own);
- ``register_job`` ``{job_id[, weight, quota]}`` and ``end_job``
  ``{job_id}`` → ``ok``: the fleet's jobs (:mod:`~petastorm_tpu_torch.
  service.fleet`), each with its own fencing epoch and a weighted max-min
  fair share of the serving workers, which scales its streams' credit
  windows (refused under fcfs, which has no per-job assignment);
- ``cache_handoff`` ``{worker_id, entries, bytes, peers, errors, torn}``
  → ``ok``: a drained worker's warm hand-off summary, journaled;
- ``list_workers`` → ``workers`` (serving workers and the service config);
- ``get_assignment`` ``{client_id, client_index, num_clients, epoch[,
  job_id]}``
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

Workers are ``serving``, ``standby`` or ``draining``; ``autoscale=`` arms
the fleet autoscaler (:class:`~petastorm_tpu_torch.service.fleet.
AutoscaleController`), and :meth:`Dispatcher.admit_worker`,
:meth:`Dispatcher.drain_worker` and :meth:`Dispatcher.retire_worker` move a
worker by hand; every move is journaled. A drained worker's unstarted
pieces are stolen away to serving peers.

Multi-corpus fleets: a worker registers with a ``corpus`` name, and each
corpus has its own piece universe (``""`` is the default corpus, the
single-dataset one). Assignments, fcfs and dynamic grants, takeovers,
steals and quarantine are scoped to the requesting client's corpus: corpus
A's piece 3 is not corpus B's. ``set_mixture_weights`` journals an entry
of a job's mixture weight log (a ``mixture_weights`` record; a retried
request with the same token answers for the journaled entry) and
``get_mixture`` returns the log, which
:class:`~petastorm_tpu_torch.service.mixture.MixedBatchSource` applies at
pass boundaries.
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
from petastorm_tpu_torch.service.fleet import (
    DEFAULT_JOB,
    AutoscaleConfig,
    AutoscaleController,
    credit_scales,
    plan_fair_shares,
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
    FLEET_AUTOSCALE_DECISIONS,
    FLEET_BROWNOUT_LEVEL,
    FLEET_JOB_BACKLOG,
    FLEET_JOB_FAIR_SHARE,
    FLEET_JOB_FENCING_EPOCH,
    FLEET_JOBS,
    FLEET_MODEL_DECISIONS,
    FLEET_WORKERS,
    QUARANTINE_PIECES,
    QUARANTINE_REPORTS,
    TRACE_SHIP_EVENTS,
)

logger = logging.getLogger(__name__)

MODES = ("static", "fcfs", "dynamic")

#: A worker missing heartbeats this long is evicted.
DEFAULT_LEASE_TIMEOUT_S = 30.0

#: Cap on the per-probe ``timeout`` of ``worker_diagnostics`` and ``trace``.
PROBE_TIMEOUT_CAP_S = 30.0

#: Journaled ``stage_profile`` records ``status`` keeps in memory.
STAGE_PROFILES_KEPT = 8

#: Journaled drain hand-off summaries and model-planner decisions kept (in
#: the snapshot too, so a compaction never loses the audit trail).
CACHE_HANDOFFS_KEPT = 8
FLEET_PLANS_KEPT = 32

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
    :param autoscale: arm the fleet autoscaler: ``True``, a dict of
        :class:`~petastorm_tpu_torch.service.fleet.AutoscaleConfig`
        arguments or a config. Its thread (``fleet-autoscale-controller``)
        admits standby workers when the backlog piles up and drains and
        retires them when the fleet idles, journaling each decision.
        ``None``: the states exist, but only :meth:`admit_worker` and its
        siblings move a worker.
    """

    def __init__(self, host="127.0.0.1", port=0, mode="static", num_epochs=1,
                 journal_dir=None, lease_timeout_s=DEFAULT_LEASE_TIMEOUT_S,
                 journal_compact_every=256, journal_fsync=False, max_frame_bytes=None,
                 shuffle_seed=None, autoscale=None, brownout=None, breaker_cooldown_s=10.0):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError("num_epochs must be a positive integer or None")
        self.mode = mode
        self.num_epochs = num_epochs
        self.shuffle_seed = int(shuffle_seed) if shuffle_seed is not None else None
        self.journal_dir = journal_dir
        self.lease_timeout_s = lease_timeout_s or None
        self._max_frame_bytes = max_frame_bytes
        self._lock = threading.Lock()
        self._workers = {}  # worker_id -> {address, num_pieces, alive, state[, cache_fleet]}
        self._clients = {}  # client_id -> {epoch, client_index, num_clients[, job_id]}
        # job_id -> {"weight", "quota", "fencing_offset", "epoch"}. The
        # default job materializes on a client's first touch and is never
        # journaled as a registration. A job's fencing epoch is the global
        # one plus its offset: a fleet-wide event moves every job, a job's
        # own restart moves only its offset.
        self._jobs = {}
        self._job_recovery = {}  # job_id -> its share of the recovery counters
        # Ending a job raises this floor past its offset, and a later job of
        # the same name starts there: a stale client of the ended job can
        # never pass the recreated job's fencing check.
        self._job_fence_floor = 0
        self._autoscale_counts = {"admit": 0, "drain": 0, "retire": 0}
        # client_id -> {"epoch", "watermarks": {piece: next ordinal}}, from
        # client heartbeats, journaled at piece granularity.
        self._client_watermarks = {}
        self._num_pieces = None
        # corpus -> its row-group count ("" = the default corpus, mirrored
        # into _num_pieces, which the fcfs paths read).
        self._corpus_pieces = {}
        # job_id -> {"seq", "entries": [{"seq", "weights"[,
        # "effective_epoch"]}], "last_token"}: the journaled weight logs.
        self._mixtures = {}
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
        # Quarantined pieces: (corpus, piece) -> report info, journaled; and
        # the default corpus's pieces of it (the fcfs paths' view).
        self._quarantined = {}
        self._quarantined_default = set()
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
        # The fleet cache tier's drain hand-off summaries and the model
        # planner's decisions: bounded heads of their journal records.
        self._cache_handoffs = []
        self._fleet_plans = []
        #: The dispatcher's metrics endpoint, when the CLI serves one.
        self.metrics_address = None
        self._lease_thread = None
        self._autoscaler = (AutoscaleController(self, AutoscaleConfig.coerce(autoscale))
                            if autoscale else None)
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
        if self._autoscaler is not None:
            self._autoscaler.start()
        return self

    @property
    def address(self):
        """``(host, port)`` clients and workers connect to."""
        return self._server.address

    def stop(self):
        # The autoscaler journals: it stops before the handlers drain.
        if self._autoscaler is not None:
            self._autoscaler.stop()
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
            "corpus_pieces": dict(self._corpus_pieces),
            "mixtures": {jid: {"seq": m["seq"], "entries": [dict(e) for e in m["entries"]],
                               "last_token": m.get("last_token")}
                         for jid, m in self._mixtures.items()},
            "workers": {wid: dict(w) for wid, w in self._workers.items()},
            "clients": {cid: dict(c) for cid, c in self._clients.items()},
            "jobs": {jid: dict(j) for jid, j in self._jobs.items()},
            "job_recovery": {jid: dict(r) for jid, r in self._job_recovery.items()},
            "job_fence_floor": self._job_fence_floor,
            "autoscale": dict(self._autoscale_counts),
            "cache_handoffs": [dict(h) for h in self._cache_handoffs],
            "fleet_plans": [dict(p) for p in self._fleet_plans],
            "client_watermarks": {
                cid: {"epoch": entry["epoch"],
                      "watermarks": {str(p): n for p, n in entry["watermarks"].items()}}
                for cid, entry in self._client_watermarks.items()},
            "fcfs_epoch": self._fcfs_epoch,
            "fcfs_queue": list(self._fcfs_queue) if self._fcfs_queue is not None else None,
            "fencing_epoch": self._fencing_epoch,
            "recovery": dict(self._recovery),
            # "piece" for the default corpus, else "corpus:piece"; the info
            # carries the corpus too, which is what a load trusts.
            "quarantined": {(f"{c}:{p}" if c else str(p)): dict(info)
                            for (c, p), info in self._quarantined.items()},
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
        self._num_pieces = state.get("num_pieces")
        self._corpus_pieces = {str(c): int(n)
                               for c, n in (state.get("corpus_pieces") or {}).items()}
        if self._num_pieces is not None:
            self._corpus_pieces.setdefault("", self._num_pieces)
        self._mixtures = {
            str(jid): {"seq": int(m.get("seq", 0)),
                       "entries": [dict(e) for e in m.get("entries", ())],
                       "last_token": m.get("last_token")}
            for jid, m in (state.get("mixtures") or {}).items()}
        self._client_watermarks = {
            cid: {"epoch": int(entry.get("epoch", 0)),
                  "watermarks": {int(p): int(n)
                                 for p, n in (entry.get("watermarks") or {}).items()}}
            for cid, entry in (state.get("client_watermarks") or {}).items()}
        self._workers = {wid: dict(w) for wid, w in state.get("workers", {}).items()}
        for worker in self._workers.values():
            worker.setdefault("state", "serving")
        self._clients = {cid: dict(c) for cid, c in state.get("clients", {}).items()}
        self._jobs = {jid: dict(j) for jid, j in (state.get("jobs") or {}).items()}
        self._job_recovery = {jid: dict(r)
                              for jid, r in (state.get("job_recovery") or {}).items()}
        self._job_fence_floor = int(state.get("job_fence_floor", 0))
        autoscale = state.get("autoscale") or {}
        for key in self._autoscale_counts:
            self._autoscale_counts[key] = int(autoscale.get(key, 0))
        self._cache_handoffs = []
        for entry in state.get("cache_handoffs") or ():
            self._install_cache_handoff_locked(entry)
        self._fleet_plans = []
        for entry in state.get("fleet_plans") or ():
            self._install_fleet_plan_locked(entry)
        self._fcfs_epoch = int(state.get("fcfs_epoch", 0))
        queue = state.get("fcfs_queue")
        self._fcfs_queue = deque(queue) if queue is not None else None
        self._fencing_epoch = int(state.get("fencing_epoch", 0))
        recovered = state.get("recovery", {})
        for key in self._recovery:
            self._recovery[key] = int(recovered.get(key, 0))
        self._quarantined = {
            (str(info.get("corpus", "") or ""), int(str(key).rsplit(":", 1)[-1])): dict(info)
            for key, info in (state.get("quarantined") or {}).items()}
        self._quarantined_default = {p for (c, p) in self._quarantined if not c}
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

    def _apply_record_locked(self, record):
        """Replay one WAL record through the mutations the live handlers
        perform (without journaling: the record is the journal)."""
        op = record.get("op")
        if op == "register_worker":
            self._install_worker_locked(record["worker_id"],
                                        [record["host"], int(record["port"])],
                                        int(record["num_pieces"]),
                                        re_register=bool(record.get("re_register")),
                                        standby=bool(record.get("standby")),
                                        corpus=record.get("corpus", ""),
                                        metrics_port=record.get("metrics_port"),
                                        cache_fleet=bool(record.get("cache_fleet")))
        elif op == "worker_dead":
            self._mark_worker_dead_locked(record["worker_id"],
                                          record.get("reason", "reported"),
                                          job_id=record.get("job_id"))
        elif op == "client":
            self._install_client_locked(record["client_id"], int(record["epoch"]),
                                        int(record["client_index"]),
                                        int(record["num_clients"]), record.get("job_id"),
                                        corpus=record.get("corpus", ""))
        elif op == "job_register":
            self._install_job_locked(record["job_id"], float(record.get("weight", 1.0)),
                                     record.get("quota"), restart=bool(record.get("restart")))
        elif op == "job_end":
            self._remove_job_locked(record["job_id"])
        elif op == "autoscale":
            self._apply_autoscale_locked(record["action"], record["worker_id"])
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
            info = {"worker_id": record.get("worker_id"), "client_id": record.get("client_id"),
                    "error": record.get("error"), "epoch": int(record.get("epoch", 0))}
            if record.get("corpus"):
                info["corpus"] = record["corpus"]
            self._quarantine_piece_locked(int(record["piece"]), info)
        elif op == "mixture_weights":
            # The journal stamps its own ``seq`` on every record, over the
            # entry's; the entry's is the job's last one plus one, as the
            # live handler numbers it. (The JAX dispatcher replays the
            # journal's seq as the entry's.)
            mixture = self._mixtures.get(str(record["job_id"]))
            self._install_mixture_locked(record["job_id"], (mixture["seq"] if mixture else 0) + 1,
                                         dict(record["weights"]),
                                         record.get("effective_epoch"),
                                         token=record.get("token"))
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
        elif op == "cache_handoff":
            self._install_cache_handoff_locked(record)
        elif op == "fleet_plan":
            self._install_fleet_plan_locked(record)
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

    def _install_cache_handoff_locked(self, record):
        """A drain hand-off summary into the bounded head (live and replay)."""
        self._cache_handoffs.append({
            "worker_id": record.get("worker_id"),
            "entries": int(record.get("entries", 0)),
            "bytes": int(record.get("bytes", 0)),
            "peers": {str(p): int(n) for p, n in (record.get("peers") or {}).items()},
            "errors": int(record.get("errors", 0)),
            "torn": bool(record.get("torn"))})
        del self._cache_handoffs[:-CACHE_HANDOFFS_KEPT]

    def _install_fleet_plan_locked(self, record):
        """A model-planner decision into the bounded head (live and replay):
        the record less its journal framing (``op``, ``seq``), keys sorted,
        so a replayed head equals the live one."""
        self._fleet_plans.append({k: record[k] for k in sorted(record)
                                  if k not in ("op", "seq")})
        del self._fleet_plans[:-FLEET_PLANS_KEPT]

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
        done in the dynamic books of every client of its corpus, so neither
        the steal planner nor reconciliation grants it again. A duplicate
        report is a no-op."""
        corpus = str(info.get("corpus", "") or "")
        if (corpus, piece) in self._quarantined:
            return False
        self._quarantined[(corpus, piece)] = dict(info)
        if not corpus:
            self._quarantined_default.add(piece)
        self._recovery["pieces_quarantined"] += 1
        for cid, state in self._dyn.items():
            # Piece indices are per dataset: another corpus's piece of the
            # same index keeps serving.
            if self._clients.get(cid, {}).get("corpus", "") != corpus:
                continue
            if piece in state["owner"] and piece not in state["done"]:
                state["done"].add(piece)
                self._mark_dyn_dirty_locked()
        return True

    def _grantable_pieces_locked(self, pieces, corpus=""):
        """``pieces`` less the corpus's quarantined ones: the one exclusion
        rule of every grant (assignment, takeover re-partition, fcfs split)."""
        if not self._quarantined:
            return list(pieces)
        return [p for p in pieces if (corpus, p) not in self._quarantined]

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
            if header.get("corpus"):
                info["corpus"] = str(header["corpus"])
            fresh = self._quarantine_piece_locked(piece, info)
            if fresh:
                self._journal_locked(dict(info, op="quarantine", piece=piece))
            corpus = info.get("corpus", "")
            quarantined = sorted(p for (c, p) in self._quarantined if c == corpus)
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
                               standby=False, corpus="", metrics_port=None, cache_fleet=False):
        known = worker_id in self._workers
        # A re-registration keeps the state the autoscaler gave the worker;
        # a new worker starts where its standby flag says.
        prev_state = self._workers[worker_id].get("state") if known else None
        corpus = str(corpus or "")
        # Each corpus's workers agree on their dataset's piece count; the
        # default corpus also feeds the single-dataset paths.
        self._corpus_pieces[corpus] = num_pieces
        if not corpus:
            self._num_pieces = num_pieces
        self._workers[worker_id] = {"address": list(address), "num_pieces": num_pieces,
                                    "alive": True,
                                    "state": prev_state or ("standby" if standby else "serving")}
        if corpus:
            self._workers[worker_id]["corpus"] = corpus
        if metrics_port is not None:
            self._workers[worker_id]["metrics_port"] = int(metrics_port)
        if cache_fleet:
            self._workers[worker_id]["cache_fleet"] = True
        if known or re_register:
            self._recovery["re_registrations"] += 1
        self._worker_leases[worker_id] = time.monotonic() + (self.lease_timeout_s or 0.0)
        return known

    def _job_recovery_locked(self, job_id):
        return self._job_recovery.setdefault(
            job_id, {"failures_reported": 0, "stale_fencing_rejections": 0,
                     "fencing_bumps": 0})

    # -- jobs -----------------------------------------------------------------

    def _install_job_locked(self, job_id, weight=1.0, quota=None, restart=False):
        """Create a job, or update a live one (live and replay); a restart
        bumps only that job's fencing offset, so its stale clients resync
        and no other job's do. True when the job existed."""
        job = self._jobs.get(job_id)
        if job is None:
            self._jobs[job_id] = {"weight": float(weight),
                                  "quota": float(quota) if quota is not None else None,
                                  "fencing_offset": self._job_fence_floor, "epoch": 0}
            return False
        job["weight"] = float(weight)
        job["quota"] = float(quota) if quota is not None else None
        if restart:
            job["fencing_offset"] += 1
            self._job_recovery_locked(job_id)["fencing_bumps"] += 1
        self._mark_dyn_dirty_locked()  # the per-job gauges follow the restart
        return True

    def _ensure_job_locked(self, job_id):
        """A job a client names (the default one included) materializes on
        first touch with weight 1.0 and no quota."""
        if job_id not in self._jobs:
            self._install_job_locked(job_id)
        return self._jobs[job_id]

    def _remove_job_locked(self, job_id):
        """End a job (live and replay): its clients, their watermarks and
        dynamic books go, the fence floor passes its offset, and its gauge
        series are dropped."""
        job = self._jobs.pop(job_id, None)
        self._mixtures.pop(job_id, None)
        if job is None:
            return False
        self._job_fence_floor = max(self._job_fence_floor, job["fencing_offset"] + 1)
        self._job_recovery.pop(job_id, None)
        self._mark_dyn_dirty_locked()
        for family in (FLEET_JOB_FENCING_EPOCH, FLEET_JOB_FAIR_SHARE, FLEET_JOB_BACKLOG):
            family.remove(job_id)
        for cid in [cid for cid, c in self._clients.items()
                    if c.get("job_id", DEFAULT_JOB) == job_id]:
            self._clients.pop(cid, None)
            self._client_heartbeats.pop(cid, None)
            self._client_watermarks.pop(cid, None)
            self._dyn.pop(cid, None)
        return True

    def _install_mixture_locked(self, job_id, seq, weights, effective_epoch, token=None):
        """One mutation site (live and replay) for a mixture weight-log
        entry: appended in seq order, a stale seq is a no-op. ``token`` is
        the request's idempotency id, kept so a retried request whose reply
        was lost answers for its entry, after a restart too."""
        mixture = self._mixtures.setdefault(str(job_id),
                                            {"seq": 0, "entries": [], "last_token": None})
        if seq <= mixture["seq"]:
            return False
        entry = {"seq": int(seq), "weights": {str(n): float(w) for n, w in weights.items()}}
        if effective_epoch is not None:
            entry["effective_epoch"] = int(effective_epoch)
        mixture["entries"].append(entry)
        mixture["seq"] = int(seq)
        mixture["last_token"] = token
        return True

    def _job_fencing_locked(self, job_id):
        """The job's fencing epoch: the global one plus the job's offset."""
        job = self._jobs.get(job_id)
        return self._fencing_epoch + (job["fencing_offset"] if job is not None else 0)

    def _client_job_locked(self, client_id, header=None):
        """A request's job: its ``job_id``, else its client's, else the
        default."""
        if header is not None and header.get("job_id"):
            return str(header["job_id"])
        client = self._clients.get(client_id)
        return client.get("job_id", DEFAULT_JOB) if client is not None else DEFAULT_JOB

    def _install_client_locked(self, client_id, epoch, client_index, num_clients,
                               job_id=None, corpus=""):
        entry = {"epoch": int(epoch), "client_index": int(client_index),
                 "num_clients": int(num_clients)}
        if job_id is not None and job_id != DEFAULT_JOB:
            entry["job_id"] = str(job_id)
        if corpus:
            entry["corpus"] = str(corpus)
        if self._clients.get(client_id) != entry:
            self._per_job_memo = None
        self._clients[client_id] = entry
        job = self._ensure_job_locked(job_id or DEFAULT_JOB)
        job["epoch"] = max(job["epoch"], int(epoch))

    def _job_shares_locked(self):
        """Each job's weighted max-min fair share of the serving workers
        (:func:`~petastorm_tpu_torch.service.fleet.plan_fair_shares`). A
        job's demand is its dynamic backlog, else the whole capacity while
        it has clients, else nothing (an idle registration shrinks no
        other job's window)."""
        capacity = float(max(1, len(self._serving_workers())))
        per_job = self._dynamic_per_job_locked() if self.mode == "dynamic" else {}
        with_clients = {c.get("job_id", DEFAULT_JOB) for c in self._clients.values()}
        demands = {}
        for jid in self._jobs:
            backlog = per_job.get(jid, {}).get("backlog", 0)
            demands[jid] = (float(backlog) if backlog
                            else capacity if jid in with_clients else 0.0)
        if not demands:
            return {}
        return plan_fair_shares(capacity, demands,
                                weights={jid: j["weight"] for jid, j in self._jobs.items()},
                                quotas={jid: j["quota"] for jid, j in self._jobs.items()})

    def _credit_scale_locked(self, job_id):
        """The job's flow-control scale from the fair shares (1.0 for the
        largest share), with the brownout's shedding of the smaller ones;
        1.0 at once with one job (no walk of the owner maps)."""
        if len(self._jobs) <= 1:
            return 1.0
        shares = self._job_shares_locked()
        if len(shares) <= 1:
            return 1.0
        return round(credit_scales(shares, brownout_level=self._brownout_level)
                     .get(job_id, 1.0), 4)

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
        """The same books keyed by each client's job (steals stay inside a
        job: the planner runs per client), memoized until the next dynamic
        mutation. Read-only for callers."""
        if self._per_job_memo is not None:
            return self._per_job_memo
        per_job = {}
        for cid, state in self._dyn.items():
            entry = per_job.setdefault(self._client_job_locked(cid), {
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
            "clients": {cid: {"epoch": state["epoch"],
                              "job_id": self._client_job_locked(cid),
                              "pieces_done": len(state["done"]),
                              "pieces_total": len(state["owner"])}
                        for cid, state in self._dyn.items()},
        }

    def fleet_signals(self):
        """The autoscaler's input: worker lifecycle states, the live backlog
        and the last delivery rates (the steal planner's), and the journaled
        stage profiles (the model planner's prior). ``backlog_known`` is
        False outside dynamic mode, which tracks no per-worker progress:
        zero backlog there is not an idle fleet."""
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

    def _apply_autoscale_locked(self, action, worker_id):
        """The lifecycle state machine (live and replay): admit a standby or
        draining worker, drain a serving one, retire a draining one to
        standby. An invalid move (gone, wrong state, the last serving
        worker's drain) is a no-op, so a replay converges. True when it
        applied."""
        worker = self._workers.get(worker_id)
        if worker is None or not worker["alive"]:
            return False
        state = worker.get("state", "serving")
        if action == "admit" and state in ("standby", "draining"):
            worker["state"] = "serving"
        elif action == "drain" and state == "serving":
            # A constant floor of one, checked when the move applies: the
            # autoscaler, chaos and an operator may drain concurrently, and
            # a replay must apply the same way under any configuration.
            serving = sum(1 for w in self._workers.values()
                          if w["alive"] and w.get("state", "serving") == "serving")
            if serving <= 1:
                return False
            worker["state"] = "draining"
        elif action == "retire" and state == "draining":
            worker["state"] = "standby"
        else:
            return False
        self._autoscale_counts[action] += 1
        self._mark_dyn_dirty_locked()
        self._trace_instant("dispatcher.autoscale", action=action, worker=worker_id)
        return True

    def apply_autoscale(self, action, worker_id, reason=None):
        """Apply one lifecycle move, journaled (the autoscaler's and the
        chaos harness's entry point). An admitted worker takes part from the
        next plan or steal round; a drained one gets no new grants while its
        live streams finish, and its unstarted pieces are stolen away."""
        with self._lock:
            if self._check_writable_locked() is not None:
                return False
            applied = self._apply_autoscale_locked(action, worker_id)
            if applied:
                self._journal_locked({"op": "autoscale", "action": action,
                                      "worker_id": worker_id})
                FLEET_AUTOSCALE_DECISIONS.labels(action).inc()
                self._sync_telemetry_locked()
        if applied:
            logger.info("autoscale: %s worker %s (%s)", action, worker_id, reason or "operator")
        return applied

    def record_fleet_plan(self, decision):
        """Journal one model-planner decision (before its action applies):
        the model, its prediction and what-if error, kept in ``status``."""
        record = {"op": "fleet_plan"}
        for key, value in decision.items():
            record[str(key)] = value
        with self._lock:
            if self._check_writable_locked() is not None:
                return False
            self._install_fleet_plan_locked(record)
            self._journal_locked(record)
        FLEET_MODEL_DECISIONS.labels(str(decision.get("action", "hold"))).inc()
        return True

    def cache_handoffs(self):
        """The journaled warm hand-off summaries, newest last."""
        with self._lock:
            return [dict(h) for h in self._cache_handoffs]

    def admit_worker(self, worker_id, reason="manual"):
        """Move a standby (or draining) worker into serving."""
        return self.apply_autoscale("admit", worker_id, reason=reason)

    def drain_worker(self, worker_id, reason="manual"):
        """Stop granting to a serving worker: its live streams finish and its
        unstarted pieces are stolen away to serving peers."""
        return self.apply_autoscale("drain", worker_id, reason=reason)

    def retire_worker(self, worker_id, reason="manual"):
        """Return a drained worker to the standby pool."""
        return self.apply_autoscale("retire", worker_id, reason=reason)

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
        handler = getattr(self, f"_handle_{kind}", None)
        if handler is None:
            DISPATCHER_REQUESTS.labels("unknown").inc()
            return {"type": "error", "error": f"unknown request {kind!r}"}
        DISPATCHER_REQUESTS.labels(kind).inc()
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
        for state in ("serving", "standby", "draining"):
            FLEET_WORKERS.labels(state).set(sum(
                1 for w in self._workers.values()
                if w["alive"] and w.get("state", "serving") == state))
        FLEET_JOBS.set(len(self._jobs))
        if self._jobs and (self.mode != "dynamic" or self._dyn_dirty):
            # The per-job books walk every owner map: under dynamic sharding
            # only after a request that changed them.
            shares = self._job_shares_locked()
            per_job = self._dynamic_per_job_locked() if self.mode == "dynamic" else {}
            for jid in self._jobs:
                FLEET_JOB_FENCING_EPOCH.labels(jid).set(self._job_fencing_locked(jid))
                FLEET_JOB_FAIR_SHARE.labels(jid).set(round(shares.get(jid, 0.0), 4))
                FLEET_JOB_BACKLOG.labels(jid).set(per_job.get(jid, {}).get("backlog", 0))
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
        standby = bool(header.get("standby"))
        cache_fleet = bool(header.get("cache_fleet"))
        corpus = str(header.get("corpus") or "")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            known_pieces = self._corpus_pieces.get(corpus)
            if known_pieces is not None and known_pieces != num_pieces:
                return {"type": "error", "error": (
                    f"worker {worker_id!r} enumerated {num_pieces} row-group pieces but "
                    f"corpus {corpus or 'default'!r}'s service plan has {known_pieces} — "
                    "all of a corpus's workers must read the same dataset with the same "
                    "planning config")}
            metrics_port = header.get("metrics_port")
            self._install_worker_locked(worker_id, [header["host"], int(header["port"])],
                                        num_pieces, re_register=re_register, standby=standby,
                                        corpus=corpus, metrics_port=metrics_port,
                                        cache_fleet=cache_fleet)
            record = {"op": "register_worker", "worker_id": worker_id,
                      "host": header["host"], "port": int(header["port"]),
                      "num_pieces": num_pieces, "re_register": re_register,
                      "standby": standby}
            if corpus:
                record["corpus"] = corpus
            if metrics_port is not None:
                record["metrics_port"] = int(metrics_port)
            if cache_fleet:
                record["cache_fleet"] = True
            self._journal_locked(record)
            fencing = self._fencing_epoch
            state = self._workers[worker_id]["state"]
            # The registrant's placement ring at once: its first heartbeat
            # is an interval away.
            cache_peers = self._cache_peers_locked() if cache_fleet else None
        logger.info("worker %s %sregistered at %s:%s (%d pieces, %s)", worker_id,
                    "re-" if re_register else "", header["host"], header["port"],
                    num_pieces, state)
        reply = {"type": "ok", "fencing_epoch": fencing, "state": state}
        if cache_peers is not None:
            reply["cache_peers"] = cache_peers
        return reply

    def _handle_register_job(self, header):
        """Register (or restart) a job. Refused under fcfs, whose one shared
        queue has no per-job assignment."""
        if self.mode == "fcfs":
            return {"type": "error", "error": (
                "register_job requires static or dynamic sharding: fcfs hands splits out of "
                "ONE shared first-come-first-served queue with no per-job assignment, so "
                "multiple jobs would silently split (not share) every epoch's data — run "
                "the dispatcher with mode='dynamic' (recommended: work-stealing + "
                "autoscaling) or mode='static'")}
        job_id = str(header["job_id"])
        weight = float(header.get("weight", 1.0))
        if weight <= 0:
            return {"type": "error", "error": f"job weight must be > 0, got {weight}"}
        quota = header.get("quota")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            restarted = self._install_job_locked(job_id, weight, quota, restart=True)
            self._journal_locked({"op": "job_register", "job_id": job_id, "weight": weight,
                                  "quota": float(quota) if quota is not None else None,
                                  "restart": True})
            fencing = self._job_fencing_locked(job_id)
        logger.info("job %s %s (weight=%g quota=%s)", job_id,
                    "restarted" if restarted else "registered", weight, quota)
        return {"type": "ok", "job_id": job_id, "restarted": restarted,
                "fencing_epoch": fencing}

    def _handle_end_job(self, header):
        """End a job: its clients, piece books, watermarks and quota go.
        Ending an unknown job is a no-op."""
        job_id = str(header["job_id"])
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            removed = self._remove_job_locked(job_id)
            if removed:
                self._journal_locked({"op": "job_end", "job_id": job_id})
        if removed:
            logger.info("job %s ended: clients, piece books and quota released", job_id)
        return {"type": "ok", "job_id": job_id, "removed": removed}

    def _handle_set_mixture_weights(self, header):
        """Journal a mixture weight change for one job: every
        ``MixedBatchSource`` following the job applies it at the
        ``effective_epoch`` pass boundary. Fenced by job: a caller holding a
        stale fencing epoch is told to resync. A retry carrying the last
        request's ``token`` answers for the journaled entry instead of
        appending a second one."""
        from petastorm_tpu_torch.service.mixture import validate_weights

        job_id = str(header.get("job_id") or DEFAULT_JOB)
        try:
            weights = validate_weights(header.get("weights"))
        except ValueError as exc:
            return {"type": "error", "error": str(exc)}
        effective_epoch = header.get("effective_epoch")
        fencing_token = header.get("fencing_epoch")
        request_token = header.get("token")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            if fencing_token is not None \
                    and int(fencing_token) < self._job_fencing_locked(job_id):
                self._recovery["stale_fencing_rejections"] += 1
                self._job_recovery_locked(job_id)["stale_fencing_rejections"] += 1
                return {"type": "stale_fencing",
                        "fencing_epoch": self._job_fencing_locked(job_id)}
            self._ensure_job_locked(job_id)
            mixture = self._mixtures.setdefault(job_id,
                                                {"seq": 0, "entries": [], "last_token": None})
            if request_token is not None and mixture.get("last_token") == request_token:
                return {"type": "ok", "job_id": job_id, "seq": mixture["seq"],
                        "entries": [dict(e) for e in mixture["entries"]],
                        "fencing_epoch": self._job_fencing_locked(job_id)}
            seq = mixture["seq"] + 1
            self._install_mixture_locked(job_id, seq, weights, effective_epoch,
                                         token=request_token)
            record = {"op": "mixture_weights", "job_id": job_id, "seq": seq,
                      "weights": weights}
            if effective_epoch is not None:
                record["effective_epoch"] = int(effective_epoch)
            if request_token is not None:
                record["token"] = request_token
            self._journal_locked(record)
            entries = [dict(e) for e in mixture["entries"]]
            fencing = self._job_fencing_locked(job_id)
        logger.info("mixture weights for job %r set to %s (seq %d, effective epoch %s)",
                    job_id, weights, seq,
                    effective_epoch if effective_epoch is not None else "next")
        return {"type": "ok", "job_id": job_id, "seq": seq, "entries": entries,
                "fencing_epoch": fencing}

    def _handle_get_mixture(self, header):
        """The job's journaled mixture weight log (read-only)."""
        job_id = str(header.get("job_id") or DEFAULT_JOB)
        with self._lock:
            mixture = self._mixtures.get(job_id, {"seq": 0, "entries": []})
            return {"type": "mixture", "job_id": job_id, "seq": mixture["seq"],
                    "entries": [dict(e) for e in mixture["entries"]],
                    "fencing_epoch": self._job_fencing_locked(job_id)}

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
                    # The worker's state (its drain edge starts the warm
                    # hand-off) and the serving cache peers its ring uses.
                    "worker_state": worker.get("state", "serving"),
                    "cache_peers": self._cache_peers_locked(),
                    # The clock-alignment beacon: this dispatcher's trace
                    # timebase "now", and whether fleet tracing is armed.
                    "dispatcher_time_us": tracing.COLLECTOR.now_us(),
                    "trace": self._trace_armed}

    def _cache_peers_locked(self):
        """The fleet cache tier's membership: alive serving workers that
        registered with the tier, as sorted ``[worker_id, host, port]``
        (a draining worker leaves the ring at once)."""
        return [[wid, w["address"][0], int(w["address"][1])]
                for wid, w in sorted(self._workers.items())
                if w["alive"] and w.get("cache_fleet")
                and w.get("state", "serving") == "serving"]

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
            job_id = self._client_job_locked(client_id, header)
            return {"type": "ok", "known": known,
                    "fencing_epoch": self._job_fencing_locked(job_id),
                    "recovery": dict(self._recovery),
                    "brownout_level": self._brownout_level,
                    "credit_scale": self._credit_scale_locked(job_id),
                    "dispatcher_time_us": tracing.COLLECTOR.now_us(),
                    "trace": self._trace_armed}

    def _alive_workers(self, states=("serving", "draining")):
        """Live workers in ``states``: by default those whose streams may
        still flow (a standby worker is in no plan until admitted)."""
        return {wid: w for wid, w in self._workers.items()
                if w["alive"] and w.get("state", "serving") in states}

    def _serving_workers(self, corpus=None):
        """Workers eligible for new grants: alive, serving and not
        breaker-open; when every one is breaker-open the exclusion yields.
        ``corpus`` keeps one corpus's workers (``None``: every corpus)."""
        workers = self._alive_workers(("serving",))
        if corpus is not None:
            workers = {wid: w for wid, w in workers.items() if w.get("corpus", "") == corpus}
        if self._breaker_open:
            healthy = {wid: w for wid, w in workers.items() if wid not in self._breaker_open}
            if healthy:
                return healthy
        return workers

    def _handle_list_workers(self, header):
        """The serving workers of the request's corpus (``""``: the
        default one), so an fcfs client opens no stream to a worker of
        another dataset."""
        corpus = str(header.get("corpus") or "")
        with self._lock:
            return {"type": "workers",
                    "workers": {wid: w["address"]
                                for wid, w in self._serving_workers(corpus).items()},
                    "mode": self.mode, "num_epochs": self.num_epochs,
                    "num_pieces": self._corpus_pieces.get(corpus),
                    "shuffle_seed": self.shuffle_seed, "fencing_epoch": self._fencing_epoch}

    @staticmethod
    def _no_workers_error(what, corpus):
        return {"type": "error", "error": what + (f" for corpus {corpus!r}" if corpus else "")}

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
        corpus = str(header.get("corpus") or "")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            num_pieces = self._corpus_pieces.get(corpus)
            if num_pieces is None:
                return self._no_workers_error("no workers have registered yet", corpus)
            alive = self._serving_workers(corpus)
            if not alive:
                return self._no_workers_error("no live workers", corpus)
            job_id = str(header.get("job_id") or DEFAULT_JOB)
            # Partition the ascending piece list (the same workers serve the
            # same pieces every epoch), then order each share by the epoch's
            # seed-tree keys.
            epoch = int(header.get("epoch", 0))
            client_pieces = self._grantable_pieces_locked(
                list(range(num_pieces))[client_index::num_clients], corpus=corpus)
            assignments = {wid: piece_order(self.shuffle_seed, epoch, pieces)
                           for wid, pieces in self._partition(client_pieces,
                                                              sorted(alive)).items()}
            self._install_client_locked(header["client_id"], epoch, client_index,
                                        num_clients, job_id, corpus=corpus)
            self._client_heartbeats[header["client_id"]] = time.monotonic()
            self._journal_locked(self._client_record(header["client_id"], epoch, client_index,
                                                     num_clients, job_id, corpus))
            return {"type": "assignment", "epoch": epoch,
                    "fencing_epoch": self._job_fencing_locked(job_id),
                    "credit_scale": self._credit_scale_locked(job_id),
                    "assignments": assignments,
                    "workers": {wid: alive[wid]["address"] for wid in assignments}}

    @staticmethod
    def _client_record(client_id, epoch, client_index, num_clients, job_id, corpus):
        record = {"op": "client", "client_id": client_id, "epoch": epoch,
                  "client_index": client_index, "num_clients": num_clients}
        if job_id != DEFAULT_JOB:
            record["job_id"] = job_id
        if corpus:
            record["corpus"] = corpus
        return record

    def _handle_report_failure(self, header):
        worker_id = header["worker_id"]
        token = header.get("fencing_epoch")
        corpus = str(header.get("corpus") or "")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            # A quarantined piece must not ride a takeover back into a plan.
            pieces = self._grantable_pieces_locked((int(p) for p in header.get("pieces", [])),
                                                   corpus=corpus)
            job_id = self._client_job_locked(header.get("client_id"), header)
            if token is not None and int(token) < self._job_fencing_locked(job_id):
                # The client acts on a plan a later event invalidated (its
                # job's epoch: another job's restart never fences it): it
                # must re-fetch its assignment instead of taking over.
                self._recovery["stale_fencing_rejections"] += 1
                self._job_recovery_locked(job_id)["stale_fencing_rejections"] += 1
                logger.warning("rejecting stale report_failure (token %s) from %s", token,
                               header.get("client_id"))
                return {"type": "stale_fencing",
                        "fencing_epoch": self._job_fencing_locked(job_id)}
            if self._mark_worker_dead_locked(worker_id, "reported", job_id=job_id):
                # The job rides every record, so a replay attributes the
                # failure to the same job.
                self._journal_locked({"op": "worker_dead", "worker_id": worker_id,
                                      "reason": "reported", "job_id": job_id})
                self._bump_fencing_locked("report_failure")
            # A draining worker takes a dead peer's pieces only when nothing
            # serves; a dead worker's pieces move only within its corpus.
            alive = (self._serving_workers(corpus)
                     or {wid: w for wid, w in self._alive_workers().items()
                         if w.get("corpus", "") == corpus})
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
            quarantined = self._quarantined_default
            if quarantined and len(quarantined) >= self._num_pieces:
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
                if piece not in quarantined:
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
        corpus = str(header.get("corpus") or "")
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            num_pieces = self._corpus_pieces.get(corpus)
            if num_pieces is None:
                return self._no_workers_error("no workers have registered yet", corpus)
            alive = self._serving_workers(corpus)
            if not alive:
                return self._no_workers_error("no live workers", corpus)
            job_id = str(header.get("job_id") or DEFAULT_JOB)
            # Sticky deques in canonical per-deque order, like static: cache
            # warmth survives shuffled epochs.
            client_pieces = self._grantable_pieces_locked(
                list(range(num_pieces))[client_index::num_clients], corpus=corpus)
            assignments = {wid: piece_order(self.shuffle_seed, epoch, pieces)
                           for wid, pieces in self._partition(client_pieces,
                                                              sorted(alive)).items()}
            self._generation += 1
            generation = self._generation
            owner = {piece: [wid, generation]
                     for wid, pieces in assignments.items() for piece in pieces}
            self._install_dynamic_plan_locked(client_id, epoch, owner, generation)
            self._install_client_locked(client_id, epoch, client_index, num_clients, job_id,
                                        corpus=corpus)
            self._client_heartbeats[client_id] = time.monotonic()
            self._journal_locked(self._client_record(client_id, epoch, client_index,
                                                     num_clients, job_id, corpus))
            self._journal_locked({"op": "dynamic_plan", "client_id": client_id,
                                  "epoch": epoch,
                                  "owner": [[piece, wid, gen]
                                            for piece, (wid, gen) in sorted(owner.items())],
                                  "generation": generation})
            return {"type": "plan", "epoch": epoch, "generation": generation,
                    "fencing_epoch": self._job_fencing_locked(job_id),
                    "credit_scale": self._credit_scale_locked(job_id),
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
            job_id = self._client_job_locked(client_id, header)
            self._last_rates.update(rates)
            state = self._dyn.get(client_id)
            if state is None or state["epoch"] != epoch:
                # No plan for this epoch (restarted without a journal): the
                # client re-plans while its streams keep flowing.
                return {"type": "unknown_plan",
                        "fencing_epoch": self._job_fencing_locked(job_id)}
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
            # A client's steals move pieces only among its corpus's workers.
            client_corpus = self._clients.get(client_id, {}).get("corpus", "")
            alive = {wid: w for wid, w in self._alive_workers().items()
                     if w.get("corpus", "") == client_corpus}
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
            serving_ids = set(self._serving_workers(client_corpus))
            moves = []
            draining_ids = sorted(wid for wid in alive if wid not in serving_ids)
            if draining_ids and serving_ids:
                # A worker out of the serving set (draining or breaker-open)
                # sheds its whole unstarted backlog to the least-loaded
                # serving peers; its started pieces finish where they are.
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
                    "fencing_epoch": self._job_fencing_locked(job_id),
                    "credit_scale": self._credit_scale_locked(job_id),
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
            # The whole fleet, standby pool included.
            workers = {wid: tuple(w["address"]) for wid, w in
                       self._alive_workers(("serving", "draining", "standby")).items()}

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

    def _handle_cache_handoff(self, header):
        """A drained worker's warm hand-off summary (entries and bytes
        shipped, to which peers, errors, torn): journaled and kept for
        ``status``."""
        worker_id = header.get("worker_id")
        if not worker_id:
            return {"type": "error", "error": "cache_handoff requires a worker_id"}
        record = {"op": "cache_handoff", "worker_id": str(worker_id),
                  "entries": int(header.get("entries", 0)),
                  "bytes": int(header.get("bytes", 0)),
                  "peers": {str(p): int(n) for p, n in (header.get("peers") or {}).items()},
                  "errors": int(header.get("errors", 0)),
                  "torn": bool(header.get("torn"))}
        with self._lock:
            blocked = self._check_writable_locked()
            if blocked is not None:
                return blocked
            self._install_cache_handoff_locked(record)
            self._journal_locked(record)
            kept = len(self._cache_handoffs)
        logger.info("cache hand-off of worker %s journaled: %d entries (%d bytes) to %d "
                    "peers, %d errors%s", worker_id, record["entries"], record["bytes"],
                    len(record["peers"]), record["errors"],
                    " [TORN]" if record["torn"] else "")
        return {"type": "ok", "kept": kept}

    def _handle_status(self, header):
        now = time.monotonic()
        with self._lock:
            shares = self._job_shares_locked()
            per_job = self._dynamic_per_job_locked() if self.mode == "dynamic" else {}
            return {
                "type": "status",
                "mode": self.mode,
                "num_epochs": self.num_epochs,
                "num_pieces": self._num_pieces,
                "shuffle_seed": self.shuffle_seed,
                "fencing_epoch": self._fencing_epoch,
                "degraded": self._degraded,
                "quarantined": {(f"{c}:{p}" if c else str(p)): dict(info)
                                for (c, p), info in sorted(self._quarantined.items())},
                "client_watermarks": {
                    cid: {"epoch": entry["epoch"],
                          "watermarks": {str(p): n for p, n in entry["watermarks"].items()}}
                    for cid, entry in self._client_watermarks.items()},
                "recovery": dict(self._recovery),
                "journal": self._journal.stats if self._journal is not None else None,
                "workers": {
                    wid: {"address": w["address"], "alive": w["alive"],
                          "state": w.get("state", "serving"),
                          "metrics_port": w.get("metrics_port"),
                          "cache_fleet": bool(w.get("cache_fleet")),
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
                    "workers_by_state": {
                        state: sorted(wid for wid, w in self._workers.items()
                                      if w["alive"] and w.get("state", "serving") == state)
                        for state in ("serving", "standby", "draining")},
                    "autoscale": dict(self._autoscale_counts),
                    "autoscaler_armed": self._autoscaler is not None,
                    "breaker_open": {wid: dict(info)
                                     for wid, info in sorted(self._breaker_open.items())},
                    "brownout": {"level": self._brownout_level,
                                 "counts": dict(self._brownout_counts),
                                 "reason": self._brownout_reason,
                                 "armed": self._brownout is not None},
                    "cache_peers": self._cache_peers_locked(),
                    "cache_handoffs": [dict(h) for h in self._cache_handoffs],
                    "fleet_plans": [dict(p) for p in self._fleet_plans]},
                "jobs": {
                    jid: {"weight": job["weight"], "quota": job["quota"],
                          "epoch": job["epoch"],
                          "fencing_epoch": self._job_fencing_locked(jid),
                          "fair_share": round(shares.get(jid, 0.0), 4),
                          "clients": sorted(cid for cid, c in self._clients.items()
                                            if c.get("job_id", DEFAULT_JOB) == jid),
                          "recovery": dict(self._job_recovery.get(jid, {})),
                          **(per_job.get(jid, {}) if self.mode == "dynamic" else {})}
                    for jid, job in self._jobs.items()},
                "fcfs_epoch": self._fcfs_epoch,
                "fcfs_remaining": (len(self._fcfs_queue)
                                   if self._fcfs_queue is not None else None),
                "dynamic": (self._dynamic_status_locked() if self.mode == "dynamic"
                            else None),
                # The piece universes and each job's weight-log head.
                "corpora": dict(self._corpus_pieces),
                "mixtures": {jid: {"seq": m["seq"],
                                   "weights": (dict(m["entries"][-1]["weights"])
                                               if m["entries"] else None)}
                             for jid, m in self._mixtures.items()},
            }
