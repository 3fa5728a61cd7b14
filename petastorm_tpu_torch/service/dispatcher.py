"""The dispatcher: the data service's control plane (the port's own copy of
``petastorm_tpu/service/dispatcher.py``, its static / fcfs tier).

It owns the split plan and nothing else: no sample bytes flow through it.
Workers register their address and the dataset's row-group count; clients
ask which pieces to stream from which workers. Every request is one framed
message with one framed reply (``type`` names the request):

- ``register_worker`` ``{worker_id, host, port, num_pieces[, re_register]}``
  → ``ok`` (a piece count other than the registered workers' is refused);
- ``worker_heartbeat`` ``{worker_id}`` → ``ok`` (lease renewed) or
  ``unknown_worker`` (re-register);
- ``list_workers`` → ``workers`` (serving workers and the service config);
- ``get_assignment`` ``{client_id, client_index, num_clients, epoch}``
  (static) → ``assignment``: the client's shard (``pieces[index::n]``)
  round-robined across the live workers, each share in the epoch's
  seed-tree order of ``shuffle_seed``;
- ``report_failure`` ``{client_id, worker_id, pieces[, fencing_epoch]}`` →
  ``assignment``: the dead worker's pieces re-partitioned across the
  survivors (``stale_fencing`` for a token older than the fencing epoch);
- ``next_split`` ``{client_id}`` (fcfs) → ``split`` or ``end_of_stream``
  (the shared queue refills until ``num_epochs`` are served);
- ``worker_diagnostics`` → every live worker's ``diagnostics``, fetched
  concurrently; ``status`` → the control-plane state; ``ping`` → ``pong``.

A worker whose lease (``lease_timeout_s``) expires is marked dead, and a
client's ``report_failure`` does the same; either bumps the fencing epoch.
The epoch starts at 0: the port's dispatcher keeps its state in memory and
never recovers from a journal. Dynamic mode, the journal, brownout and
breakers, autoscaling, jobs, corpora and mixtures raise
NotImplementedError (or an ``error`` reply) naming the service slice that
brings them.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from petastorm_tpu_torch.reader_impl.framed_socket import FramedReader, FramedServer, send_framed
from petastorm_tpu_torch.service.seedtree import piece_order
from petastorm_tpu_torch.telemetry.metrics import (
    DISPATCHER_FENCING_EPOCH,
    DISPATCHER_REQUESTS,
    DISPATCHER_WORKERS,
)

logger = logging.getLogger(__name__)

MODES = ("static", "fcfs", "dynamic")

#: The job every request belongs to (multi-tenant jobs come with slice (d)).
DEFAULT_JOB = "default"

#: A worker missing heartbeats this long is evicted.
DEFAULT_LEASE_TIMEOUT_S = 30.0

#: Cap on the per-probe ``timeout`` of ``worker_diagnostics``.
PROBE_TIMEOUT_CAP_S = 30.0

#: ``Dispatcher`` arguments this slice does not take: the value that asks
#: for nothing, and the slice that ports the feature.
UNPORTED_DISPATCHER_ARGS = {
    "journal_dir": (None, "the crash-recovery journal comes with the control plane, "
                          "slice (b)"),
    "brownout": (None, "brownout comes with the control plane's resilience layer, "
                       "slice (b)"),
    "breaker_cooldown_s": (10.0, "circuit breakers come with the control plane's "
                                 "resilience layer, slice (b)"),
    "autoscale": (None, "the fleet autoscaler comes with slice (d)"),
}

#: Requests of later slices, answered with an error naming the slice.
_UNPORTED_REQUESTS = {
    "dynamic_plan": "dynamic sharding comes with slice (c)",
    "dynamic_sync": "dynamic sharding comes with slice (c)",
    "register_job": "jobs come with the fleet, slice (d)",
    "end_job": "jobs come with the fleet, slice (d)",
    "set_mixture_weights": "mixtures come with the LLM stages, slice (f)",
    "get_mixture": "mixtures come with the LLM stages, slice (f)",
    "client_heartbeat": "client heartbeats and fencing resyncs come with the control "
                        "plane, slice (b)",
    "report_poison_piece": "poison-piece quarantine comes with the control plane, "
                           "slice (b)",
    "report_breaker": "circuit breakers come with the control plane, slice (b)",
    "trace": "fleet tracing comes with the control plane, slice (b)",
    "trace_push": "fleet tracing comes with the control plane, slice (b)",
    "stage_profile": "fleet tracing comes with the control plane, slice (b)",
    "cache_handoff": "the fleet cache tier comes with slice (d)",
}


class Dispatcher:
    """Split-assignment server; :meth:`start`, :meth:`stop` (a context
    manager too).

    :param mode: ``"static"`` (per-client shards) or ``"fcfs"`` (one shared
        queue of splits); ``"dynamic"`` raises NotImplementedError.
    :param num_epochs: epochs the service serves (``None``: forever).
    :param lease_timeout_s: evict a worker whose last heartbeat (or
        registration) is older; ``None`` or 0 disables expiry.
    :param max_frame_bytes: receive frame cap per connection.
    :param shuffle_seed: seed-tree order: each client epoch's piece order
        is a pure function of the seed, the epoch and the piece; ``None``
        orders pieces ascending. fcfs ignores it.

    ``journal_dir``, ``brownout``, a non-default ``breaker_cooldown_s`` and
    ``autoscale`` raise NotImplementedError naming their slice;
    ``journal_compact_every`` and ``journal_fsync`` only configure a
    journal and change nothing here.
    """

    def __init__(self, host="127.0.0.1", port=0, mode="static", num_epochs=1,
                 journal_dir=None, lease_timeout_s=DEFAULT_LEASE_TIMEOUT_S,
                 journal_compact_every=256, journal_fsync=False, max_frame_bytes=None,
                 shuffle_seed=None, autoscale=None, brownout=None, breaker_cooldown_s=10.0):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "dynamic":
            raise NotImplementedError(
                "Dispatcher(mode='dynamic') is not ported yet: dynamic sharding comes "
                "with the data service's slice (c)")
        given = {"journal_dir": journal_dir, "brownout": brownout or None,
                 "breaker_cooldown_s": float(breaker_cooldown_s),
                 "autoscale": autoscale or None}
        for name, value in given.items():
            default, reason = UNPORTED_DISPATCHER_ARGS[name]
            if value != default:
                raise NotImplementedError(f"Dispatcher({name}=...) is not ported yet: "
                                          f"{reason}")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError("num_epochs must be a positive integer or None")
        self.mode = mode
        self.num_epochs = num_epochs
        self.shuffle_seed = int(shuffle_seed) if shuffle_seed is not None else None
        self.lease_timeout_s = lease_timeout_s or None
        self._max_frame_bytes = max_frame_bytes
        self._lock = threading.Lock()
        self._workers = {}  # worker_id -> {address, num_pieces, alive, state}
        self._clients = {}  # client_id -> {epoch, client_index, num_clients}
        self._num_pieces = None
        self._fcfs_queue = None
        self._fcfs_epoch = 0
        self._worker_leases = {}  # worker_id -> monotonic expiry
        self._client_heartbeats = {}
        self._worker_credit_wait = {}
        self._fencing_epoch = 0
        self._recovery = {"evictions": 0, "failures_reported": 0, "re_registrations": 0,
                          "fencing_bumps": 0, "stale_fencing_rejections": 0}
        #: The dispatcher's metrics endpoint, when the CLI serves one.
        self.metrics_address = None
        self._lease_thread = None
        self._server = FramedServer(self._serve_connection, host=host, port=port,
                                    name="service-dispatcher")

    # -- lifecycle ---------------------------------------------------------

    def start(self):
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
        self._server.join(timeout=5)
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=5)

    def drop_connections(self):
        """Drop every open connection and keep serving (a network blip)."""
        self._server.close_connections()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

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
                if expired:
                    self._bump_fencing_locked("lease_expiry")
                    self._sync_telemetry_locked()

    def _mark_worker_dead_locked(self, worker_id, reason):
        worker = self._workers.get(worker_id)
        if worker is None or not worker["alive"]:
            return False
        worker["alive"] = False
        self._worker_leases.pop(worker_id, None)
        self._worker_credit_wait.pop(worker_id, None)
        self._recovery["evictions" if reason == "lease_expired"
                       else "failures_reported"] += 1
        return True

    def _bump_fencing_locked(self, reason):
        self._fencing_epoch += 1
        self._recovery["fencing_bumps"] += 1
        logger.info("fencing epoch bumped to %d (%s)", self._fencing_epoch, reason)

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
            # A handler may return (header, payload): worker_diagnostics
            # carries arbitrary reader diagnostics as its payload.
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
        try:
            return handler(header)
        finally:
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

    def _sync_telemetry_locked(self):
        DISPATCHER_FENCING_EPOCH.set(self._fencing_epoch)
        alive = sum(1 for w in self._workers.values() if w["alive"])
        DISPATCHER_WORKERS.labels("alive").set(alive)
        DISPATCHER_WORKERS.labels("dead").set(len(self._workers) - alive)

    def _handle_ping(self, header):
        return {"type": "pong"}

    def _handle_register_worker(self, header):
        worker_id = header["worker_id"]
        num_pieces = int(header["num_pieces"])
        re_register = bool(header.get("re_register"))
        if header.get("standby"):
            return {"type": "error", "error": "standby workers are not ported yet: "
                                              "standby capacity comes with slice (d)"}
        with self._lock:
            if self._num_pieces is not None and self._num_pieces != num_pieces:
                return {"type": "error", "error": (
                    f"worker {worker_id!r} enumerated {num_pieces} row-group pieces but "
                    f"corpus 'default''s service plan has {self._num_pieces} — all of a "
                    "corpus's workers must read the same dataset with the same planning "
                    "config")}
            known = worker_id in self._workers
            self._num_pieces = num_pieces
            self._workers[worker_id] = {"address": [header["host"], int(header["port"])],
                                        "num_pieces": num_pieces, "alive": True,
                                        "state": "serving"}
            if header.get("metrics_port") is not None:
                self._workers[worker_id]["metrics_port"] = int(header["metrics_port"])
            if known or re_register:
                self._recovery["re_registrations"] += 1
            self._worker_leases[worker_id] = time.monotonic() + (self.lease_timeout_s or 0.0)
            fencing = self._fencing_epoch
        logger.info("worker %s %sregistered at %s:%s (%d pieces)", worker_id,
                    "re-" if re_register else "", header["host"], header["port"],
                    num_pieces)
        return {"type": "ok", "fencing_epoch": fencing, "state": "serving"}

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
            return {"type": "ok", "fencing_epoch": self._fencing_epoch,
                    "worker_state": worker.get("state", "serving")}

    def _alive_workers(self):
        return {wid: w for wid, w in self._workers.items() if w["alive"]}

    def _handle_list_workers(self, header):
        with self._lock:
            return {"type": "workers",
                    "workers": {wid: w["address"] for wid, w in self._alive_workers().items()},
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
            if self._num_pieces is None:
                return {"type": "error", "error": "no workers have registered yet"}
            alive = self._alive_workers()
            if not alive:
                return {"type": "error", "error": "no live workers"}
            # Partition the ascending piece list (the same workers serve the
            # same pieces every epoch), then order each share by the epoch's
            # seed-tree keys.
            epoch = int(header.get("epoch", 0))
            client_pieces = list(range(self._num_pieces))[client_index::num_clients]
            assignments = {wid: piece_order(self.shuffle_seed, epoch, pieces)
                           for wid, pieces in self._partition(client_pieces,
                                                              sorted(alive)).items()}
            self._clients[header["client_id"]] = {"epoch": epoch,
                                                  "client_index": client_index,
                                                  "num_clients": num_clients}
            self._client_heartbeats[header["client_id"]] = time.monotonic()
            return {"type": "assignment", "epoch": epoch,
                    "fencing_epoch": self._fencing_epoch, "credit_scale": 1.0,
                    "assignments": assignments,
                    "workers": {wid: alive[wid]["address"] for wid in assignments}}

    def _handle_report_failure(self, header):
        worker_id = header["worker_id"]
        pieces = [int(p) for p in header.get("pieces", [])]
        token = header.get("fencing_epoch")
        with self._lock:
            if token is not None and int(token) < self._fencing_epoch:
                # The client acts on a plan a later event invalidated: it
                # must re-fetch its assignment instead of taking over.
                self._recovery["stale_fencing_rejections"] += 1
                logger.warning("rejecting stale report_failure (token %s) from %s", token,
                               header.get("client_id"))
                return {"type": "stale_fencing", "fencing_epoch": self._fencing_epoch}
            if self._mark_worker_dead_locked(worker_id, "reported"):
                self._bump_fencing_locked("report_failure")
            alive = self._alive_workers()
            if not alive:
                return {"type": "error", "error": (
                    f"worker {worker_id!r} reported dead and no live workers remain — the "
                    "service cannot make progress")}
            worker_ids = sorted(alive)
            assignments = self._partition(pieces, worker_ids)
            logger.warning("worker %s reported failed; reassigning %d pieces across %d "
                           "survivors", worker_id, len(pieces), len(worker_ids))
            return {"type": "assignment", "fencing_epoch": self._fencing_epoch,
                    "assignments": assignments,
                    "workers": {wid: alive[wid]["address"] for wid in assignments}}

    def _handle_next_split(self, header):
        if self.mode != "fcfs":
            return {"type": "error", "error":
                    "next_split is an fcfs-mode request; static clients use get_assignment"}
        with self._lock:
            if self._num_pieces is None:
                return {"type": "error", "error": "no workers have registered yet"}
            if self._fcfs_queue is None:
                self._fcfs_queue = deque(range(self._num_pieces))
            if not self._fcfs_queue:
                # Epoch boundary: refill while epochs remain (None: forever).
                if self.num_epochs is not None and self._fcfs_epoch + 1 >= self.num_epochs:
                    return {"type": "end_of_stream",
                            "epochs_completed": self._fcfs_epoch + 1}
                self._fcfs_epoch += 1
                self._fcfs_queue.extend(range(self._num_pieces))
            piece = self._fcfs_queue.popleft()
            return {"type": "split", "piece": piece, "epoch": self._fcfs_epoch}

    @staticmethod
    def _probe_timeout(header):
        try:
            timeout = float(header.get("timeout", 5.0))
        except (TypeError, ValueError):
            return 5.0
        return min(max(timeout, 0.1), PROBE_TIMEOUT_CAP_S)

    def _handle_worker_diagnostics(self, header):
        """Every live worker's ``diagnostics``, fetched concurrently (one
        round trip of latency); an unreachable worker is reported in place."""
        from concurrent.futures import ThreadPoolExecutor

        from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

        timeout = self._probe_timeout(header)
        with self._lock:
            workers = {wid: tuple(w["address"]) for wid, w in self._alive_workers().items()}

        def probe(address):
            try:
                with FramedConnection.connect(address, timeout=timeout) as conn:
                    _, payload = conn.request({"type": "diagnostics"})
                return payload
            except (ConnectionError, OSError) as exc:
                return {"error": f"unreachable: {exc}"}

        out = {}
        if workers:
            with ThreadPoolExecutor(max_workers=min(16, len(workers))) as pool:
                for wid, payload in zip(workers, pool.map(probe, workers.values())):
                    out[wid] = payload
        return {"type": "diagnostics", "workers": sorted(workers)}, out

    def _handle_status(self, header):
        now = time.monotonic()
        with self._lock:
            return {
                "type": "status",
                "mode": self.mode,
                "num_epochs": self.num_epochs,
                "num_pieces": self._num_pieces,
                "shuffle_seed": self.shuffle_seed,
                "fencing_epoch": self._fencing_epoch,
                "recovery": dict(self._recovery),
                "workers": {
                    wid: {"address": w["address"], "alive": w["alive"],
                          "state": w.get("state", "serving"),
                          "metrics_port": w.get("metrics_port"),
                          "lease_expires_in_s": (round(self._worker_leases[wid] - now, 3)
                                                 if wid in self._worker_leases else None)}
                    for wid, w in self._workers.items()},
                "clients": {cid: dict(c) for cid, c in self._clients.items()},
                "metrics_address": self.metrics_address,
                "fcfs_epoch": self._fcfs_epoch,
                "fcfs_remaining": (len(self._fcfs_queue)
                                   if self._fcfs_queue is not None else None),
            }
