"""Batch workers: the data plane of the data service (the port's own copy
of ``petastorm_tpu/service/worker.py``: static, fcfs and dynamic streams).

A worker wraps the local input pipeline, a ``make_reader``-family reader
plus collation (:mod:`petastorm_tpu_torch.torch_utils.batcher`), and serves
numpy batch dicts over framed TCP (:mod:`petastorm_tpu_torch.reader_impl.
framed_socket`). It never touches a CUDA device. Each ``stream`` request
names row-group piece indices (the dispatcher's plan); the worker reads
them through one reader built with ``piece_indices=`` and sends one
``batch`` message per collated batch, then ``end`` with the row total.

Three serving forms, as in the JAX package:

- **tagged** (the static client's exactly-once protocol): batches are
  piece-aligned (a ragged tail per piece), each carries its ``piece`` and
  absolute ``ordinal``, and each finished piece is announced with a
  ``piece_done`` frame. ``starts`` (piece → first ordinal to send, the
  client's delivery watermark) makes a re-serve skip what was delivered,
  and the dispatcher's ``shuffle_seed`` permutes each piece's batches by
  ``seedtree.batch_permutation``. It is served through the streaming piece
  engine (:mod:`petastorm_tpu_torch.service.piece_engine`: one reader a
  stream, fed piece by piece, decoding ``lookahead`` pieces ahead); a
  process pool, which cannot attribute completions to its items, serves it
  through one reader whose outputs are attributed to pieces by its delivery
  tracker.
- **dynamic** (``dynamic: true``, dynamic sharding): pieces arrive as
  ``[piece, generation, start]`` and the engine serves them from a queue
  the client edits mid-stream with ``extend``, ``revoke`` (acked with a
  ``revoked`` frame naming the pieces actually removed: none of their
  batches was or will be sent) and ``finish_pieces`` frames. Every batch
  carries its piece, generation and ordinal.
- **untagged** (fcfs splits, legacy clients): one reader over the piece
  set, batches collated across piece boundaries.

With ``on_piece_error="quarantine"`` a tagged or dynamic stream reports an
undecodable piece with a ``piece_failed`` frame and serves on.

The fleet: ``standby=True`` registers the worker as pool capacity that
receives nothing until the dispatcher admits it. ``fleet_cache=True`` wraps
the batch cache in the fleet cache tier
(:class:`~petastorm_tpu_torch.cache_impl.fleet_tier.FleetCacheTier`): the
ring's peers come with the registration and heartbeat replies, the worker
answers its peers' ``cache_fetch`` and ``cache_put`` requests, and when the
dispatcher drains it a thread (``cache-peer-handoff-<worker id>``) ships its
memory tier to the peers that inherit its keys and reports a
``cache_handoff``. A stream request's ``job_id`` buckets its rows and cache
lookups per job (``rows_by_job``, ``cache_stats_by_job``,
``petastorm_fleet_job_rows_total``).

A ``batch_cache`` keeps each piece's serialized batches under a content key
(:meth:`BatchWorker._piece_cache_key`, the JAX worker's key, so one cache
directory serves both packages): a warm piece is sent from the cache with
no read, decode or serialization. Untagged streams then serve piece by
piece through the engine too (a process pool: one reader a cold piece).

Graph rewrites a stream request may carry (engine paths only): ``fused``
(stage fusion: the pool task collates, transforms and serializes),
``predicate`` (a ``ColumnPredicate`` in wire form, applied below decode)
and ``projection`` (the fields read), ``cache_stage`` (``post-decode``:
the cache holds the batches before the batch transform) and
``reader_family`` (``row`` or ``columnar`` decode; a family this worker
cannot serve falls back to the constructed one, bytes identical, counted
in ``petastorm_columnar_batches_total``).

Transport: each stream negotiates its tier
(:mod:`petastorm_tpu_torch.service.transport`): a client on this host that
advertises shared memory is served through a
:class:`~petastorm_tpu_torch.service.shm_ring.RingProducer`, every other
stream over TCP. With a cache and a mode other than ``tcp`` the cache's
entries live in a :class:`~petastorm_tpu_torch.service.shm_ring.FramePool`,
so warm batches travel as references into it.

Flow control: a ``credits`` field bounds the batches in flight; the client
replenishes with ``credit`` messages as it consumes, and a worker out of
credits waits for them (``credit_wait_s``). A ``diagnostics`` request
returns every active stream's reader diagnostics and flow state and the
final snapshots of recently finished streams.

Control plane: the heartbeat renews the dispatcher lease, carries the
worker's cumulative credit wait (a brownout signal) and takes an NTP-style
clock sample against the dispatcher's trace timebase; its reply's
brownout level sheds optional stages at level 2, and its ``trace`` flag
arms this process's span collector, whose ring each armed tick pushes to
the dispatcher (a ``trace`` request pulls it). A stream request whose
propagated deadline already expired is refused (retryable). The
``worker.heartbeat`` and ``slow-peer`` failpoints live here.

A stream's ``packing`` (a :class:`~petastorm_tpu_torch.service.packing_stage.
PackingSpec` dict) packs its pieces inside the engine before serialization
and the cache fill (tagged and dynamic streams on the engine only, never
with a worker-side batch transform). A ``corpus`` names the dataset this
worker serves in a multi-corpus fleet: it rides the registration, and the
dispatcher grants it only that corpus's pieces.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.reader_impl.framed_socket import (
    ConnectionClosedError,
    FramedReader,
    FramedServer,
    ProtocolError,
    encode_payload,
    send_framed,
)
from petastorm_tpu_torch.service.packing_stage import PackingSpec, StreamPacker
from petastorm_tpu_torch.service.piece_engine import CACHE_STAGES
from petastorm_tpu_torch.service.resilience import (
    arrival_deadline,
    deadline_exceeded_reply,
    deadline_expired,
    note_brownout_level,
)
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.clockalign import OffsetEstimator
from petastorm_tpu_torch.telemetry.metrics import (
    COLUMNAR_BATCHES,
    FLEET_JOB_CACHE_LOOKUPS,
    FLEET_JOB_ROWS,
    WORKER_ACTIVE_STREAMS,
    WORKER_BATCHES_SENT,
    WORKER_CREDIT_WAIT,
    WORKER_DECODE_SECONDS,
    WORKER_HANDOFF_SECONDS,
    WORKER_READERS_CONSTRUCTED,
    WORKER_ROWS_SENT,
    WORKER_STREAMS,
    WORKER_TRANSFORM_SECONDS,
)

logger = logging.getLogger(__name__)

_FACTORIES = ("row", "batch", "columnar")

#: Final diagnostics snapshots kept for the ``diagnostics`` request.
_COMPLETED_SNAPSHOTS_KEPT = 16


def _resolve_factory(reader_factory):
    if callable(reader_factory):
        return reader_factory
    from petastorm_tpu_torch.reader.reader import (
        make_batch_reader,
        make_columnar_reader,
        make_reader,
    )

    factories = {"row": make_reader, "batch": make_batch_reader,
                 "columnar": make_columnar_reader}
    if reader_factory not in factories:
        raise ValueError(f"reader_factory must be a callable or one of {_FACTORIES}, "
                         f"got {reader_factory!r}")
    return factories[reader_factory]


def _digest_code(digest, code):
    """Feed a code object's behaviour (bytecode, names, constants, nested
    code objects) into ``digest``; not ``repr(co_consts)``, whose nested
    code reprs carry addresses and paths that change every process."""
    digest.update(code.co_code)
    digest.update(" ".join(code.co_names).encode())
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            _digest_code(digest, const)
        else:
            digest.update(repr(const).encode())


def _transform_identity(fn):
    """The cache key's name for a batch transform: ``module:qualname`` and a
    digest of its code, so an edited transform misses the disk tier. A
    closure's captured values are not seen."""
    identity = f"{getattr(fn, '__module__', '')}:{getattr(fn, '__qualname__', repr(fn))}"
    code = getattr(fn, "__code__", None)
    if code is not None:
        import hashlib

        digest = hashlib.blake2b(digest_size=8)
        _digest_code(digest, code)
        identity += f"#{digest.hexdigest()}"
    return identity


class _PieceOutputs:
    """One piece's reader outputs, iterable like the reader that produced
    them, so :func:`batch_iterator` collates the piece on its own."""

    def __init__(self, outputs, batched_output, ngram):
        self._outputs = outputs
        self.batched_output = batched_output
        self.ngram = ngram

    def __iter__(self):
        return iter(self._outputs)


class BatchWorker:
    """Serve collated batches of ``dataset_url`` over TCP.

    :param dataset_url: the dataset every stream reads (all workers of a
        service read the same dataset with the same planning arguments).
    :param dispatcher_address: ``(host, port)`` to register with; ``None``
        for a worker addressed directly.
    :param batch_size: rows per batch; a stream's last batch (a piece's,
        tagged) is ragged: the service drops no rows.
    :param reader_factory: ``"row"`` (``make_reader``), ``"batch"``
        (``make_batch_reader``), ``"columnar"`` (``make_columnar_reader``)
        or a callable with their signature.
    :param reader_kwargs: more factory arguments (``workers_count``,
        ``reader_pool_type``, ``filters``, ``storage_options``, ...);
        ``piece_indices``, ``num_epochs``, ``shuffle_row_groups``, the
        selector and the sharding arguments belong to the service's plan.
    :param batch_delay_s: sleep before each batch send (a slow worker, for
        tests and benchmarks).
    :param heartbeat_interval_s: renew the dispatcher lease this often; an
        ``unknown_worker`` reply re-registers under the same id. ``None``
        disables the loop.
    :param rpc_deadline_s: time budget of each control RPC across retries.
    :param max_frame_bytes: receive frame cap per connection.
    :param batch_transform: ``{field: ndarray} -> {field: ndarray}`` applied
        to each batch before it is serialized, unless the stream asks for
        ``transform_placement="local"`` (the client then runs the same
        callable); timed into ``petastorm_service_worker_transform_seconds``.
    :param batch_cache: a :class:`~petastorm_tpu_torch.cache_impl.BatchCache`
        or ``None``. Each stream looks its pieces up (and fills them)
        through the streaming piece engine; a warm piece is sent from the
        cache's frames. Batch boundaries then align with pieces. The worker
        owns it: :meth:`stop` calls its ``cleanup()``.
    :param transport: ``"auto"`` (negotiate shared memory with a client on
        this host, TCP otherwise), ``"tcp"`` (never negotiate), ``"shm"``
        (as ``"auto"``) or ``None`` (``$PETASTORM_TRANSPORT``).
    :param metrics_port: the port of this process's metrics endpoint,
        advertised at registration (the CLI serves it).
    :param on_piece_error: ``"fail"`` (a piece whose decode fails errors the
        stream) or ``"quarantine"`` (a tagged or dynamic stream reports it
        with a ``piece_failed`` frame and serves on; the engine rebuilds its
        reader).
    :param standby: register as standby pool capacity: leased and observed,
        granted nothing until the autoscaler (or
        ``Dispatcher.admit_worker``) admits it.
    :param fleet_cache: wrap ``batch_cache`` in the fleet cache tier
        (placement on the peers' consistent-hash ring, remote warm serves,
        the warm hand-off on a drain). Needs a ``batch_cache`` (ignored
        without one) and a ``dispatcher_address`` (the ring's membership
        rides the heartbeats).
    :param corpus: the corpus this worker serves in a multi-corpus fleet
        (``""``: the default, single-dataset corpus).
    """

    #: Seconds between stop-flag checks while a stream waits for credits.
    CREDIT_POLL_S = 1.0

    def __init__(self, dataset_url, dispatcher_address=None, host="127.0.0.1", port=0,
                 batch_size=64, reader_factory="row", reader_kwargs=None, worker_id=None,
                 register_retries=5, register_backoff=0.2, batch_delay_s=0.0,
                 heartbeat_interval_s=5.0, rpc_deadline_s=30.0, max_frame_bytes=None,
                 batch_cache=None, batch_transform=None, standby=False,
                 on_piece_error="fail", corpus="", transport=None, metrics_port=None,
                 fleet_cache=False):
        from petastorm_tpu_torch.service.transport import resolve_mode

        if on_piece_error not in ("fail", "quarantine"):
            raise ValueError(f"on_piece_error must be 'fail' or 'quarantine', got "
                             f"{on_piece_error!r}")
        self.dataset_url = dataset_url
        self.corpus = str(corpus or "")
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self._dispatcher_address = tuple(dispatcher_address) if dispatcher_address else None
        self._batch_size = batch_size
        # The fleet tier stands in for the cache everywhere below (engines,
        # diagnostics, cleanup).
        self._fleet_tier = None
        if fleet_cache and batch_cache is not None:
            from petastorm_tpu_torch.cache_impl.fleet_tier import FleetCacheTier

            self._fleet_tier = batch_cache = FleetCacheTier(batch_cache, self.worker_id)
        self._batch_cache = batch_cache
        # The lifecycle state the heartbeats last reported: its serving →
        # draining edge starts the warm hand-off once per drain.
        self._fleet_state = None
        self._handoff_thread = None
        self._standby = bool(standby)
        self._batch_transform = batch_transform
        self._on_piece_error = on_piece_error
        self._factory = _resolve_factory(reader_factory)
        # The cache key's family tag: the three families collate codec
        # columns differently, so their entries must not cross.
        self._factory_name = (reader_factory if isinstance(reader_factory, str)
                              else getattr(reader_factory, "__qualname__", repr(reader_factory)))
        self._transport_mode = resolve_mode(transport)
        self._frame_pool = None  # armed in start() when shm is possible
        self._transport_streams = {"tcp": 0, "shm": 0}
        self._reader_kwargs = dict(reader_kwargs or {})
        for owned in ("piece_indices", "num_epochs", "shuffle_row_groups",
                      "rowgroup_selector", "cur_shard", "shard_count", "shard_seed"):
            if owned in self._reader_kwargs:
                raise ValueError(
                    f"reader_kwargs[{owned!r}] is owned by the service's split protocol "
                    "(the dispatcher plans row-group assignment), not worker construction")
        self._register_retries = register_retries
        self._register_backoff = register_backoff
        self._batch_delay_s = float(batch_delay_s)
        self._heartbeat_interval_s = heartbeat_interval_s
        self._rpc_deadline_s = rpc_deadline_s
        self._max_frame_bytes = max_frame_bytes
        self.num_pieces = None
        self._piece_signatures = None  # (path, row_group) per piece, for the cache key
        self._lock = threading.Lock()
        self._active = {}        # stream key -> {"reader", "flow"}
        self._completed = {}     # stream key -> final diagnostics
        self._cache_epochs = {}  # epoch -> {"hits", "misses"} of the streams' lookups
        # Per job (a stream request's job_id), bounded like the epochs.
        self._jobs_served = {}  # job -> {"rows", "batches"}
        self._cache_jobs = {}   # job -> {"hits", "misses"}
        self._m_batches = WORKER_BATCHES_SENT.labels(self.worker_id)
        self._m_rows = WORKER_ROWS_SENT.labels(self.worker_id)
        self._m_credit_wait = WORKER_CREDIT_WAIT.labels(self.worker_id)
        self._m_active = WORKER_ACTIVE_STREAMS.labels(self.worker_id)
        self._m_decode = WORKER_DECODE_SECONDS.labels(self.worker_id)
        self._m_readers = WORKER_READERS_CONSTRUCTED.labels(self.worker_id)
        self._m_transform = WORKER_TRANSFORM_SECONDS.labels(self.worker_id)
        self._m_handoff = WORKER_HANDOFF_SECONDS.labels(self.worker_id)
        # Batches a columnar request was served columnar, or fell back to
        # the row path for (interned: one counter increment a batch).
        self._m_columnar = {path: COLUMNAR_BATCHES.labels(self.worker_id, path)
                            for path in ("columnar", "row_fallback")}
        self.metrics_port = int(metrics_port) if metrics_port is not None else None
        # NTP-style offset samples around each heartbeat, shipped with the
        # pushed trace rings; True while heartbeat replies arm fleet tracing.
        self._clock = OffsetEstimator()
        self._trace_armed_remote = False
        self._heartbeat_thread = None
        self._heartbeat_stop = threading.Event()
        self._heartbeat_paused = threading.Event()
        self._server = FramedServer(self._serve_connection, host=host, port=port,
                                    name=f"service-worker-{self.worker_id}")

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self.num_pieces = self._count_pieces()
        if self._transport_mode != "tcp" and self._batch_cache is not None:
            # The cache's entries are placed in a shared frame pool, so a
            # warm piece travels as (offset, len) references; armed before
            # any fill. A pool that cannot be set up leaves shm streams
            # serving copies.
            from petastorm_tpu_torch.service.shm_ring import FramePool, ShmSetupError

            try:
                self._frame_pool = FramePool()
            except ShmSetupError as exc:
                logger.warning("shm frame pool setup failed: warm serves will copy instead "
                               "of map: %s", exc)
            else:
                self._batch_cache.set_frame_allocator(self._frame_pool.allocate)
        self._server.start()
        if self._dispatcher_address is not None:
            try:
                self._register()
            except BaseException:
                self._server.stop()
                raise
            if self._heartbeat_interval_s is not None:
                self._heartbeat_thread = threading.Thread(
                    target=self._heartbeat_loop, daemon=True,
                    name=f"service-worker-{self.worker_id}-heartbeat")
                self._heartbeat_thread.start()
        return self

    @property
    def address(self):
        return self._server.address

    def stop(self, drain_timeout_s=5.0):
        """Close the listener and the connections first (stream threads
        blocked in ``recv`` / ``send`` exit on the closed sockets), wait up
        to ``drain_timeout_s`` for the stream threads, then stop any reader
        a straggler left behind."""
        self._server.stopped.set()
        self._heartbeat_stop.set()
        self._server.stop()
        stragglers = self._server.join(timeout=drain_timeout_s)
        if stragglers:
            logger.warning("%d stream thread(s) still alive after the %.1fs stop drain — "
                           "stopping their readers under them", len(stragglers),
                           drain_timeout_s)
        with self._lock:
            readers = [entry["reader"] for entry in self._active.values()
                       if entry["reader"] is not None]
        for reader in readers:
            try:
                reader.stop()
            except Exception:
                logger.warning("straggler stream reader stop failed", exc_info=True)
        if self._batch_cache is not None:
            try:
                self._batch_cache.cleanup()
            except Exception:
                logger.warning("batch cache cleanup failed", exc_info=True)
        if self._frame_pool is not None:
            # After the cache's cleanup: entries on pool memory go first.
            self._batch_cache.set_frame_allocator(None)
            self._frame_pool.close()
            self._frame_pool = None
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=drain_timeout_s)
        if self._handoff_thread is not None:
            # The tier's cleanup above closed its pushes: a straggling
            # hand-off ends on its next failed request.
            self._handoff_thread.join(timeout=drain_timeout_s)
        if self._trace_armed_remote:
            self._trace_armed_remote = False
            tracing.COLLECTOR.release()

    def kill(self):
        """Abrupt failure (tests): drop every connection without an ``end``
        and tear down, as a worker host dying looks to its clients."""
        self._server.stopped.set()
        self._heartbeat_stop.set()
        self._server.close_connections()
        self.stop()

    def drop_connections(self):
        """Drop every open connection and keep serving (a network blip:
        clients reconnect and re-stream)."""
        self._server.close_connections()

    def pause_heartbeats(self):
        """Stop renewing the lease while serving (a hung worker, for tests:
        lease expiry, not a broken connection, evicts it)."""
        self._heartbeat_paused.set()

    def resume_heartbeats(self):
        self._heartbeat_paused.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

    # -- registration ------------------------------------------------------

    def _count_pieces(self):
        """The dataset's row-group pieces under the planning arguments every
        stream reader uses: the count the dispatcher's plan is in. Their
        ``(path, row_group)`` identities are the cache key's content
        signature (a re-written dataset under the same URL misses)."""
        from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
        from petastorm_tpu_torch.reader.reader import enumerate_row_group_pieces

        fs, path = get_filesystem_and_path_or_paths(
            self.dataset_url, storage_options=self._reader_kwargs.get("storage_options"),
            filesystem=self._reader_kwargs.get("filesystem"))
        pieces = enumerate_row_group_pieces(fs, path, self._reader_kwargs.get("filters"))
        self._piece_signatures = [(piece.path, piece.row_group) for piece in pieces]
        return len(pieces)

    def _register(self, re_register=False, retries=None):
        host, port = self.address
        payload = {"type": "register_worker", "worker_id": self.worker_id, "host": host,
                   "port": port, "num_pieces": self.num_pieces, "re_register": re_register,
                   "standby": self._standby, "corpus": self.corpus,
                   "cache_fleet": self._fleet_tier is not None}
        if self.metrics_port is not None:
            payload["metrics_port"] = self.metrics_port
        reply = self._control_rpc(payload, f"worker {self.worker_id} registration",
                                  retries=retries)
        if reply.get("type") != "ok":
            raise RuntimeError(f"dispatcher rejected registration: "
                               f"{reply.get('error', reply)}")
        if self._fleet_tier is not None and reply.get("cache_peers") is not None:
            self._update_cache_peers(reply["cache_peers"])
        return reply

    def _update_cache_peers(self, peers):
        try:
            self._fleet_tier.update_peers(peers)
        except (ValueError, TypeError):
            logger.warning("worker %s: malformed cache_peers from the dispatcher — keeping "
                           "the previous ring", self.worker_id, exc_info=True)

    def _control_rpc(self, header, description, retries=None):
        """One control request / reply under the retry policy (bounded
        attempts, backoff with jitter, ``rpc_deadline_s`` in all)."""
        from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
        from petastorm_tpu_torch.utils import retry_with_backoff

        header.setdefault("trace", {"peer": self.worker_id})

        def attempt():
            with FramedConnection.connect(self._dispatcher_address, timeout=10.0) as conn:
                reply, _ = conn.request(header)
            if reply.get("type") == "error" and reply.get("retryable"):
                raise OSError(reply.get("error", "dispatcher degraded"))
            return reply

        return retry_with_backoff(
            attempt, retries=self._register_retries if retries is None else retries,
            base_delay=self._register_backoff, retry_on=(OSError, ProtocolError),
            deadline_s=self._rpc_deadline_s, description=description)

    def _heartbeat_loop(self):
        """Renew the lease every ``heartbeat_interval_s``; an
        ``unknown_worker`` reply (the dispatcher restarted without this
        worker, or evicted it) re-registers under the same id. A missed
        tick is retried at the next one."""
        while not self._heartbeat_stop.wait(self._heartbeat_interval_s):
            if self._heartbeat_paused.is_set():
                continue
            fp = failpoints.ACTIVE
            if fp is not None and fp.check("worker.heartbeat") == "drop":
                continue  # a lost tick: the lease absorbs it
            try:
                # One dial (retries=0), so [t0, t1] brackets one round trip:
                # the clock sample that aligns this worker's spans.
                t0 = time.perf_counter()
                reply = self._control_rpc(
                    {"type": "worker_heartbeat", "worker_id": self.worker_id,
                     "credit_wait_s": round(self._m_credit_wait.value, 4)},
                    f"worker {self.worker_id} heartbeat", retries=0)
                t1 = time.perf_counter()
            except (OSError, ProtocolError):
                continue
            remote_us = reply.get("dispatcher_time_us")
            if remote_us is not None:
                self._clock.add(tracing.COLLECTOR.ts_us((t0 + t1) / 2.0), float(remote_us),
                                (t1 - t0) * 1e6)
            self._sync_trace_arming(bool(reply.get("trace")))
            if self._fleet_tier is not None:
                if reply.get("cache_peers") is not None:
                    self._update_cache_peers(reply["cache_peers"])
                self._sync_fleet_state(reply.get("worker_state"))
            if "brownout_level" in reply:
                note_brownout_level(reply["brownout_level"])
            if reply.get("type") == "unknown_worker" and not self._heartbeat_stop.is_set():
                logger.warning("dispatcher no longer knows worker %s — re-registering",
                               self.worker_id)
                try:
                    self._register(re_register=True, retries=0)
                except (OSError, RuntimeError, ProtocolError):
                    continue

    # -- the fleet cache tier ----------------------------------------------

    def _sync_fleet_state(self, state):
        """Follow the lifecycle state the dispatcher reports: the serving →
        draining edge starts the warm hand-off once per drain, on a thread
        of its own (the heartbeats must keep renewing the lease meanwhile)."""
        if state is None:
            return
        previous, self._fleet_state = self._fleet_state, state
        if (state == "draining" and previous not in (None, "draining")
                and (self._handoff_thread is None or not self._handoff_thread.is_alive())):
            self._handoff_thread = threading.Thread(
                target=self._run_handoff, daemon=True,
                name=f"cache-peer-handoff-{self.worker_id}")
            self._handoff_thread.start()

    def _run_handoff(self):
        try:
            summary = self._fleet_tier.handoff()
        except Exception:
            logger.warning("worker %s: warm hand-off failed — the inheriting peers will "
                           "decode", self.worker_id, exc_info=True)
            return
        logger.info("worker %s: warm hand-off shipped %d entries (%d bytes) to %d peer(s)%s",
                    self.worker_id, summary["entries"], summary["bytes"],
                    len(summary["peers"]), " [torn]" if summary["torn"] else "")
        try:
            self._control_rpc({"type": "cache_handoff", "worker_id": self.worker_id,
                               **{k: summary[k] for k in ("entries", "bytes", "peers",
                                                          "errors", "torn")}},
                              f"worker {self.worker_id} hand-off report", retries=0)
        except (OSError, ProtocolError):
            logger.warning("worker %s: the hand-off report did not reach the dispatcher (the "
                           "hand-off itself completed)", self.worker_id, exc_info=True)

    def _handle_cache_fetch(self, sock, header):
        """A peer asks for a warm entry: its meta and its one contiguous
        buffer, or a miss."""
        if self._fleet_tier is None:
            send_framed(sock, {"type": "error", "error": "fleet cache tier not armed"})
            return
        reply, payload = self._fleet_tier.serve_fetch(str(header.get("key")))
        send_framed(sock, reply, payload)

    def _handle_cache_put(self, sock, header, payload):
        """A peer ships an entry here (placement or a drain hand-off); a
        payload that disagrees with its meta is refused, never published."""
        if self._fleet_tier is None:
            send_framed(sock, {"type": "error", "error": "fleet cache tier not armed"})
            return
        try:
            entry = self._fleet_tier.adopt(str(header.get("key")), header.get("meta") or [],
                                           (payload or {}).get("buf", b""),
                                           origin=str(header.get("origin", "placement")))
        except (ValueError, KeyError, TypeError) as exc:
            send_framed(sock, {"type": "error", "error": f"cache_put refused: {exc}"})
            return
        send_framed(sock, {"type": "ok", "key": header.get("key"), "rows": entry.rows})

    # -- fleet tracing -----------------------------------------------------

    def _sync_trace_arming(self, armed):
        """Follow the dispatcher's heartbeat-borne tracing flag: arm the
        collector when the fleet arms, push the ring (ship-and-clear) with
        the clock offset each armed tick, release on disarm. A failed push
        loses that tick's spans."""
        if armed and not self._trace_armed_remote:
            self._trace_armed_remote = True
            tracing.COLLECTOR.acquire()
            logger.info("worker %s: fleet tracing armed by the dispatcher", self.worker_id)
        elif not armed and self._trace_armed_remote:
            self._trace_armed_remote = False
            tracing.COLLECTOR.release()
            return
        if not self._trace_armed_remote:
            return
        events, dropped = tracing.COLLECTOR.ship()
        if not events and not dropped:
            return
        try:
            self._control_rpc({"type": "trace_push", "peer": self.worker_id,
                               "events": events, "dropped": dropped,
                               "offset_us": self._clock.offset_us(),
                               "min_rtt_us": self._clock.min_rtt_us()},
                              f"worker {self.worker_id} trace push", retries=0)
        except (OSError, ProtocolError):
            pass  # the next tick ships the new ring

    def _trace_snapshot(self):
        """One pull of the span ring for the dispatcher's ``trace collect``:
        ship-and-clear while the fleet armed it, else read without
        clearing (a local exporter keeps its ring)."""
        if self._trace_armed_remote:
            events, dropped = tracing.COLLECTOR.ship()
        else:
            events, dropped = tracing.COLLECTOR.events(), tracing.COLLECTOR.dropped
        return {"type": "trace", "worker_id": self.worker_id, "events": events,
                "dropped": dropped, "offset_us": self._clock.offset_us(),
                "min_rtt_us": self._clock.min_rtt_us()}

    # -- serving -----------------------------------------------------------

    def _serve_connection(self, sock):
        reader = FramedReader(sock, max_frame_bytes=self._max_frame_bytes)
        while not self._server.stopped.is_set():
            header, payload = reader.recv()
            kind = header.get("type")
            if kind == "stream":
                self._stream(sock, header, reader)
            elif kind == "credit":
                pass  # a replenishment that raced the stream's end
            elif kind == "diagnostics":
                send_framed(sock, {"type": "diagnostics", "worker_id": self.worker_id},
                            self.diagnostics_snapshot())
            elif kind == "cache_fetch":
                self._handle_cache_fetch(sock, header)
            elif kind == "cache_put":
                self._handle_cache_put(sock, header, payload)
            elif kind == "trace":
                send_framed(sock, self._trace_snapshot())
            elif kind == "ping":
                send_framed(sock, {"type": "pong", "worker_id": self.worker_id})
            else:
                send_framed(sock, {"type": "error", "error": f"unknown request {kind!r}"})

    def _refusal(self, header):
        """The error text for a stream this worker cannot serve, or None."""
        if header.get("packing") is not None:
            if not (header.get("dynamic") or header.get("tagged")) \
                    or not self._engine_supported():
                return ("stream requested packing but this serving path cannot pack: "
                        "packing runs inside the streaming piece engine (tagged/dynamic "
                        "protocols, reader_pool_type='thread') — use static or dynamic "
                        "sharding, or pack trainer-side (packing_placement='trainer')")
            if self._batch_transform is not None \
                    and header.get("transform_placement") != "local":
                return ("stream requested packing but this worker has a batch_transform "
                        "armed remote-side: the transform is a row-batch stage and packing "
                        "changes the batch vocabulary — run the transform trainer-side "
                        "(transform_placement='local') or drop --batch-transform")
        if header.get("transform_placement") == "remote" and self._batch_transform is None:
            return ("stream requested transform_placement='remote' but this worker has no "
                    "batch_transform armed — start it with --batch-transform module:attr "
                    "(the same callable the client's transform= uses), or run the client "
                    "with transform_placement='local'")
        return None

    def _stream_rewrites(self, header):
        """A stream's graph rewrites, parsed and checked: ``(rewrites,
        columnar_path)``, or ``(error text, None)``. ``columnar_path`` is
        the label this stream's batches count under in
        ``petastorm_columnar_batches_total`` (None: no family asked for)."""
        dynamic, tagged = bool(header.get("dynamic")), bool(header.get("tagged"))
        fused = bool(header.get("fused"))
        cache_stage = header.get("cache_stage") or "post-transform"
        predicate = None
        if header.get("predicate") is not None:
            from petastorm_tpu_torch.predicates import ColumnPredicate

            try:
                predicate = ColumnPredicate.from_wire(header["predicate"])
            except ValueError as exc:
                return f"bad stream predicate: {exc}", None
            if self._reader_kwargs.get("predicate") is not None:
                return ("stream carries a predicate but this worker was constructed with "
                        "reader_kwargs['predicate'] — one row filter per stream: drop one "
                        "of the two"), None
        projection = ([str(f) for f in header["projection"]]
                      if header.get("projection") else None)
        if cache_stage not in CACHE_STAGES:
            return f"unknown cache_stage {cache_stage!r} (post-transform|post-decode)", None
        family = header.get("reader_family")
        if family not in (None, "row", "columnar"):
            return f"unknown reader_family {family!r} (row|columnar)", None
        engine = (dynamic or tagged or self._batch_cache is not None) \
            and self._engine_supported()
        swap, effective = self._resolve_stream_family(family, engine)
        columnar_path = None
        if effective == "columnar":
            columnar_path = "columnar"
        elif family == "columnar":
            columnar_path = "row_fallback"
            logger.warning("stream requested reader_family='columnar' but this serving path "
                           "cannot vectorize (constructed family %r); serving the row path, "
                           "decoded bytes are identical", self._factory_name)
        rewriting = (fused or predicate is not None or projection is not None
                     or cache_stage != "post-transform")
        if rewriting and not engine:
            return ("stream requested a graph rewrite (fused/predicate/projection/"
                    "cache_stage) but this serving path cannot apply it: rewrites run "
                    "inside the streaming piece engine (tagged/dynamic protocols, "
                    "reader_pool_type='thread') — use static or dynamic sharding"), None
        return {"fused": fused, "predicate": predicate, "projection": projection,
                "cache_stage": cache_stage, "family": swap}, columnar_path

    def _resolve_stream_family(self, requested, engine):
        """``(swap, effective)`` for a stream's requested decode family:
        ``swap`` is the factory the engine's reader is built with (None:
        the constructed one serves, or the request cannot be honored),
        ``effective`` the family that decodes. A swap needs the engine (it
        builds a reader a stream); a batch-family worker has nothing to
        vectorize; an NGram or a row-level ``transform_spec`` is per row."""
        constructed = self._factory_name
        if requested is None or requested == constructed:
            return None, constructed
        if not engine or constructed not in ("row", "columnar"):
            return None, constructed
        if requested == "columnar" and (self._reader_kwargs.get("ngram") is not None
                                        or self._reader_kwargs.get("transform_spec")
                                        is not None):
            return None, constructed
        return requested, requested

    def _stream(self, sock, header, conn_reader):
        """Serve one ``stream`` request: batches of the named pieces, then
        ``end``. A reader or collation error becomes an ``error`` message
        (the client raises it); a client hang-up ends the stream. A
        request whose propagated deadline expired before it was read is
        refused (retryable) before a reader is built. Once the transport is
        negotiated every frame of the stream goes through ``tx`` (TCP or
        the shm ring); the client's credits and queue edits stay on TCP."""
        from petastorm_tpu_torch.service.transport import negotiate_worker_tx

        if deadline_expired(arrival_deadline(header)):
            send_framed(sock, deadline_exceeded_reply("worker.stream"))
            return
        refusal = self._refusal(header)
        rewrites = columnar_path = None
        if refusal is None:
            rewrites, columnar_path = self._stream_rewrites(header)
            if isinstance(rewrites, str):
                refusal = rewrites
        if refusal is not None:
            send_framed(sock, {"type": "error", "error": refusal})
            return
        dynamic = bool(header.get("dynamic"))
        tagged = bool(header.get("tagged"))
        packing = (PackingSpec.from_dict(header["packing"])
                   if header.get("packing") is not None else None)
        transform_fn = None
        if self._batch_transform is not None \
                and header.get("transform_placement") != "local":
            batch_transform, observe = self._batch_transform, self._m_transform.observe

            def transform_fn(batch):
                t0 = time.perf_counter()
                out = batch_transform(batch)
                observe(time.perf_counter() - t0)
                return out
        shuffle_seed = header.get("shuffle_seed")
        shuffle_seed = int(shuffle_seed) if shuffle_seed is not None else None
        starts = {int(p): int(s) for p, s in (header.get("starts") or {}).items()}
        if dynamic:
            pieces = [(int(t[0]), int(t[1]), int(t[2]) if len(t) > 2 else 0)
                      for t in header["pieces"]]
        else:
            pieces = [int(p) for p in header["pieces"]]
        credits = header.get("credits")
        credits = int(credits) if credits is not None else None
        flow = {"credits_window": credits, "credits_left": credits, "batches_sent": 0,
                "credit_wait_s": 0.0}
        # The request's job buckets this stream's rows and cache lookups
        # (the finished stream's snapshot keeps it).
        job = str(header["job_id"]) if header.get("job_id") else None
        if job is not None:
            flow["job"] = job
        if columnar_path is not None:
            flow["columnar_path"] = columnar_path
        stream_key = uuid.uuid4().hex[:8]
        state = {"reader": None, "flow": flow}
        outcome = "aborted"  # until the `end` frame is sent
        with self._lock:
            self._active[stream_key] = state
        self._m_active.inc()
        epoch = header.get("epoch")
        tx = None
        try:
            tx, extra_credits, early_frames = negotiate_worker_tx(
                sock, conn_reader, header, self._transport_mode, pool=self._frame_pool)
            if credits is not None and extra_credits:
                flow["credits_left"] += extra_credits
            with self._lock:
                self._transport_streams[tx.transport] += 1
            common = dict(epoch=epoch, shuffle_seed=shuffle_seed, transform_fn=transform_fn,
                          rewrites=rewrites, job=job, packing=packing)
            if dynamic:
                rows_sent = self._stream_dynamic(tx, conn_reader, state, pieces, flow, credits,
                                                 stream_key, early_frames=early_frames,
                                                 **common)
            elif tagged and self._engine_supported():
                rows_sent = self._stream_pieces_tagged(tx, conn_reader, state, pieces, flow,
                                                       credits, stream_key, starts, **common)
            elif tagged:
                rows_sent = self._stream_pieces_tagged_reader(
                    tx, conn_reader, state, pieces, flow, credits, stream_key, starts,
                    epoch=epoch, shuffle_seed=shuffle_seed, transform_fn=transform_fn)
            elif self._batch_cache is not None and self._engine_supported():
                # Untagged and cached: the same engine loop, without tags.
                rows_sent = self._stream_pieces_tagged(tx, conn_reader, state, pieces, flow,
                                                       credits, stream_key, {}, tagged=False,
                                                       **common)
            else:
                if shuffle_seed is not None:
                    logger.warning(
                        "stream requested shuffle_seed=%s but intra-piece batches will "
                        "serve in canonical order: the stream is untagged, so it serves "
                        "through the plain whole-set reader", shuffle_seed)
                if self._batch_cache is not None:
                    rows_sent = self._stream_pieces_cached(
                        tx, conn_reader, state, pieces, flow, credits, stream_key,
                        epoch=epoch, transform_fn=transform_fn, job=job)
                else:
                    rows_sent = self._stream_pieces_direct(
                        tx, conn_reader, state, pieces, flow, credits, stream_key,
                        transform_fn=transform_fn)
            if rows_sent is None:
                return  # the worker stopped mid-stream
            tx.send({"type": "end", "rows": rows_sent, "pieces": pieces})
            outcome = "completed"
        except (ConnectionClosedError, OSError, ProtocolError):
            outcome = "disconnected"
            raise  # the client hung up (or desynced): nothing to tell it
        except Exception as exc:
            outcome = "error"
            logger.exception("stream %s failed (pieces %s)", stream_key, pieces)
            # Through tx: after an shm offer the client reads the ring.
            if tx is not None:
                tx.send({"type": "error", "error": str(exc)})
            else:
                send_framed(sock, {"type": "error", "error": str(exc)})
        finally:
            if tx is not None:
                # A ring is the stream's: detach (the consumer drains every
                # committed record first) and unmap. TCP's close does nothing.
                try:
                    tx.close()
                except Exception:
                    logger.warning("stream transport close failed", exc_info=True)
            with self._lock:
                self._active.pop(stream_key, None)
                reader = state["reader"]
                snapshot = dict(reader.diagnostics) if reader is not None else {}
                self._completed[stream_key] = dict(snapshot, **flow)
                while len(self._completed) > _COMPLETED_SNAPSHOTS_KEPT:
                    self._completed.pop(next(iter(self._completed)))
                if job is not None and flow.get("job_batches"):
                    # Folded once a stream (pop and reinsert: an LRU touch,
                    # so an active job is never the one evicted).
                    counts = self._jobs_served.pop(job, {"rows": 0, "batches": 0})
                    counts["rows"] += flow.get("job_rows", 0)
                    counts["batches"] += flow["job_batches"]
                    self._jobs_served[job] = counts
                    while len(self._jobs_served) > self._JOBS_TRACKED_KEPT:
                        old_job = next(iter(self._jobs_served))
                        self._jobs_served.pop(old_job)
                        FLEET_JOB_ROWS.remove(old_job)
            self._m_active.dec()
            WORKER_STREAMS.labels(self.worker_id, outcome).inc()
            if reader is not None:
                reader.stop()
                reader.join()

    def _make_stream_reader(self, pieces):
        """One reader over ``pieces`` in ascending order; sharding pinned
        off (the dispatcher's plan is the only sharding a worker applies)."""
        self._m_readers.inc()
        return self._factory(self.dataset_url, piece_indices=pieces, num_epochs=1,
                             shuffle_row_groups=False, cur_shard=0, shard_count=1,
                             **self._reader_kwargs)

    def _stream_pieces_direct(self, tx, conn_reader, state, pieces, flow, credits,
                              stream_key, transform_fn=None):
        """Untagged serving: one reader over the piece set, batches
        collated across piece boundaries. Rows sent, or None when the
        worker stopped mid-stream."""
        from petastorm_tpu_torch.torch_utils.batcher import batch_iterator

        reader = self._make_stream_reader(pieces)
        with self._lock:
            state["reader"] = reader
        rows_sent = 0
        batches = iter(batch_iterator(reader, self._batch_size, last_batch="keep"))
        collector = tracing.COLLECTOR
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            if batch is None:
                return rows_sent
            self._m_decode.observe(t1 - t0)
            bid = f"{self.worker_id}:{stream_key}:{flow['batches_sent']}"
            if collector.enabled:
                collector.record_span("worker.decode", t0, t1, bid=bid)
            if transform_fn is not None:
                batch = transform_fn(batch)
            rows = _batch_rows(batch)
            fmt, frames = encode_payload(batch)
            if not self._send_stream_batch(tx, conn_reader, flow, credits, bid, rows,
                                           fmt, frames):
                return None
            rows_sent += rows

    def _stream_pieces_cached(self, tx, conn_reader, state, pieces, flow, credits,
                              stream_key, epoch=None, transform_fn=None, job=None):
        """Untagged cached serving for a process pool (no engine): a warm
        piece is sent from the cache's frames, a cold one is read through a
        reader of its own, each batch encoded once for the send and the
        fill. A stream stopped mid-piece publishes nothing of it."""
        from petastorm_tpu_torch.torch_utils.batcher import batch_iterator

        cache, collector, rows_sent = self._batch_cache, tracing.COLLECTOR, 0
        for piece in pieces:
            key = self._piece_cache_key(piece, transformed=transform_fn is not None)
            entry = cache.get(key)
            self._note_cache_lookup(epoch, hit=entry is not None, job=job)
            if entry is not None:
                for cached in entry.batches():
                    bid = f"{self.worker_id}:{stream_key}:{flow['batches_sent']}"
                    if not self._send_stream_batch(tx, conn_reader, flow, credits, bid,
                                                   cached.rows, cached.fmt, cached.frames):
                        return None
                    rows_sent += cached.rows
                continue
            reader = self._make_stream_reader([piece])
            with self._lock:
                state["reader"] = reader
            builder = cache.begin_fill(key)
            try:
                batches = iter(batch_iterator(reader, self._batch_size, last_batch="keep"))
                while True:
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    t1 = time.perf_counter()
                    if batch is None:
                        break
                    self._m_decode.observe(t1 - t0)
                    bid = f"{self.worker_id}:{stream_key}:{flow['batches_sent']}"
                    if collector.enabled:
                        collector.record_span("worker.decode", t0, t1, bid=bid)
                    if transform_fn is not None:
                        batch = transform_fn(batch)
                    rows, fmt, frames = builder.add_batch(batch)
                    if not self._send_stream_batch(tx, conn_reader, flow, credits, bid, rows,
                                                   fmt, frames):
                        return None
                    rows_sent += rows
                builder.commit()
            finally:
                with self._lock:
                    state["reader"] = None
                reader.stop()
                reader.join()
        return rows_sent

    # -- the streaming piece engine's paths --------------------------------

    def _engine_supported(self):
        """The engine needs per-item completion attribution, which only the
        thread and dummy reader pools have."""
        return self._reader_kwargs.get("reader_pool_type", "thread") in ("thread", "dummy")

    def _make_engine(self, epoch, shuffle_seed=None, transform_fn=None,
                     allow_quarantine=False, rewrites=None, job=None, packing=None):
        """One engine for a whole stream over one lazily built
        ``dynamic_ventilation=True`` reader (a warm stream builds none).
        ``shuffle_seed`` arms the serve-time batch permutation
        ``seedtree.batch_permutation(seed, epoch, piece, n)``: pure, so
        every re-serve replays the same order against the same watermarks.
        ``rewrites``: the stream's predicate (below decode), projection
        (the fields read), fusion, cache stage and family swap; each is in
        the cache key, so entries of two topologies never cross. ``packing``
        (a :class:`PackingSpec`) packs each piece with a fresh worker-placed
        :class:`StreamPacker`; the spec is in the cache key too."""
        from petastorm_tpu_torch.service.piece_engine import StreamingPieceEngine
        from petastorm_tpu_torch.service.seedtree import batch_permutation

        rewrites = dict(rewrites or {})
        predicate, projection = rewrites.get("predicate"), rewrites.get("projection")
        cache_stage = rewrites.get("cache_stage") or "post-transform"
        family = rewrites.get("family")
        factory = _resolve_factory(family) if family else self._factory
        family_name = family or self._factory_name
        reader_kwargs = dict(self._reader_kwargs)
        if predicate is not None:
            reader_kwargs["predicate"] = predicate
        if projection is not None:
            reader_kwargs["schema_fields"] = list(projection)

        def build_reader():
            self._m_readers.inc()
            return factory(self.dataset_url, dynamic_ventilation=True, num_epochs=1,
                           shuffle_row_groups=False, cur_shard=0, shard_count=1,
                           **reader_kwargs)

        permute_fn = None
        if shuffle_seed is not None:
            seed, epoch_number = int(shuffle_seed), int(epoch or 0)

            def permute_fn(piece, n):
                return batch_permutation(seed, epoch_number, piece, n)

        cache = self._batch_cache
        # Post-decode entries hold the bytes before the transform, so their
        # key says "untransformed": a placement flip refills.
        transformed = transform_fn is not None and cache_stage == "post-transform"
        packer_factory = None
        if packing is not None:
            def packer_factory():
                return StreamPacker(packing, placement="worker")
        # Quarantine needs a frame that can say "piece_failed": only the
        # tagged and dynamic protocols have one.
        return StreamingPieceEngine(
            build_reader, self._batch_size, cache=cache,
            cache_key_fn=((lambda piece: self._piece_cache_key(
                piece, transformed=transformed, packing=packing, predicate=predicate,
                projection=projection, family=family_name)) if cache is not None else None),
            cache_note_fn=((lambda hit: self._note_cache_lookup(epoch, hit, job=job))
                           if cache is not None else None),
            permute_fn=permute_fn, transform_fn=transform_fn, packer_factory=packer_factory,
            fused=bool(rewrites.get("fused")), cache_stage=cache_stage,
            handoff_note_fn=self._m_handoff.inc,
            columnar_collate=family_name == "columnar",
            on_piece_error=self._on_piece_error if allow_quarantine else "fail")

    def _note_engine_decode(self, collector, decode_s, bid):
        """An engine event carries its decode duration: anchor the span to
        end at the dequeue, before this batch's send."""
        if not decode_s:
            return
        self._m_decode.observe(decode_s)
        if collector.enabled:
            t_now = time.perf_counter()
            collector.record_span("worker.decode", t_now - decode_s, t_now, bid=bid)

    def _stream_pieces_tagged(self, tx, conn_reader, state, pieces, flow, credits,
                              stream_key, starts, epoch=None, shuffle_seed=None,
                              transform_fn=None, rewrites=None, tagged=True, job=None,
                              packing=None):
        """Exactly-once static serving through the engine: piece-aligned
        batches tagged with their piece and ordinal, a ``piece_done`` frame
        after each piece (``piece_failed`` in its place under quarantine).
        The engine skip-scans past each piece's ``starts`` watermark.
        ``tagged=False``: the untagged cached stream (no tags, no markers)."""
        collector = tracing.COLLECTOR
        engine = self._make_engine(epoch, shuffle_seed, transform_fn, allow_quarantine=tagged,
                                   rewrites=rewrites, job=job, packing=packing)
        with self._lock:
            # Reader-shaped for diagnostics and teardown (stop / join).
            state["reader"] = engine
        for piece in pieces:
            engine.enqueue(piece, 0, start=starts.get(int(piece), 0))
        engine.finish()
        rows_sent = 0
        while True:
            if self._server.stopped.is_set():
                return None
            event = engine.next_event(timeout=0.1)
            if event is None:
                if engine.finished:
                    return rows_sent
                continue
            if event[0] == "batch":
                _, piece, _gen, ordinal, rows, fmt, frames, decode_s = event
                bid = f"{self.worker_id}:{stream_key}:{flow['batches_sent']}"
                self._note_engine_decode(collector, decode_s, bid)
                if not self._send_stream_batch(
                        tx, conn_reader, flow, credits, bid, rows, fmt, frames,
                        extra_header={"piece": piece, "ordinal": ordinal} if tagged else None):
                    return None
                rows_sent += rows
            elif event[0] == "piece_failed":
                _, piece, _gen, error = event
                tx.send({"type": "piece_failed", "piece": piece, "error": error})
            elif tagged:
                _, piece, _gen, rows = event
                tx.send({"type": "piece_done", "piece": piece, "rows": rows})

    def _stream_dynamic(self, tx, conn_reader, state, pieces, flow, credits, stream_key,
                        epoch=None, shuffle_seed=None, transform_fn=None, rewrites=None,
                        early_frames=(), job=None, packing=None):
        """Dynamic serving: the engine's queue is the worker's deque, edited
        in-band: ``extend`` appends steal grants, ``revoke`` removes unsent
        pieces (acked with the ones removed, which makes the client's
        revoke-then-extend handshake exactly once), ``finish_pieces`` closes
        the queue. Batches carry their piece, generation and ordinal; each
        finished piece is announced with ``piece_done``. ``early_frames``:
        queue edits that raced the shm ack, replayed first."""
        if not self._engine_supported():
            raise ValueError(
                "dynamic streams need the streaming piece engine, which requires "
                "reader_pool_type='thread' (or 'dummy') — this worker runs "
                f"{self._reader_kwargs.get('reader_pool_type')!r}")
        collector = tracing.COLLECTOR
        engine = self._make_engine(epoch, shuffle_seed, transform_fn, allow_quarantine=True,
                                   rewrites=rewrites, job=job, packing=packing)
        with self._lock:
            state["reader"] = engine
        for piece, gen, start in pieces:
            engine.enqueue(piece, gen, start=start)

        def on_frame(msg):
            kind = msg.get("type")
            if kind == "extend":
                for entry in msg.get("pieces", []):
                    engine.enqueue(int(entry[0]), int(entry[1]),
                                   start=int(entry[2]) if len(entry) > 2 else 0)
            elif kind == "revoke":
                removed = engine.revoke(int(p) for p in msg.get("pieces", []))
                tx.send({"type": "revoked", "pieces": removed, "req": msg.get("req")})
            elif kind == "finish_pieces":
                engine.finish()

        for msg in early_frames:
            on_frame(msg)
        rows_sent = 0
        while True:
            if self._server.stopped.is_set():
                return None
            while conn_reader.data_pending():
                msg, _ = conn_reader.recv()
                if msg.get("type") == "credit":
                    flow["credits_left"] += int(msg.get("n", 1))
                else:
                    on_frame(msg)
            event = engine.next_event(timeout=0.02)
            if event is None:
                if engine.finished:
                    return rows_sent
                continue
            if event[0] == "batch":
                _, piece, gen, ordinal, rows, fmt, frames, decode_s = event
                bid = f"{self.worker_id}:{stream_key}:{flow['batches_sent']}"
                self._note_engine_decode(collector, decode_s, bid)
                if not self._send_stream_batch(
                        tx, conn_reader, flow, credits, bid, rows, fmt, frames,
                        extra_header={"piece": piece, "generation": gen, "ordinal": ordinal},
                        on_frame=on_frame):
                    return None
                rows_sent += rows
            elif event[0] == "piece_failed":
                _, piece, gen, error = event
                tx.send({"type": "piece_failed", "piece": piece, "generation": gen,
                         "error": error})
            else:
                _, piece, gen, rows = event
                tx.send({"type": "piece_done", "piece": piece, "generation": gen,
                         "rows": rows})

    def _stream_pieces_tagged_reader(self, tx, conn_reader, state, pieces, flow, credits,
                                     stream_key, starts, epoch=None, shuffle_seed=None,
                                     transform_fn=None):
        """Tagged serving for a process pool (no per-item completion marks,
        so no engine): one reader serves the stream; each of its work items
        is one piece, published whole, so the outputs consumed since the
        last recorded delivery are that delivery's piece. Batches below the
        piece's ``starts`` watermark (in the permuted order, with a
        ``shuffle_seed``) are skipped."""
        from petastorm_tpu_torch.service.seedtree import batch_permutation
        from petastorm_tpu_torch.torch_utils.batcher import batch_iterator

        if self._reader_kwargs.get("shuffle_row_drop_partitions", 1) != 1:
            raise ValueError("tagged streams serve whole pieces: shuffle_row_drop_partitions "
                             "must be 1")
        reader = self._make_stream_reader(pieces)
        with self._lock:
            state["reader"] = reader
        # Item keys index the reader's own (sorted) piece list.
        by_position = sorted(set(pieces))
        done = []
        reader._results_queue_reader.delivery_tracker.on_record = \
            lambda key, _rows: done.append(by_position[int(key.split(":")[0])])
        batched, ngram = reader.batched_output, getattr(reader, "ngram", None)
        rows_sent, pending, served, decode_s = 0, [], set(), 0.0
        outputs = iter(reader)
        while True:
            t0 = time.perf_counter()
            output = next(outputs, None)
            decode_s += time.perf_counter() - t0
            if output is not None:
                pending.append(output)
            if not done and output is not None:
                continue
            # A piece's outputs are complete (or the reader is: pieces whose
            # rows were all filtered out are done with none).
            finished = done[:] if done else sorted(set(pieces) - served)
            del done[:]
            for piece in finished:
                served.add(piece)
                batches = list(batch_iterator(_PieceOutputs(pending, batched, ngram),
                                              self._batch_size, last_batch="keep"))
                pending = []
                self._m_decode.observe(decode_s)  # the piece's reads and collation
                if tracing.COLLECTOR.enabled:
                    t_now = time.perf_counter()
                    tracing.COLLECTOR.record_span(
                        "worker.decode", t_now - decode_s, t_now,
                        bid=f"{self.worker_id}:{stream_key}:{flow['batches_sent']}")
                decode_s = 0.0
                order = (batch_permutation(shuffle_seed, int(epoch or 0), piece, len(batches))
                         if shuffle_seed is not None else range(len(batches)))
                piece_rows = 0
                for ordinal, source in enumerate(order):
                    if ordinal < starts.get(piece, 0):
                        continue
                    batch = batches[source]
                    if transform_fn is not None:
                        batch = transform_fn(batch)
                    rows = _batch_rows(batch)
                    fmt, frames = encode_payload(batch)
                    bid = f"{self.worker_id}:{stream_key}:{flow['batches_sent']}"
                    if not self._send_stream_batch(
                            tx, conn_reader, flow, credits, bid, rows, fmt, frames,
                            extra_header={"piece": piece, "ordinal": ordinal}):
                        return None
                    rows_sent += rows
                    piece_rows += rows
                tx.send({"type": "piece_done", "piece": piece, "rows": piece_rows})
            if output is None:
                return rows_sent

    def _send_stream_batch(self, tx, conn_reader, flow, credits, bid, rows, fmt, frames,
                           extra_header=None, on_frame=None):
        """Honor stop, drain and wait for credits, pace, send, account.
        False when the worker stopped (the stream ends without ``end``).
        ``on_frame`` takes the other control frames met while draining (a
        dynamic stream's queue edits must not be lost to a credit wait)."""
        if self._server.stopped.is_set():
            return False
        if credits is not None:
            # Drain replenishments every batch, not only when starved:
            # unread credit messages would fill the socket buffers until
            # the client's ack send blocks against this batch send.
            while conn_reader.data_pending():
                reply, _ = conn_reader.recv()
                if reply.get("type") == "credit":
                    flow["credits_left"] += int(reply.get("n", 1))
                elif on_frame is not None:
                    on_frame(reply)
            if flow["credits_left"] <= 0:
                t0 = time.perf_counter()
                while flow["credits_left"] <= 0:
                    if self._server.stopped.is_set():
                        return False
                    # A bounded wait, so a client host that vanished
                    # without FIN/RST cannot pin this thread.
                    if not conn_reader.wait_data(self.CREDIT_POLL_S):
                        continue
                    reply, _ = conn_reader.recv()
                    if reply.get("type") == "credit":
                        flow["credits_left"] += int(reply.get("n", 1))
                    elif on_frame is not None:
                        on_frame(reply)
                waited = time.perf_counter() - t0
                flow["credit_wait_s"] += waited
                self._m_credit_wait.inc(waited)
        if self._batch_delay_s:
            time.sleep(self._batch_delay_s)
        fp = failpoints.ACTIVE
        if fp is not None:
            # A straggler: "delay" stalls this worker's send, keyed by its id
            # so a targeted schedule slows one worker only.
            fp.fire("slow-peer", key=self.worker_id)
        t_send = time.perf_counter()
        header = {"type": "batch", "rows": rows, "bid": bid}
        if extra_header:
            header.update(extra_header)
        tx.send_frames(header, fmt, frames)
        if tracing.COLLECTOR.enabled:
            tracing.COLLECTOR.record_span("worker.send", t_send, time.perf_counter(), bid=bid)
        flow["batches_sent"] += 1
        self._m_batches.inc()
        self._m_rows.inc(rows)
        columnar_path = flow.get("columnar_path")
        if columnar_path is not None:
            self._m_columnar[columnar_path].inc()
        if flow.get("job") is not None:
            # Accumulated in the flow, folded into the worker's books once at
            # the stream's end: no worker lock a batch.
            FLEET_JOB_ROWS.labels(flow["job"]).inc(rows)
            flow["job_rows"] = flow.get("job_rows", 0) + rows
            flow["job_batches"] = flow.get("job_batches", 0) + 1
        if credits is not None:
            flow["credits_left"] -= 1
        return True

    #: Epochs whose cache lookups are kept for ``cache_stats_by_epoch``.
    _CACHE_EPOCHS_KEPT = 64
    #: Jobs whose rows and cache lookups are kept (the oldest, with its
    #: metric series, goes beyond it).
    _JOBS_TRACKED_KEPT = 64

    def _note_cache_lookup(self, epoch, hit, job=None):
        """One cache lookup, bucketed by the epoch of the stream that made
        it (the per-epoch cold and warm counts) and by its job (how many
        jobs one decode served)."""
        key = "hits" if hit else "misses"
        if job is not None:
            FLEET_JOB_CACHE_LOOKUPS.labels(job, "hit" if hit else "miss").inc()
            with self._lock:
                bucket = self._cache_jobs.pop(job, {"hits": 0, "misses": 0})
                bucket[key] += 1
                self._cache_jobs[job] = bucket
                while len(self._cache_jobs) > self._JOBS_TRACKED_KEPT:
                    old_job = next(iter(self._cache_jobs))
                    self._cache_jobs.pop(old_job)
                    FLEET_JOB_CACHE_LOOKUPS.remove(old_job, "hit")
                    FLEET_JOB_CACHE_LOOKUPS.remove(old_job, "miss")
        if epoch is None:
            return
        with self._lock:
            bucket = self._cache_epochs.setdefault(int(epoch), {"hits": 0, "misses": 0})
            bucket[key] += 1
            while len(self._cache_epochs) > self._CACHE_EPOCHS_KEPT:
                self._cache_epochs.pop(min(self._cache_epochs))

    def cache_stats_by_epoch(self):
        """``{epoch: {"hits", "misses"}}`` of recent epochs (empty uncached)."""
        with self._lock:
            return {epoch: dict(bucket) for epoch, bucket in self._cache_epochs.items()}

    def cache_stats_by_job(self):
        """``{job: {"hits", "misses"}}`` of the cache's lookups per job."""
        with self._lock:
            return {job: dict(bucket) for job, bucket in self._cache_jobs.items()}

    def rows_by_job(self):
        """``{job: {"rows", "batches"}}`` served per job (finished streams)."""
        with self._lock:
            return {job: dict(counts) for job, counts in self._jobs_served.items()}

    def cache_stats(self):
        """The batch cache's stats, or ``None`` without one."""
        return self._batch_cache.stats() if self._batch_cache is not None else None

    def _piece_cache_key(self, piece, transformed=False, packing=None, predicate=None,
                         projection=None, family=None):
        """The content key of one piece's batches: the JAX worker's key
        (same dataset, piece identity, batch size, fields, transforms,
        filter and family give the same string), so one cache directory
        serves workers of both packages."""
        from petastorm_tpu_torch.cache_impl import batch_fingerprint, predicate_ingredient

        kwargs = self._reader_kwargs
        signature = (self._piece_signatures[int(piece)]
                     if self._piece_signatures is not None
                     and int(piece) < len(self._piece_signatures) else int(piece))
        extra = {"filters": kwargs.get("filters"),
                 "predicate": repr(kwargs.get("predicate")),
                 "piece_index": int(piece),
                 "num_pieces": self.num_pieces,
                 "last_batch": "keep"}
        if self._batch_transform is not None:
            # Entries hold transformed bytes only when the stage ran here.
            extra["batch_transform"] = (_transform_identity(self._batch_transform)
                                        if transformed else None)
        if packing is not None:
            # Packed entries hold [slots, slot_len] frames: keyed on the
            # geometry, they never serve an unpacked stream or another shape.
            extra["packing"] = packing.key_dict()
        if predicate is not None:
            # A hoisted filter's entries hold only the surviving rows.
            extra["stream_predicate"] = predicate_ingredient(predicate)
        fields = kwargs.get("schema_fields")
        if projection is not None:
            fields = sorted(projection)
        return batch_fingerprint(self.dataset_url, [signature], self._batch_size,
                                 fields=fields, transform=kwargs.get("transform_spec"),
                                 factory=family or self._factory_name, extra=extra)

    def diagnostics_snapshot(self):
        """Each active stream's reader diagnostics merged with its flow
        state (credits window / left, batches sent, seconds waiting for
        credits), the final snapshots of recently finished streams, the
        worker's lifetime counters under ``metrics`` (the streams each
        transport served, the columnar batches and, with a cache, its hit
        and miss totals, its tier and entries) and the cache's stats under
        ``cache``; with job-tagged streams, ``jobs`` (rows and batches per job)
        and ``cache_by_job``."""
        with self._lock:
            active = {key: dict((entry["reader"].diagnostics
                                 if entry["reader"] is not None else {}), **entry["flow"])
                      for key, entry in self._active.items()}
            completed = {key: dict(diag) for key, diag in self._completed.items()}
            jobs_served = {job: dict(counts) for job, counts in self._jobs_served.items()}
            cache_jobs = {job: dict(bucket) for job, bucket in self._cache_jobs.items()}
            transport_streams = dict(self._transport_streams)
        metrics = {
            "batches_sent_total": self._m_batches.value,
            "rows_sent_total": self._m_rows.value,
            "credit_wait_seconds_total": self._m_credit_wait.value,
            "active_streams": self._m_active.value,
            "readers_constructed_total": self._m_readers.value,
            "transport_streams_tcp_total": transport_streams["tcp"],
            "transport_streams_shm_total": transport_streams["shm"],
            "columnar_batches_total": self._m_columnar["columnar"].value,
            "row_fallback_batches_total": self._m_columnar["row_fallback"].value,
        }
        out = {"worker_id": self.worker_id, "num_pieces": self.num_pieces,
               "active_streams": active, "completed_streams": completed,
               "metrics": metrics}
        if jobs_served:
            out["jobs"] = jobs_served
        if cache_jobs:
            out["cache_by_job"] = cache_jobs
        if self._batch_cache is not None:
            stats = self._batch_cache.stats()
            metrics["cache_hits_total"] = stats["hits"]
            metrics["cache_misses_total"] = stats["misses"]
            metrics["cache_permuted_serves_total"] = stats["permuted_serves"]
            # The CACHE column of status --watch: the tier, its entries and
            # the warmth that came from peers.
            metrics["cache_tier"] = stats.get("tier", "local")
            metrics["cache_entries_mem"] = stats["entries_mem"]
            metrics["cache_entries_disk"] = stats["entries_disk"]
            if "remote_hits" in stats:
                metrics["cache_remote_hits_total"] = stats["remote_hits"]
            out["cache"] = stats
        return out


def _batch_rows(batch):
    from petastorm_tpu_torch.cache_impl.batch_cache import batch_rows

    return batch_rows(batch)
