"""Trainer-side client of the data service (the port's own copy of
``petastorm_tpu/service/client.py``: static, fcfs and dynamic sharding).

:class:`ServiceBatchSource` is a zero-argument callable returning an
iterator of ``{field: ndarray}`` batches: the ``batch_source=`` of
:class:`~petastorm_tpu_torch.torch_utils.loader.TorchDataLoader`, so a
trainer swaps its local reader for remote workers by changing one argument
and keeps the loader's staging, prefetch and stall accounting.

Static mode is a multiplexed drain: one reader thread per worker stream
feeds one bounded ready-queue, and whichever worker is ready is consumed,
so a slow worker does not hold up batches its peers already sent. Credits
(``credits=``) bound each worker's unacknowledged batches; the client acks
one per consumed batch. Streams are tagged (batches carry ``(piece,
ordinal)``, each piece ends with ``piece_done``): the client keeps a
per-piece watermark, every re-serve starts each piece at it and a
sub-watermark arrival is dropped, so delivery is exactly once.
``ordered=True`` re-sequences delivery into the canonical order (pieces in
the seed-tree order of the dispatcher's ``shuffle_seed``, batches by
ordinal), so two runs yield the same batches in the same order.

A broken stream is retried against the same worker with backoff
(:func:`petastorm_tpu_torch.utils.retry_with_backoff`), each retry spending
the peer's retry budget; a worker that stays down, or whose circuit breaker
tripped (``breaker_threshold`` consecutive failures, reported to the
dispatcher, which routes new grants around it), is reported dead, and the
dispatcher re-partitions its pieces across the survivors (at-least-once on
an untagged stream). fcfs mode pulls one split at a time from the
dispatcher's shared queue.

Dynamic mode keeps one persistent stream per worker, fed from
dispatcher-owned deques and rebalanced mid-epoch by work stealing: every
``dynamic_sync_interval_s`` (and at once when a worker's deque drains while
a peer is backlogged) the client reports the pieces done, each worker's
owned and unstarted pieces and its delivery rate, and applies the steals
the dispatcher answers with through a revoke-then-extend handshake: the
donor's engine revokes the piece first, and only a piece it acks as revoked
(no batch of it sent or to be sent) is granted to the receiver, at the
piece's watermark. A steal the donor beat is reported back as failed.
Batches carry ``(piece, generation)``, and one of a superseded grant is
dropped (``dedup_dropped``). A worker that joined mid-epoch gets a stream
when a steal names it; a dispatcher that restarted without the plan
answers ``unknown_plan`` and the client re-plans while its streams flow.

While a static drain runs, a heartbeat thread (``heartbeat_interval_s``)
ships the delivery watermarks and the ready-queue fullness to the
dispatcher and reads its fencing epoch: an epoch past the one the
assignment was fetched at (a dispatcher restart, an eviction) posts a
``fence`` into the drain, which re-fetches the assignment and keeps every
stream whose pieces still map to its worker, retiring and relaunching only
the moved ones at their watermarks. The heartbeat also samples the clock
offset against the dispatcher and follows its fleet-tracing flag, pushing
this process's span ring while it is armed. ``hedging=True`` re-grants a
stream's in-flight piece at its watermark on a peer when the stream stays
silent past a threshold fit from the run's own inter-batch gaps
(:class:`~petastorm_tpu_torch.service.resilience.GapTracker`); the first
``piece_done`` wins and the loser is cancelled. With
``on_piece_error="quarantine"`` a ``piece_failed`` frame completes the
piece empty and reports it to the dispatcher, which journals it.

Each stream negotiates its transport (a worker on this host serves it
through a shared-memory ring, unless either side says ``"tcp"``) and
carries the iteration's graph rewrites: a declared ``ColumnPredicate``
and projection hoisted below the workers' decode
(``filter_placement="worker"``; on ``"client"`` they mask each received
batch here), stage fusion, the cache placement and the reader family.

:meth:`ServiceBatchSource.state_dict` snapshots the epoch, the completed
pieces and the watermarks (static mode); ``TorchDataLoader.state_dict()``
delegates here with the batches it has yielded.

``job_id=`` makes the source one client of a fleet job (static or dynamic
sharding): the job rides every control request and stream request, and
the dispatcher's ``credit_scale`` (the job's fair share) scales the credit
window of every stream opened after it.

``packing=`` (a :class:`~petastorm_tpu_torch.service.packing_stage.
PackingSpec` or its dict) rides every stream request: the workers pack
before serialization, and the watermarks, ordinals and resume state count
packed batches (a resume under another spec is refused). ``corpus=`` scopes
the source to one corpus of a multi-corpus fleet: it rides every control
request, so assignments, takeovers and quarantine reports stay within
that corpus's workers and pieces.
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
import uuid

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.reader_impl.framed_socket import (
    ConnectionClosedError,
    FramedConnection,
    ProtocolError,
)
from petastorm_tpu_torch.service.packing_stage import PackingSpec
from petastorm_tpu_torch.service.resilience import (
    CircuitBreaker,
    GapTracker,
    RetryBudget,
    attach_deadline,
    note_brownout_level,
)
from petastorm_tpu_torch.service.seedtree import piece_order
from petastorm_tpu_torch.service.transport import NegotiatedConnection, resolve_mode
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.clockalign import OffsetEstimator
from petastorm_tpu_torch.telemetry.metrics import (
    CLIENT_BATCHES,
    CLIENT_DEDUP_DROPPED,
    CLIENT_FILTER_ROWS,
    CLIENT_READY_QUEUE_DEPTH,
    CLIENT_RECOVERY_EVENTS,
    CLIENT_RECV_STALL,
    CLIENT_TRANSFORM_SECONDS,
    CLIENT_WATERMARK_LAG,
    QUARANTINE_REPORTS,
    RESILIENCE_BREAKER_STATE,
    RESILIENCE_HEDGES,
    RESILIENCE_RETRY_BUDGET,
)
from petastorm_tpu_torch.utils import resize_bounded_queue, retry_with_backoff

logger = logging.getLogger(__name__)


class ServiceError(RuntimeError):
    """A non-transient service failure: a dispatcher or worker replied
    ``error``, or the service cannot make progress."""


class DegradedDispatcherError(OSError):
    """The dispatcher refused a state-mutating request because it is in
    degraded read-only mode (a journal write failed, e.g. ENOSPC). An
    ``OSError`` on purpose: the shared retry policy treats it as
    transient, because every mutating request first attempts recovery (a
    full snapshot compaction) and the next retry may find a healed
    dispatcher."""


def _add_stream_fields(request, stream, conn):
    """The stream request's optional fields: the transport advertisement,
    the shuffle seed, the transform placement, the packing spec and the
    graph rewrites."""
    advert = conn.advertisement()
    if advert is not None:
        request["transport"] = advert
    if stream.shuffle_seed is not None:
        request["shuffle_seed"] = int(stream.shuffle_seed)
    if stream.transform_placement is not None:
        request["transform_placement"] = stream.transform_placement
    if stream.packing is not None:
        request["packing"] = dict(stream.packing)
    if stream.predicate is not None:
        request["predicate"] = dict(stream.predicate)
    if stream.projection is not None:
        request["projection"] = list(stream.projection)
    if stream.fused:
        request["fused"] = True
    if stream.cache_stage is not None:
        request["cache_stage"] = stream.cache_stage
    if stream.reader_family is not None:
        request["reader_family"] = stream.reader_family
    if stream.job_id is not None:
        request["job_id"] = stream.job_id


class _WorkerStream:
    """One ``stream`` request against one worker. It connects lazily, so
    every connection failure surfaces from :meth:`next_event`.

    ``credits`` arms flow control; :meth:`add_credit` replenishes.
    ``auto_replenish=True`` acks each batch on receipt (sequential
    consumers: fcfs splits, reconnect probes); the multiplexed drain acks
    from the consumer side. ``tagged=True`` asks for the exactly-once
    protocol, with ``starts`` as the per-piece watermarks to resume at."""

    def __init__(self, worker_id, address, pieces, epoch, connect_timeout, credits=None,
                 auto_replenish=False, tagged=False, starts=None, shuffle_seed=None,
                 transform_placement=None, recv_timeout=None, max_frame_bytes=None,
                 predicate=None, projection=None, fused=False, cache_stage=None,
                 reader_family=None, transport="auto", job_id=None, packing=None):
        self.worker_id = worker_id
        #: The worker-placed packing spec's dict (None: row batches); the
        #: ordinals and watermarks then count packed batches.
        self.packing = packing
        #: The transport policy: anything but "tcp" advertises shm on the
        #: request; the worker decides.
        self.transport = transport
        #: The fleet job the worker attributes the stream's rows to.
        self.job_id = job_id
        #: The graph rewrites, frozen for the iteration: a hoisted row
        #: filter (wire dict) and projection, stage fusion, the cache stage
        #: and the reader family. None / False: the unrewritten topology.
        self.predicate = predicate
        self.projection = projection
        self.fused = fused
        self.cache_stage = cache_stage
        self.reader_family = reader_family
        self.address = tuple(address)
        self.pieces = list(pieces)
        self.epoch = epoch
        self.credits = credits
        self.tagged = tagged
        self.starts = dict(starts or {})
        self.transform_placement = transform_placement
        self.shuffle_seed = shuffle_seed
        #: Tags of the last batch ``next_event`` returned (None untagged).
        self.last_bid = None
        self.last_piece = None
        self.last_ordinal = None
        self._auto_replenish = auto_replenish
        self._connect_timeout = connect_timeout
        self._recv_timeout = recv_timeout
        self._max_frame_bytes = max_frame_bytes
        self._conn = None
        self._closed = False

    def next_event(self):
        """``("batch", payload)``, ``("piece_done", piece)``,
        ``("piece_failed", (piece, error))`` (the worker quarantined an
        undecodable piece) or ``("end", None)``; an ``error`` reply raises
        :class:`ServiceError` (a retryable one
        :class:`ConnectionClosedError`)."""
        if self._closed:
            # A teardown close is terminal: reconnecting would send the
            # worker a stream request nobody consumes.
            raise ConnectionClosedError("stream closed")
        if self._conn is None:
            # The dial timeout bounds the dial only: gaps between batches
            # have no bound (reader construction, cold reads); keepalive
            # catches a host that died without FIN/RST.
            self._conn = NegotiatedConnection(
                FramedConnection.connect(
                    self.address, timeout=self._connect_timeout,
                    stream_timeout=self._recv_timeout, keepalive=True,
                    max_frame_bytes=self._max_frame_bytes),
                mode=self.transport)
            if self._closed:
                self._conn.close()
                self._conn = None
                raise ConnectionClosedError("stream closed")
            request = {"type": "stream", "pieces": self.pieces, "epoch": self.epoch}
            # The stream-open budget is the dial timeout: a request still
            # unstarted in the worker's backlog past it is refused there.
            if self._connect_timeout is not None:
                attach_deadline(request, time.monotonic() + self._connect_timeout)
            _add_stream_fields(request, self, self._conn)
            if self.tagged:
                request["tagged"] = True
                if self.starts:
                    request["starts"] = {str(p): int(s) for p, s in self.starts.items() if s}
            if self.credits is not None:
                request["credits"] = self.credits
            self._conn.send(request)
        header, payload = self._conn.recv()
        kind = header.get("type")
        if kind == "batch":
            self.last_bid = header.get("bid")
            piece, ordinal = header.get("piece"), header.get("ordinal")
            self.last_piece = int(piece) if piece is not None else None
            self.last_ordinal = int(ordinal) if ordinal is not None else None
            if self._auto_replenish:
                self.add_credit(1)
            return ("batch", payload)
        if kind == "piece_done":
            return ("piece_done", int(header["piece"]))
        if kind == "piece_failed":
            return ("piece_failed", (int(header["piece"]), str(header.get("error", ""))))
        if kind == "end":
            self.close()
            return ("end", None)
        if kind == "error":
            if header.get("retryable"):
                raise ConnectionClosedError(
                    f"worker {self.worker_id} refused stream (retryable): "
                    f"{header.get('error')}")
            raise ServiceError(f"worker {self.worker_id} failed streaming pieces "
                               f"{self.pieces}: {header.get('error')}")
        raise ServiceError(f"unexpected stream message {kind!r}")

    def next_batch(self):
        """The next batch, or None at the stream's end (markers skipped)."""
        while True:
            kind, payload = self.next_event()
            if kind == "batch":
                return payload
            if kind == "end":
                return None

    def add_credit(self, n=1):
        """Replenish ``n`` credits (send only, safe beside the reader
        thread's ``recv``); a broken socket is left to the receive path."""
        conn = self._conn
        if conn is None or self.credits is None:
            return
        try:
            conn.send({"type": "credit", "n": n})
        except OSError:
            pass

    def close(self):
        self._closed = True
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class _SourceIterator:
    """The source's iterator. ``prefetched=True`` says the iteration runs
    its own producer threads and bounded buffering (the multiplexed
    drain), so the loader consumes it directly."""

    def __init__(self, gen, prefetched):
        self._gen = gen
        self.prefetched = prefetched

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()


class _OrderedSequencer:
    """Reorder buffer of ordered delivery: received batches (and
    ``piece_done`` markers) go in, and only what is next in the canonical
    order comes out: the current piece's batches at once, later pieces'
    buffered until their turn. ``lag`` (the ``client_watermark_lag``
    gauge) is the buffered batch count; a head-of-line stall can grow it
    toward the rest of the epoch."""

    def __init__(self, order):
        self._order = [int(p) for p in order]
        self._pos = 0
        self._buffered = {}  # piece -> [items]
        self._done = {}      # piece -> worker_id
        self.lag = 0

    def push(self, piece, item):
        self._buffered.setdefault(piece, []).append(item)
        self.lag += 1
        return self._release()

    def finish_piece(self, piece, worker_id):
        self._done[piece] = worker_id
        return self._release()

    def _release(self):
        out = []
        while self._pos < len(self._order):
            piece = self._order[self._pos]
            buffered = self._buffered.get(piece)
            if buffered:
                out.extend(("batch", piece, item) for item in buffered)
                self.lag -= len(buffered)
                buffered.clear()
            if piece in self._done:
                self._buffered.pop(piece, None)
                out.append(("piece_done", piece, self._done.pop(piece)))
                self._pos += 1
                continue
            break
        return out

    def drain(self):
        """Everything still buffered, in order (empty when every piece
        announced ``piece_done``)."""
        out = []
        for piece in self._order[self._pos:] + sorted(
                set(self._buffered) - set(self._order[self._pos:])):
            for item in self._buffered.pop(piece, []):
                out.append(("batch", piece, item))
                self.lag -= 1
            if piece in self._done:
                out.append(("piece_done", piece, self._done.pop(piece)))
        self._pos = len(self._order)
        return out


class _DeliveryBook:
    """Consumer-side delivery bookkeeping: production counts, per-worker
    attribution, tagged batch events (what ``state_dict`` computes
    watermarks from) and piece completion."""

    def __init__(self, source, epoch):
        self._source = source
        self._epoch = epoch

    def account_yielded(self, piece, ordinal, wid, bid):
        source = self._source
        with source._lock:
            source._production_count += 1
            source._note_consumed_locked(wid)
            if piece is not None and ordinal is not None:
                source._batch_events.append(
                    (source._production_count, self._epoch, piece, ordinal))
        source.last_bid = bid

    def complete_piece(self, piece, wid):
        source = self._source
        with source._lock:
            if piece in source._completed:
                return
            source._completed.add(piece)
            source._events.append((source._production_count, self._epoch, [piece]))
            source._note_pieces_locked(wid, 1)

    def emit(self, released):
        """Yield a sequencer's released batches, completing pieces as
        their markers come out."""
        collector = tracing.COLLECTOR
        for ev in released:
            if ev[0] == "batch":
                _, piece, (ordinal, payload, stream, bid, t_enqueued) = ev
                self.account_yielded(piece, ordinal, stream.worker_id, bid)
                if collector.enabled:
                    collector.record_span("client.queue", t_enqueued, time.perf_counter(),
                                          bid=bid)
                yield payload
            else:
                self.complete_piece(ev[1], ev[2])


class _StreamReader(threading.Thread):
    """One worker stream's receive loop: events go to the shared ready
    queue as ``(kind, sid, item)``: ``batch`` per payload (with its tags
    and the time it was queued), ``piece_done`` / ``piece_failed`` per
    finished or quarantined piece, then one terminal ``end``, ``broken``
    (a connection failure: retry or takeover) or ``error`` (re-raised by
    the consumer)."""

    def __init__(self, sid, stream, ready, stop, note_recv):
        super().__init__(daemon=True, name=f"service-stream-{stream.worker_id}")
        self._sid = sid
        self._stream = stream
        self._ready = ready
        self._stopped = stop  # Thread has a private _stop method
        self._note_recv = note_recv

    def run(self):
        try:
            while not self._stopped.is_set():
                t0 = time.perf_counter()
                try:
                    kind, payload = self._stream.next_event()
                except (ConnectionError, OSError, ProtocolError) as exc:
                    # The consumer's teardown close lands here too: the stop
                    # flag tells it from a real failure.
                    if not self._stopped.is_set():
                        self._put(("broken", self._sid, exc))
                    return
                t1 = time.perf_counter()
                self._note_recv(self._stream.worker_id, t1 - t0, kind == "batch")
                if kind == "end":
                    self._put(("end", self._sid, None))
                    return
                if kind in ("piece_done", "piece_failed"):
                    self._put((kind, self._sid, payload))
                    continue
                bid = self._stream.last_bid
                if tracing.COLLECTOR.enabled:
                    tracing.COLLECTOR.record_span("client.recv", t0, t1, bid=bid)
                self._put(("batch", self._sid,
                           (payload, self._stream.last_piece, self._stream.last_ordinal,
                            bid, time.perf_counter())))
        except BaseException as exc:
            # A reader dying silently would hang the consumer's get().
            self._put(("error", self._sid, exc))

    def _put(self, event):
        while not self._stopped.is_set():
            try:
                self._ready.put(event, timeout=0.1)
                return
            except queue.Full:
                continue


class _DynamicStream:
    """One persistent dynamic-mode stream against one worker, whose piece
    set changes mid-stream: :meth:`extend` appends steal grants,
    :meth:`revoke` asks the worker's engine to drop unsent pieces (acked
    with a ``revoked`` frame naming those removed), :meth:`finish` closes
    the queue so the worker drains and sends ``end``. The senders are
    send-only, safe beside the reader thread's ``recv``; a broken socket is
    left to the receive path, whose takeover re-grants every piece still
    outstanding on the worker."""

    def __init__(self, worker_id, address, pairs, epoch, connect_timeout, credits=None,
                 shuffle_seed=None, transform_placement=None, recv_timeout=None,
                 max_frame_bytes=None, predicate=None, projection=None, fused=False,
                 cache_stage=None, reader_family=None, transport="auto", job_id=None,
                 packing=None):
        self.worker_id = worker_id
        self.transport = transport  # as _WorkerStream's, and the job, packing and rewrites
        self.packing = packing
        self.job_id = job_id
        self.predicate = predicate
        self.projection = projection
        self.fused = fused
        self.cache_stage = cache_stage
        self.reader_family = reader_family
        self.address = tuple(address)
        # [(piece, generation, start)]: start is the client's watermark, so
        # a (re)opened stream repeats no batch.
        self.pairs = [self._triple(t) for t in pairs]
        self.epoch = epoch
        self.credits = credits
        self.shuffle_seed = shuffle_seed
        self.transform_placement = transform_placement
        self._connect_timeout = connect_timeout
        self._recv_timeout = recv_timeout
        self._max_frame_bytes = max_frame_bytes
        self._conn = None
        self._closed = False
        self._send_lock = threading.Lock()
        self._pre_conn = []  # queue edits sent before the connection is up

    def _ensure_conn(self):
        if self._closed:
            raise ConnectionClosedError("stream closed")
        with self._send_lock:
            if self._conn is not None:
                return self._conn
            conn = NegotiatedConnection(
                FramedConnection.connect(
                    self.address, timeout=self._connect_timeout,
                    stream_timeout=self._recv_timeout, keepalive=True,
                    max_frame_bytes=self._max_frame_bytes),
                mode=self.transport)
            if self._closed:
                conn.close()
                raise ConnectionClosedError("stream closed")
            request = {"type": "stream", "dynamic": True,
                       "pieces": [list(t) for t in self.pairs], "epoch": self.epoch}
            if self._connect_timeout is not None:
                attach_deadline(request, time.monotonic() + self._connect_timeout)
            _add_stream_fields(request, self, conn)
            if self.credits is not None:
                request["credits"] = self.credits
            try:
                conn.send(request)
                # Edits that raced the dial follow the request, in order.
                for message in self._pre_conn:
                    conn.send(message)
            except BaseException:
                conn.close()
                raise
            del self._pre_conn[:]
            self._conn = conn
            return conn

    @staticmethod
    def _triple(t):
        t = list(t)
        return (int(t[0]), int(t[1]), int(t[2]) if len(t) > 2 else 0)

    def next_event(self):
        """``("batch", (piece, gen, ordinal, payload, bid))``,
        ``("piece_done", (piece, gen, rows))``, ``("piece_failed", (piece,
        gen, error))``, ``("revoked", (req, pieces))`` or ``("end", None)``;
        an ``error`` reply raises :class:`ServiceError`."""
        conn = self._ensure_conn()
        header, payload = conn.recv()
        kind = header.get("type")
        if kind == "batch":
            ordinal = header.get("ordinal")
            return ("batch", (int(header.get("piece", -1)), int(header.get("generation", 0)),
                              int(ordinal) if ordinal is not None else None, payload,
                              header.get("bid")))
        if kind == "piece_done":
            return ("piece_done", (int(header["piece"]), int(header.get("generation", 0)),
                                   int(header.get("rows", 0))))
        if kind == "piece_failed":
            return ("piece_failed", (int(header["piece"]), int(header.get("generation", 0)),
                                     str(header.get("error", ""))))
        if kind == "revoked":
            return ("revoked", (header.get("req"), [int(p) for p in header.get("pieces", [])]))
        if kind == "end":
            self.close()
            return ("end", None)
        if kind == "error":
            raise ServiceError(f"worker {self.worker_id} failed its dynamic stream: "
                               f"{header.get('error')}")
        raise ServiceError(f"unexpected dynamic stream message {kind!r}")

    def _send(self, message):
        with self._send_lock:
            if self._closed:
                return
            if self._conn is None:
                # Not dialed yet: queue the edit (dropping a steal grant
                # would orphan the piece and hang the epoch).
                self._pre_conn.append(message)
                return
            try:
                self._conn.send(message)
            except OSError:
                pass  # the receive path detects and recovers the stream

    def extend(self, pairs):
        self._send({"type": "extend", "pieces": [list(self._triple(t)) for t in pairs]})

    def revoke(self, pieces, req):
        self._send({"type": "revoke", "pieces": [int(p) for p in pieces], "req": req})

    def finish(self):
        self._send({"type": "finish_pieces"})

    def add_credit(self, n=1):
        if self.credits is not None:
            self._send({"type": "credit", "n": n})

    def close(self):
        self._closed = True
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class _DynamicStreamReader(threading.Thread):
    """Receive loop of one dynamic stream: events go to the shared ready
    queue as ``(kind, sid, item)``: ``dbatch``, ``piece_done``,
    ``piece_failed``, ``revoked``, then a terminal ``end``, ``broken`` or
    ``error``."""

    def __init__(self, sid, stream, ready, stop, note_recv):
        super().__init__(daemon=True, name=f"service-dynstream-{stream.worker_id}")
        self._sid = sid
        self._stream = stream
        self._ready = ready
        self._stopped = stop
        self._note_recv = note_recv

    def run(self):
        collector = tracing.COLLECTOR
        try:
            while not self._stopped.is_set():
                t0 = time.perf_counter()
                try:
                    kind, item = self._stream.next_event()
                except (ConnectionError, OSError, ProtocolError) as exc:
                    if not self._stopped.is_set():
                        self._put(("broken", self._sid, exc))
                    return
                t1 = time.perf_counter()
                self._note_recv(self._stream.worker_id, t1 - t0, kind == "batch")
                if kind == "end":
                    self._put(("end", self._sid, None))
                    return
                if kind == "batch":
                    piece, gen, ordinal, payload, bid = item
                    if collector.enabled:
                        collector.record_span("client.recv", t0, t1, bid=bid)
                    self._put(("dbatch", self._sid, (piece, gen, ordinal, payload, bid, t1)))
                else:
                    self._put((kind, self._sid, item))
        except BaseException as exc:
            self._put(("error", self._sid, exc))

    def _put(self, event):
        while not self._stopped.is_set():
            try:
                self._ready.put(event, timeout=0.1)
                return
            except queue.Full:
                continue


class ServiceBatchSource:
    """Stream remote batches from a dispatcher's worker fleet.

    :param dispatcher_address: ``(host, port)`` of the dispatcher.
    :param client_index, num_clients: this trainer's static shard.
    :param max_retries, backoff_base, backoff_max: reconnects per failed
        worker (and dispatcher request retries) before giving up, and the
        backoff bounds in seconds.
    :param resume_state: a :meth:`state_dict` of an earlier run (static
        mode): completed pieces are skipped, and pieces mid-delivery resume
        at their watermarks.
    :param credits: per-worker flow-control window (``None``: unbounded).
    :param ready_queue_depth: bound of the shared ready-queue; ``None``
        derives ``max(4, min(streams × credits, 256))`` (``max(4, 2 ×
        streams)`` without credits). Settable while a drain runs.
    :param heartbeat_interval_s: poll ``client_heartbeat`` this often while
        a static drain runs (fencing resyncs, watermarks, clock samples,
        trace arming); ``None`` disables it.
    :param rpc_deadline_s: time budget per dispatcher request, shipped
        with each attempt as the remaining ``deadline_left_s``.
    :param max_frame_bytes: receive frame cap of this client's connections.
    :param dynamic_sync_interval_s: dynamic mode: how often the rebalance
        loop reports progress and backlog and applies the steals it gets
        back (a worker whose deque drains pokes it at once).
    :param ordered: deterministic delivery order (static and dynamic modes).
    :param transform: the batch transform, the same callable the workers
        were given (``BatchWorker(batch_transform=...)``);
        ``transform_placement`` says where it runs: ``"remote"`` (the
        workers) or ``"local"`` (here, timed into
        ``petastorm_service_client_transform_seconds``). Frozen per
        iteration.
    :param stream_recv_timeout_s: a hard deadline on each stream ``recv``
        (``None``: none; keepalive bounds a silent host).
    :param transport: ``"auto"`` (a stream to a worker on this host
        negotiates the shared-memory ring, every other rides TCP),
        ``"tcp"`` (never negotiate), ``"shm"`` (as ``"auto"``) or ``None``
        (``$PETASTORM_TRANSPORT``). Delivery (order, watermarks, dedup,
        fencing) is the same on both tiers.
    :param predicate: a declared row filter, a
        :class:`~petastorm_tpu_torch.predicates.ColumnPredicate` or its
        wire dict; ``projection``: the fields to keep.
        ``filter_placement`` says where they run: ``"client"`` (each
        received batch is masked and pruned here, counted in
        ``petastorm_service_client_filter_rows_total``) or ``"worker"``
        (hoisted below the workers' decode: dropped rows are never decoded
        or sent). With a ``transform`` the filter must be hoisted.
    :param stage_fusion: ``"off"`` or ``"fused"`` (the workers' pool tasks
        collate, transform and serialize; the bytes are the same).
    :param cache_placement: ``"post-transform"`` or ``"post-decode"`` (the
        workers' caches hold the batches before the transform; needs a
        ``transform``).
    :param reader_family: ``None`` (each worker's own), ``"row"`` or
        ``"columnar"`` decode; the bytes are the same.

    The graph rewrites (``filter_placement="worker"``, ``stage_fusion``,
    ``cache_placement``, ``reader_family``) are frozen per iteration, set
    for the next one by their setters (the autotuner's bindings), and
    need static or dynamic sharding.
    :param on_piece_error: ``"fail"`` (a ``piece_failed`` frame raises
        :class:`ServiceError`) or ``"quarantine"`` (the piece completes
        empty and is reported to the dispatcher).
    :param hedging: hedged watermark re-serves of silent streams; the
        ``hedge_*`` arguments shape the :class:`GapTracker` threshold.
    :param breaker_threshold, breaker_cooldown_s: the per-peer circuit
        breaker: consecutive stream failures that trip it, seconds before
        its half-open probe.
    :param retry_budget: tokens of each peer's (and the dispatcher's)
        retry budget; successes refill half a token.

    :param job_id: the fleet job this source belongs to (static or dynamic
        sharding; register it with
        :func:`~petastorm_tpu_torch.service.fleet.register_job` for a weight
        or a quota). ``None``: the default job.

    :param packing: worker-placed sequence packing (a
        :class:`~petastorm_tpu_torch.service.packing_stage.PackingSpec` or
        its dict), static or dynamic sharding only; refused with a
        ``transform`` or a ``predicate``. Set for the next iteration by
        :meth:`set_packing` (what ``PackedBatchSource`` flips).
    :param corpus: the corpus of a multi-corpus fleet this source reads
        (``""``: the default one); static or dynamic sharding only.
    """

    def __init__(self, dispatcher_address, client_index=0, num_clients=1, client_id=None,
                 connect_timeout=10.0, max_retries=3, backoff_base=0.05, backoff_max=2.0,
                 resume_state=None, credits=8, ready_queue_depth=None,
                 heartbeat_interval_s=2.0, rpc_deadline_s=30.0, max_frame_bytes=None,
                 dynamic_sync_interval_s=0.25, ordered=False, transform=None,
                 transform_placement="remote", job_id=None, on_piece_error="fail",
                 stream_recv_timeout_s=None, packing=None, corpus="", predicate=None,
                 projection=None, filter_placement="client", stage_fusion="off",
                 cache_placement="post-transform", reader_family=None, transport=None,
                 hedging=False, hedge_quantile=0.99, hedge_multiplier=4.0,
                 hedge_min_samples=16, hedge_floor_s=0.25, breaker_threshold=5,
                 breaker_cooldown_s=5.0, retry_budget=10.0):
        self._transport = resolve_mode(transport)
        if on_piece_error not in ("fail", "quarantine"):
            raise ValueError(f"on_piece_error must be 'fail' or 'quarantine', got "
                             f"{on_piece_error!r}")
        if credits is not None and credits < 1:
            raise ValueError("credits must be a positive integer or None")
        if ready_queue_depth is not None and ready_queue_depth < 1:
            raise ValueError("ready_queue_depth must be a positive integer or None")
        if transform_placement not in ("remote", "local"):
            raise ValueError("transform_placement must be 'remote' or 'local'")
        if transform is None and transform_placement == "local":
            raise ValueError(
                "transform_placement='local' needs the transform callable: workers are "
                "told to skip their batch_transform, so without one here the stage would "
                "silently not run at all")
        self.corpus = str(corpus or "")
        self._packing = PackingSpec.from_dict(packing) if packing is not None else None
        if self._packing is not None and transform is not None:
            raise ValueError(
                "packing= and transform= cannot combine on one source: the batch "
                "transform is a row-batch stage and packing changes the batch vocabulary "
                "— apply the transform upstream (transform_spec) instead")
        self._iter_packing = self._packing
        self._init_rewrites(predicate, projection, filter_placement, stage_fusion,
                            cache_placement, reader_family, transform)
        if self._predicate is not None and self._packing is not None:
            raise ValueError(
                "predicate= and packing= cannot combine on one source: packing changes "
                "the batch vocabulary (token slots, not rows) — filter upstream (reader "
                "predicate) or drop one")
        self._dispatcher_address = tuple(dispatcher_address)
        self.client_index = client_index
        self.num_clients = num_clients
        self.client_id = client_id or (
            f"client-{client_index}-{os.getpid()}-{uuid.uuid4().hex[:6]}")
        self._connect_timeout = connect_timeout
        self._max_retries = max_retries
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._credits = credits
        self.job_id = str(job_id) if job_id is not None else None
        # The job's fair-share scale of the credit window, from the
        # dispatcher's replies (1.0: the full window).
        self._credit_scale = 1.0
        self._ready_queue_depth = ready_queue_depth
        self.transform = transform
        self._transform_placement = transform_placement
        self._iter_transform_placement = transform_placement if transform is not None else None
        self._heartbeat_interval_s = heartbeat_interval_s
        self._dynamic_sync_interval_s = dynamic_sync_interval_s
        self._rpc_deadline_s = rpc_deadline_s
        self._max_frame_bytes = max_frame_bytes
        self._stream_recv_timeout_s = stream_recv_timeout_s
        self._on_piece_error = on_piece_error
        self._quarantined = []  # [{"piece", "worker_id", "error", "epoch"}]
        self._ordered = bool(ordered)
        self._shuffle_seed = None     # the dispatcher's, read at __call__
        self._ready_queue = None      # the live queue while a drain runs
        self._live_stream_count = 1
        self._per_worker = {}         # worker_id -> delivery counters
        self._lock = threading.Lock()
        #: Batch id of the most recently yielded batch.
        self.last_bid = None
        self._mode = None
        self._epoch = 0
        self._completed = set()
        # The fencing epoch the live assignment was fetched (or resynced)
        # at; the heartbeat compares the dispatcher's against it, and
        # _fence_pending keeps one fence event in the drain at a time.
        self._synced_fencing_epoch = 0
        self._fence_pending = False
        self._recovery = {
            "resyncs": 0,             # fence-triggered assignment refreshes
            "resync_failures": 0,     # resyncs deferred to the next heartbeat
            "streams_retired": 0,     # live streams a resync moved
            "takeovers": 0, "stale_fencing_retries": 0,
            "heartbeat_failures": 0,  # ticks the dispatcher did not answer
            "duplicates_dropped": 0,  # sub-watermark batches a re-serve repeated
            "steals_applied": 0,      # dynamic: revoke-acked piece moves
            "steals_failed": 0,       # dynamic: steals the donor beat
            "dedup_dropped": 0,       # dynamic: batches of a superseded generation
            "pieces_quarantined": 0,  # piece_failed frames under "quarantine"
            "fencing_epoch": 0,       # the last fencing epoch a reply carried
            "dispatcher": {},         # its recovery counters, last heartbeat
        }
        #: Per-piece delivery watermarks of the epoch in flight: the next
        #: ordinal expected from the network; every re-serve starts there.
        self._recv_watermarks = {}
        self._resume_watermarks = {}
        # Per-peer circuit breakers and retry budgets (guarded by _lock),
        # and the dispatcher's own budget.
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        self._retry_budget_capacity = float(retry_budget)
        self._breakers = {}
        self._budgets = {}
        self._breakers_reported = set()
        self._dispatcher_budget = RetryBudget(capacity=self._retry_budget_capacity)
        self._hedging = bool(hedging)
        self._gap_tracker = GapTracker(quantile=hedge_quantile, multiplier=hedge_multiplier,
                                       min_samples=hedge_min_samples, floor_s=hedge_floor_s)
        self._hedge_counts = {"launched": 0, "won": 0, "lost": 0}
        # Clock samples around heartbeats, and whether the dispatcher's
        # heartbeat replies arm fleet tracing.
        self._clock = OffsetEstimator()
        self._trace_armed_remote = False
        self._reporters = []  # quarantine and breaker report threads
        self._retry_sleep = time.sleep
        if resume_state is not None:
            self._validate_resume_state(resume_state)
            self._epoch = int(resume_state["epoch"])
            self._completed = set(int(p) for p in resume_state["completed_pieces"])
            self._resume_watermarks = {
                int(p): int(n) for p, n in (resume_state.get("watermarks") or {}).items()}
            self._resume_seed = resume_state.get("shuffle_seed")
            self._resume_has_seed = "shuffle_seed" in resume_state
        self._resumed = resume_state is not None
        # Production-order bookkeeping: the n-th produced batch is the n-th
        # the consumer yields, so events stamped with production counts let
        # a snapshot describe what the trainer has seen.
        self._production_count = 0
        self._events = []        # (production_count, epoch, [pieces])
        self._batch_events = []  # (production_count, epoch, piece, ordinal)
        self._epoch_starts = [(0, self._epoch, set(self._completed),
                               dict(self._resume_watermarks))]

    def _init_rewrites(self, predicate, projection, filter_placement, stage_fusion,
                       cache_placement, reader_family, transform):
        """Check the declared filter, projection and rewrites against each
        other and keep them (the JAX source's rules and messages)."""
        from petastorm_tpu_torch.predicates import ColumnPredicate

        self._predicate = None
        if predicate is not None:
            self._predicate = (predicate if isinstance(predicate, ColumnPredicate)
                               else ColumnPredicate.from_wire(predicate))
        if filter_placement not in ("client", "worker"):
            raise ValueError("filter_placement must be 'client' or 'worker'")
        if predicate is None and filter_placement == "worker":
            raise ValueError("filter_placement='worker' needs predicate=: there is no row "
                             "filter to hoist")
        if projection and transform is not None \
                and (predicate is None or filter_placement != "worker"):
            # Pruned here, the batch would be pruned after a remote
            # transform but before a local one: a placement flip would
            # change the transform's input.
            raise ValueError(
                "projection= with transform= requires the hoisted filter topology "
                "(predicate= with filter_placement='worker'): client-side pruning would "
                "run after a remote transform but before a local one, so a "
                "transform_placement flip would change the transform's input")
        if self._predicate is not None and transform is not None \
                and filter_placement != "worker":
            # A client filter would see the batches after the workers'
            # transform: another survivor set than the hoisted topology's.
            raise ValueError(
                "predicate= with transform= requires filter_placement='worker': a "
                "client-placed filter would see post-transform batches (the worker "
                "transforms before shipping), diverging from the hoisted topology's "
                "stored-value semantics")
        self._projection = sorted(str(f) for f in projection) if projection else None
        self._filter_placement = filter_placement
        if stage_fusion not in ("off", "fused"):
            raise ValueError("stage_fusion must be 'off' or 'fused'")
        self._stage_fusion = stage_fusion
        if cache_placement not in ("post-transform", "post-decode"):
            raise ValueError("cache_placement must be 'post-transform' or 'post-decode'")
        if cache_placement == "post-decode" and transform is None:
            raise ValueError("cache_placement='post-decode' is only meaningful with a "
                             "transform= armed (without one the two placements cache "
                             "identical bytes)")
        self._cache_placement = cache_placement
        if reader_family not in (None, "row", "columnar"):
            raise ValueError(f"reader_family must be None, 'row', or 'columnar', got "
                             f"{reader_family!r}")
        self._reader_family = reader_family
        # The iteration's frozen copies (set at __call__): every stream of
        # an iteration, relaunches included, carries the same rewrites.
        self._iter_predicate = None
        self._iter_projection = None
        self._iter_filter_placement = None
        self._iter_hoisted = False
        self._iter_fused = False
        self._iter_cache_stage = None
        self._iter_reader_family = None
        # Batches the client filter emptied this iteration: they break the
        # one-to-one count of received and yielded batches state_dict needs.
        self._filter_dropped_batches = 0

    # -- graph-rewrite knobs ---------------------------------------------------

    @property
    def filter_placement(self):
        """Where the declared row filter runs from the next iteration on:
        ``"client"`` or ``"worker"``."""
        return self._filter_placement

    def set_filter_placement(self, placement):
        """Move the row filter between masking here and the workers'
        two-phase read, from the next iteration on."""
        if placement not in ("client", "worker"):
            raise ValueError("filter_placement must be 'client' or 'worker'")
        if self._predicate is None:
            raise ValueError("no predicate armed — construct the source with predicate= "
                             "to make filter placement meaningful")
        if placement == "client" and self.transform is not None:
            raise ValueError(
                "filter_placement='client' is unavailable with a transform= armed: the "
                "workers transform before shipping, so the client filter would evaluate "
                "post-transform values — the filter stays hoisted (worker-placed)")
        if placement == "worker":
            self._reject_rewrite_on_fcfs("filter_placement='worker'")
        self._filter_placement = placement

    @property
    def stage_fusion(self):
        """``"off"`` or ``"fused"`` from the next iteration on."""
        return self._stage_fusion

    def set_stage_fusion(self, mode):
        """Arm or disarm the workers' stage fusion from the next iteration
        on; the bytes are the same either way."""
        if mode not in ("off", "fused"):
            raise ValueError("stage_fusion must be 'off' or 'fused'")
        if mode == "fused":
            self._reject_rewrite_on_fcfs("stage_fusion='fused'")
        self._stage_fusion = mode

    @property
    def cache_placement(self):
        """The workers' cache stage from the next iteration on."""
        return self._cache_placement

    def set_cache_placement(self, placement):
        """Move the workers' cache above or below the batch transform from
        the next iteration on; the two placements' keys differ, so a flip
        refills."""
        if placement not in ("post-transform", "post-decode"):
            raise ValueError("cache_placement must be 'post-transform' or 'post-decode'")
        if placement == "post-decode" and self.transform is None:
            raise ValueError("cache_placement='post-decode' needs a transform= armed")
        if placement == "post-decode":
            self._reject_rewrite_on_fcfs("cache_placement='post-decode'")
        self._cache_placement = placement

    @property
    def reader_family(self):
        """The family the workers decode this source's streams with from
        the next iteration on (``None``: each worker's own)."""
        return self._reader_family

    def set_reader_family(self, family):
        """Flip the workers between row and columnar decode from the next
        iteration on (bytes identical; the families' cache keys differ)."""
        if family not in (None, "row", "columnar"):
            raise ValueError(f"reader_family must be None, 'row', or 'columnar', got "
                             f"{family!r}")
        if family == "columnar":
            self._reject_rewrite_on_fcfs("reader_family='columnar'")
        self._reader_family = family

    def _reject_rewrite_on_fcfs(self, what):
        """A setter refuses a rewrite on a source known to run fcfs: the
        flip would not probe, it would fail the next iteration."""
        if self._mode == "fcfs":
            raise ValueError(
                f"{what} requires static or dynamic sharding: this source's dispatcher "
                f"runs fcfs, whose untagged per-split streams bypass the streaming piece "
                f"engine rewrites run in")

    def _iter_rewrite_kwargs(self):
        """The frozen iteration's rewrites (and the transport policy) as
        stream arguments, for every stream the iteration opens."""
        hoisted = self._iter_hoisted
        return {
            "predicate": (self._iter_predicate.to_wire()
                          if hoisted and self._iter_predicate is not None else None),
            "projection": self._iter_projection if hoisted else None,
            "fused": self._iter_fused,
            "cache_stage": self._iter_cache_stage,
            "reader_family": self._iter_reader_family,
            "transport": self._transport,
        }

    def _apply_filter_local(self, inner):
        """The declared filter and projection run here (the unrewritten
        topology): each received batch is masked with the predicate's
        columnar form and pruned. The rows and their order equal the
        hoisted run's; the batch boundaries do not. An emptied batch is
        skipped and counted (see :meth:`state_dict`)."""
        import numpy as np

        from petastorm_tpu_torch.predicates import evaluate_predicate_mask

        predicate, projection = self._iter_predicate, self._iter_projection
        m_in, m_kept = CLIENT_FILTER_ROWS.labels("in"), CLIENT_FILTER_ROWS.labels("kept")
        try:
            for batch in inner:
                if predicate is not None and batch:
                    num_rows = len(next(iter(batch.values())))
                    mask = evaluate_predicate_mask(predicate, batch, num_rows)
                    kept = int(np.count_nonzero(mask))
                    m_in.inc(num_rows)
                    m_kept.inc(kept)
                    if kept == 0:
                        with self._lock:
                            self._filter_dropped_batches += 1
                        continue
                    if kept < num_rows:
                        batch = {name: column[mask] for name, column in batch.items()}
                if projection is not None:
                    batch = {name: column for name, column in batch.items()
                             if name in projection}
                yield batch
        finally:
            close = getattr(inner, "close", None)
            if callable(close):
                close()

    def _hoisted_filter_signature(self, constructed=False):
        """The hoisted filter's wire form (``None`` unless worker-placed):
        the iteration in force, or with ``constructed`` the next one."""
        if constructed:
            predicate, hoisted = self._predicate, self._filter_placement == "worker"
        else:
            predicate, hoisted = self._iter_predicate, self._iter_hoisted
        return predicate.to_wire() if hoisted and predicate is not None else None

    def _recovery_inc(self, event, n=1):
        """Bump a recovery counter in ``diagnostics`` and the registry.
        Callers hold ``_lock``."""
        self._recovery[event] += n
        CLIENT_RECOVERY_EVENTS.labels(event).inc(n)

    # -- poison-piece quarantine ---------------------------------------------

    def _report(self, name, request, on_failure=None):
        """Send ``request`` to the dispatcher on a helper thread (joined at
        the end of the drain), best-effort with one retry."""
        def report():
            try:
                self._dispatcher_request(request, retries=1)
            except (ServiceError, OSError):
                if on_failure is not None:
                    on_failure()

        thread = threading.Thread(target=report, daemon=True,
                                  name=f"service-{name}-{self.client_id}")
        with self._lock:
            self._reporters = [t for t in self._reporters if t.is_alive()] + [thread]
        thread.start()

    def _join_reporters(self, timeout=5.0):
        with self._lock:
            reporters, self._reporters = self._reporters, []
        for thread in reporters:
            thread.join(timeout=timeout)

    def _note_quarantined(self, piece, worker_id, error, epoch):
        """Record one quarantined piece and report it to the dispatcher,
        which journals it and excludes it from every later grant. An
        unreported piece is re-granted, and re-quarantined, next epoch."""
        piece = int(piece)
        with self._lock:
            if any(e["piece"] == piece and e["epoch"] == epoch for e in self._quarantined):
                return  # a re-serve raced the quarantine
            self._quarantined.append({"piece": piece, "worker_id": worker_id,
                                      "error": str(error), "epoch": int(epoch)})
            self._recovery_inc("pieces_quarantined")
        QUARANTINE_REPORTS.labels("client").inc()
        logger.warning("piece %d quarantined by worker %s (%s) — continuing without it",
                       piece, worker_id, error)
        self._report("quarantine", {"type": "report_poison_piece",
                                    "client_id": self.client_id, "piece": piece,
                                    "worker_id": worker_id, "error": str(error),
                                    "epoch": int(epoch)})

    # -- circuit breakers and retry budgets ------------------------------------

    def _breaker(self, worker_id):
        with self._lock:
            breaker = self._breakers.get(worker_id)
            if breaker is None:
                breaker = self._breakers[worker_id] = CircuitBreaker(
                    threshold=self._breaker_threshold, cooldown_s=self._breaker_cooldown_s)
            return breaker

    def _budget(self, worker_id):
        with self._lock:
            budget = self._budgets.get(worker_id)
            if budget is None:
                budget = self._budgets[worker_id] = RetryBudget(
                    capacity=self._retry_budget_capacity)
            return budget

    def _note_stream_success(self, worker_id):
        """A stream delivered: close the peer's breaker, refill its budget."""
        breaker = self._breaker(worker_id)
        breaker.record_success()
        budget = self._budget(worker_id)
        budget.record_success()
        with self._lock:
            self._breakers_reported.discard(worker_id)
        RESILIENCE_BREAKER_STATE.labels(worker_id).set(breaker.state_code)
        RESILIENCE_RETRY_BUDGET.labels(worker_id).set(budget.balance)

    def _note_stream_failure(self, worker_id):
        """One stream failure against a peer; on the trip edge the worker is
        reported to the dispatcher for routing exclusion. Returns the
        breaker."""
        breaker = self._breaker(worker_id)
        tripped = breaker.record_failure(time.monotonic())
        RESILIENCE_BREAKER_STATE.labels(worker_id).set(breaker.state_code)
        if tripped:
            with self._lock:
                fresh = worker_id not in self._breakers_reported
                self._breakers_reported.add(worker_id)
            if fresh:
                logger.warning("circuit breaker tripped OPEN for worker %s (%d consecutive "
                               "stream failures) — failing fast and reporting it",
                               worker_id, self._breaker_threshold)

                def unreported():
                    with self._lock:
                        self._breakers_reported.discard(worker_id)

                self._report("breaker", {
                    "type": "report_breaker", "client_id": self.client_id,
                    "worker_id": worker_id,
                    "error": f"{self._breaker_threshold} consecutive stream failures",
                    "epoch": int(self._epoch)}, on_failure=unreported)
        return breaker

    def _note_hedge(self, outcome):
        RESILIENCE_HEDGES.labels(outcome).inc()
        if tracing.COLLECTOR.enabled:
            tracing.COLLECTOR.instant(f"client.hedge_{outcome}", time.perf_counter(),
                                      args={"client_id": self.client_id})
        with self._lock:
            self._hedge_counts[outcome] += 1

    def _dispatcher_request(self, header, retries=None):
        """One request / reply with the dispatcher under the retry policy:
        connection failures retry (spending the dispatcher's retry budget),
        an ``error`` reply raises :class:`ServiceError` at once. Each
        attempt ships the remaining ``rpc_deadline_s``."""
        if self.job_id is not None and "job_id" not in header:
            header = dict(header, job_id=self.job_id)
        if self.corpus:
            # Assignments, takeovers and quarantine reports are the corpus's.
            header = dict(header, corpus=self.corpus)
        if "trace" not in header:
            ctx = {"peer": self.client_id}
            if self.job_id is not None:
                ctx["job_id"] = self.job_id
            header = dict(header, trace=ctx)
        deadline = (time.monotonic() + self._rpc_deadline_s
                    if self._rpc_deadline_s is not None else None)

        def once():
            attach_deadline(header, deadline)
            with FramedConnection.connect(self._dispatcher_address,
                                          timeout=self._connect_timeout,
                                          max_frame_bytes=self._max_frame_bytes) as conn:
                reply, _ = conn.request(header)
            if reply.get("type") == "error":
                if reply.get("retryable"):
                    # A degraded dispatcher heals on a later request, so
                    # this rides the OSError retry path.
                    raise DegradedDispatcherError(reply.get("error", "dispatcher degraded"))
                raise ServiceError(reply.get("error", "dispatcher error"))
            return reply

        reply = retry_with_backoff(
            once, retries=self._max_retries if retries is None else retries,
            base_delay=self._backoff_base, max_delay=self._backoff_max,
            retry_on=(OSError, ProtocolError), no_retry_on=(ServiceError,),
            deadline_s=self._rpc_deadline_s, budget=self._dispatcher_budget,
            description=f"dispatcher request {header.get('type')!r}")
        if "fencing_epoch" in reply:
            with self._lock:
                self._recovery["fencing_epoch"] = max(self._recovery["fencing_epoch"],
                                                      int(reply["fencing_epoch"]))
        if "credit_scale" in reply:
            # For streams opened after this reply (a live stream keeps the
            # window of its request).
            self._credit_scale = float(reply["credit_scale"])
        return reply

    # -- runtime knobs (the autotuner's bindings) ----------------------------

    @property
    def credits(self):
        """The per-worker flow-control window in force."""
        return self._credits

    def set_credits(self, credits):
        """Set the credit window for streams opened after the call (a live
        stream keeps the window of its request); a derived ready-queue
        bound follows it at once."""
        if credits is not None and credits < 1:
            raise ValueError("credits must be a positive integer or None")
        with self._lock:
            self._credits = credits
            ready, streams = self._ready_queue, self._live_stream_count
        if self._ready_queue_depth is None and ready is not None:
            resize_bounded_queue(ready, self._derived_ready_depth(streams))

    @property
    def ready_queue_depth(self):
        """The ready-queue bound (pinned, or derived from the streams)."""
        if self._ready_queue_depth is not None:
            return self._ready_queue_depth
        with self._lock:
            ready = self._ready_queue
        return ready.maxsize if ready is not None else self._derived_ready_depth(1)

    def set_ready_queue_depth(self, depth):
        """Pin (and resize while it runs) the ready-queue bound."""
        if depth is not None and depth < 1:
            raise ValueError("ready_queue_depth must be a positive integer or None")
        with self._lock:
            self._ready_queue_depth = depth
            ready, streams = self._ready_queue, self._live_stream_count
        if ready is not None:
            resize_bounded_queue(ready, depth if depth is not None
                                 else self._derived_ready_depth(streams))

    @property
    def transform_placement(self):
        """Where the batch transform runs from the next iteration on."""
        return self._transform_placement

    def set_transform_placement(self, placement):
        """Move the batch transform between the workers (``"remote"``) and
        this host (``"local"``), from the next iteration on."""
        if placement not in ("remote", "local"):
            raise ValueError("transform_placement must be 'remote' or 'local'")
        if placement == "local" and self.transform is None:
            raise ValueError("transform_placement='local' needs the transform callable")
        self._transform_placement = placement

    @property
    def packing(self):
        """The worker-placed packing spec in force from the next iteration
        on (``None``: the workers serve row batches)."""
        return self._packing

    def set_packing(self, packing):
        """Arm (or, with ``None``, disarm) worker-placed packing from the
        next iteration on: what
        :meth:`~petastorm_tpu_torch.service.packing_stage.PackedBatchSource.set_packing_placement`
        calls."""
        if packing is None:
            self._packing = None
            return
        if self.transform is not None:
            raise ValueError("packing and transform= cannot combine on one source "
                             "(the transform is a row-batch stage)")
        self._packing = PackingSpec.from_dict(packing)

    def _iter_packing_dict(self):
        """The iteration's packing spec in wire form (``None``: rows)."""
        return self._iter_packing.to_dict() if self._iter_packing is not None else None

    def _effective_credits(self):
        """The credit window scaled by the job's ``credit_scale``, at least
        1; the window itself at a scale of 1.0."""
        credits = self._credits
        if credits is None or self._credit_scale >= 1.0:
            return credits
        return max(1, int(round(credits * self._credit_scale)))

    def _derived_ready_depth(self, streams):
        streams = max(1, int(streams))
        if self._credits is not None:
            return max(4, min(streams * self._credits, 256))
        return max(4, 2 * streams)

    def _apply_transform_local(self, inner):
        transform = self.transform
        try:
            for batch in inner:
                t0 = time.perf_counter()
                batch = transform(batch)
                CLIENT_TRANSFORM_SECONDS.observe(time.perf_counter() - t0)
                yield batch
        finally:
            close = getattr(inner, "close", None)
            if callable(close):
                close()

    def _stream(self, wid, address, pieces, epoch, starts, tagged=True,
                auto_replenish=False):
        return _WorkerStream(wid, address, pieces, epoch, self._connect_timeout,
                             credits=self._effective_credits(),
                             auto_replenish=auto_replenish, tagged=tagged, starts=starts,
                             shuffle_seed=self._shuffle_seed,
                             transform_placement=self._iter_transform_placement,
                             recv_timeout=self._stream_recv_timeout_s,
                             max_frame_bytes=self._max_frame_bytes, job_id=self.job_id,
                             packing=self._iter_packing_dict(), **self._iter_rewrite_kwargs())

    # -- the batch_source contract ----------------------------------------

    def __call__(self):
        info = self._dispatcher_request({"type": "list_workers"})
        with self._lock:
            self._mode = info["mode"]
            self._shuffle_seed = info.get("shuffle_seed")
            # A fresh iteration: the consumer's batch count restarts.
            self._production_count = 0
            self._events = []
            self._batch_events = []
            self._epoch_starts = [(0, self._epoch, set(self._completed),
                                   dict(self._resume_watermarks))]
            self._per_worker = {}
        if self._resumed and getattr(self, "_resume_has_seed", False) \
                and self._resume_seed != self._shuffle_seed:
            logger.warning("resume_state was saved under shuffle_seed=%r but the dispatcher "
                           "runs %r — delivery stays exactly-once, but the resumed order "
                           "will not equal the original run's", self._resume_seed,
                           self._shuffle_seed)
        if self._ordered and info["mode"] == "fcfs":
            raise ValueError(
                "ordered delivery requires static or dynamic sharding: fcfs hands splits "
                "out first-come-first-served, so no canonical piece order exists to "
                "sequence against")
        if self.job_id is not None and info["mode"] == "fcfs":
            raise ValueError(
                "job_id requires static or dynamic sharding: fcfs hands splits out of ONE "
                "shared queue with no per-job assignment, so concurrent jobs would silently "
                "split — not share — each epoch's data. Run the dispatcher with "
                "mode='dynamic' (or 'static') for multi-tenant fleets")
        if self._packing is not None and info["mode"] == "fcfs":
            raise ValueError(
                "packing requires static or dynamic sharding: fcfs serves untagged "
                "per-split streams outside the streaming engine, which is where "
                "worker-side packing runs — or pack trainer-side (PackedBatchSource "
                "placement='trainer')")
        if self.corpus and info["mode"] == "fcfs":
            raise ValueError(
                "corpus= requires static or dynamic sharding: fcfs splits one shared "
                "default-corpus queue (multi-corpus mixes need per-corpus assignments)")
        self._iter_transform_placement = (self._transform_placement
                                          if self.transform is not None else None)
        # Packing and the rewrites freeze the same way: one topology an
        # iteration, on every stream (and cache key) and on the client filter.
        self._iter_packing = self._packing
        hoisted = self._predicate is not None and self._filter_placement == "worker"
        self._iter_filter_placement = (self._filter_placement
                                       if self._predicate is not None else None)
        self._iter_hoisted = hoisted
        self._iter_predicate = self._predicate
        self._iter_projection = self._projection
        self._iter_fused = self._stage_fusion == "fused"
        self._iter_cache_stage = (self._cache_placement
                                  if self._cache_placement != "post-transform" else None)
        self._iter_reader_family = self._reader_family
        self._filter_dropped_batches = 0
        rewriting = (hoisted or self._iter_fused or self._iter_cache_stage is not None
                     or self._iter_reader_family is not None)
        if rewriting and info["mode"] == "fcfs":
            raise ValueError(
                "graph rewrites (filter_placement='worker', stage_fusion, "
                "cache_placement='post-decode', reader_family) require static or dynamic "
                "sharding: fcfs serves untagged per-split streams outside the streaming "
                "piece engine, which is where rewrites run")
        local = self._iter_transform_placement == "local"
        client_filtered = self._predicate is not None and not hoisted

        def wrap(it):
            # The filter sits below the transform, as on the worker side.
            if client_filtered or (self._projection is not None and not hoisted):
                it = self._apply_filter_local(it)
            return self._apply_transform_local(it) if local else it

        if info["mode"] == "static":
            return _SourceIterator(wrap(self._iter_static(info)), prefetched=True)
        if info["mode"] == "dynamic":
            return _SourceIterator(wrap(self._iter_dynamic(info)), prefetched=True)
        if self._resumed:
            raise ValueError(
                "resume_state was supplied but the dispatcher is in fcfs mode: fcfs has no "
                "per-client resumable position, so the snapshot's completed pieces cannot "
                "be skipped — silently re-streaming everything would duplicate trained "
                "data. Run the dispatcher in static or dynamic mode to resume")
        return _SourceIterator(wrap(self._iter_fcfs(info)), prefetched=False)

    # -- static mode -------------------------------------------------------

    def _iter_static(self, info):
        heartbeat_stop = threading.Event()
        heartbeat = None
        if self._heartbeat_interval_s is not None:
            heartbeat = threading.Thread(target=self._heartbeat_loop, args=(heartbeat_stop,),
                                         daemon=True,
                                         name=f"service-heartbeat-{self.client_id}")
            heartbeat.start()
        try:
            yield from self._iter_static_epochs(info)
        finally:
            heartbeat_stop.set()
            if heartbeat is not None:
                heartbeat.join(timeout=5)

    def _iter_static_epochs(self, info):
        num_epochs, epoch, first = info["num_epochs"], self._epoch, True
        while num_epochs is None or epoch < num_epochs:
            reply = self._fetch_assignment(epoch)
            if not reply["assignments"] and num_epochs is None:
                logger.warning("empty static shard and num_epochs is None — ending the "
                               "stream (prefer num_clients <= row-group count)")
                return
            with self._lock:
                skip = set(self._completed)
                # A resumed first epoch starts mid-piece at the snapshot's
                # watermarks; later epochs start clean.
                self._recv_watermarks = dict(self._resume_watermarks) if first else {}
                starts = dict(self._recv_watermarks)
            first = False
            streams, pending_all = {}, []
            for wid, pieces in reply["assignments"].items():
                pending = [p for p in pieces if p not in skip]
                if pending:
                    pending_all.extend(pending)
                    streams[len(streams)] = self._stream(
                        wid, reply["workers"][wid], pending, epoch,
                        {p: starts.get(p, 0) for p in pending})
            sequencer = (_OrderedSequencer(piece_order(self._shuffle_seed, epoch, pending_all))
                         if self._ordered else None)
            yield from self._drain_streams(streams, epoch, sequencer, reply["workers"])
            epoch += 1
            with self._lock:
                self._roll_epoch_locked(epoch)

    def _request_assignment(self, epoch):
        return self._dispatcher_request({
            "type": "get_assignment", "client_id": self.client_id,
            "client_index": self.client_index, "num_clients": self.num_clients,
            "epoch": epoch})

    def _fetch_assignment(self, epoch):
        """The assignment for ``epoch``, with the fencing epoch it was
        computed at as the one this client acts under (a pending fence is
        satisfied). Only for callers that apply the whole assignment."""
        reply = self._request_assignment(epoch)
        with self._lock:
            self._synced_fencing_epoch = int(reply.get("fencing_epoch", 0))
            self._fence_pending = False
        return reply

    def _drain_streams(self, streams, epoch, sequencer=None, workers=None):
        """The multiplexed drain (see the module docstring). Accounting
        happens on the consumer side of the queue, where events of one
        stream arrive in order; credits are acked on dequeue, also in
        ordered mode, where the batch may only be buffered; a broken
        stream recovers on a helper thread (retry, then takeover), so the
        consumer keeps yielding the survivors' batches meanwhile. A
        ``fence`` event resyncs the assignment (deferred while a takeover
        is in flight); with hedging, a silent stream's piece is raced on a
        peer. ``workers`` is the assignment's worker map, the hedge's
        fallback peers."""
        if not streams:
            return
        depth = (self._ready_queue_depth if self._ready_queue_depth is not None
                 else self._derived_ready_depth(len(streams)))
        ready = queue.Queue(maxsize=depth)
        stop = threading.Event()
        readers = []
        retired = set()  # sids a resync or a hedge settlement closed
        sid_counter = itertools.count(max(streams) + 1)
        hedge_armed = self._hedging
        hedge_sids = set()  # sids that are hedge streams
        hedges = {}         # hedged piece -> {"primary": sid, "hedge": sid}
        hedge_won = set()   # pieces a hedge completed: the primary's marker dedups
        last_seen = {}      # sid -> monotonic time of its last batch
        untagged_sids = set()
        hedge_tick = 0.05
        with self._lock:
            self._ready_queue = ready
            self._live_stream_count = len(streams)

        def launch(sid, stream):
            streams[sid] = stream
            last_seen[sid] = time.monotonic()
            with self._lock:
                self._live_stream_count = len(streams)
            reader = _StreamReader(sid, stream, ready, stop, self._note_stream_recv)
            readers.append(reader)
            reader.start()

        def post(event):
            while not stop.is_set():
                try:
                    ready.put(event, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def recover(broken):
            try:
                replacement = self._retry_stream(broken)
                fresh = [replacement] if replacement is not None else self._reassign(broken)
            except BaseException as exc:
                post(("error", None, exc))
                return
            if not post(("recovered", None, fresh)):
                for stream in fresh:  # the drain was torn down meanwhile
                    stream.close()

        def retire(sid):
            stream = streams.pop(sid, None)
            active.discard(sid)
            retired.add(sid)
            if stream is not None:
                stream.close()

        def resync():
            """Re-fetch the assignment under the current fencing epoch and
            keep every stream whose pending pieces still map to its worker;
            the others retire and their pieces relaunch at their watermarks.
            A failed fetch keeps the streams and waits for the next fence."""
            try:
                reply = self._fetch_assignment(epoch)
            except (ServiceError, OSError) as exc:
                logger.warning("resync under a fencing change failed (%s) — keeping the "
                               "current streams; the next heartbeat retries", exc)
                with self._lock:
                    self._recovery_inc("resync_failures")
                    self._fence_pending = False
                return
            with self._lock:
                completed = set(self._completed)
                self._recovery_inc("resyncs")
            desired = {piece: (wid, tuple(reply["workers"][wid]))
                       for wid, pieces in reply["assignments"].items()
                       for piece in pieces if piece not in completed}
            for sid in list(active):
                stream = streams[sid]
                pending = [p for p in stream.pieces if p not in completed]
                if all(desired.get(p, (None,))[0] == stream.worker_id for p in pending):
                    for piece in pending:
                        desired.pop(piece, None)
                    continue
                retire(sid)
                if sid in hedge_sids:
                    drop_hedge(sid, "lost", closed=True)
                else:
                    for piece, pair in list(hedges.items()):
                        if pair["primary"] == sid:
                            hedges.pop(piece)
                with self._lock:
                    self._recovery_inc("streams_retired")
                logger.warning("resync: retiring the stream of worker %s (pieces %s moved)",
                               stream.worker_id, pending)
            regroup = {}
            for piece, target in sorted(desired.items()):
                regroup.setdefault(target, []).append(piece)
            with self._lock:
                marks = dict(self._recv_watermarks)
            for (wid, address), pieces in regroup.items():
                new_sid = next(sid_counter)
                active.add(new_sid)
                launch(new_sid, self._stream(wid, address,
                                             piece_order(self._shuffle_seed, epoch, pieces),
                                             epoch, {p: marks.get(p, 0) for p in pieces}))

        def drop_hedge(hsid, outcome, closed=False):
            """Cancel a hedge stream and clear its pair, so the piece may
            hedge again; ``closed``: its reader already posted its last
            event, so there is none to swallow. The stream is closed either
            way: a broken stream still holds its connection and ring."""
            hedge_sids.discard(hsid)
            if closed:
                stream = streams.pop(hsid, None)
                active.discard(hsid)
                if stream is not None:
                    stream.close()
            else:
                retire(hsid)
            for piece, pair in list(hedges.items()):
                if pair["hedge"] == hsid:
                    hedges.pop(piece)
            self._note_hedge(outcome)

        def settle_hedge(piece, pair, winner_sid):
            """The first ``piece_done`` decides the race: a winning hedge
            flows on (the slow primary's late batches dedup away), a losing
            one is cancelled."""
            hedges.pop(piece, None)
            if winner_sid == pair["hedge"]:
                self._note_hedge("won")
                hedge_won.add(piece)
                stream = streams.get(winner_sid)
                if stream is not None:
                    self._note_stream_success(stream.worker_id)
            else:
                drop_hedge(pair["hedge"], "lost")

        def pick_peer(primary_wid):
            """Another worker whose breaker admits traffic: the one with the
            most recently active stream, else the assignment's next."""
            best, best_seen = None, -1.0
            now = time.monotonic()
            for osid in active:
                other = streams.get(osid)
                if osid in hedge_sids or other is None or other.worker_id == primary_wid:
                    continue
                if self._breaker(other.worker_id).allow(now) \
                        and last_seen.get(osid, 0.0) > best_seen:
                    best, best_seen = (other.worker_id, other.address), last_seen[osid]
            if best is not None:
                return best
            for wid, address in sorted((workers or {}).items()):
                if wid != primary_wid and self._breaker(wid).allow(now):
                    return wid, tuple(address)
            return None

        def maybe_hedge():
            """Hedge the first pending piece of each primary silent past the
            fitted gap threshold (one live hedge per piece)."""
            threshold = self._gap_tracker.threshold_s()
            if threshold is None:
                return
            now = time.monotonic()
            with self._lock:
                completed = set(self._completed)
                marks = dict(self._recv_watermarks)
            for sid in list(active):
                stream = streams.get(sid)
                if stream is None or sid in hedge_sids or sid in untagged_sids:
                    continue
                silent_s = now - last_seen.get(sid, now)
                if silent_s <= threshold:
                    continue
                pending = [p for p in stream.pieces if p not in completed]
                if not pending or pending[0] in hedges:
                    continue
                peer = pick_peer(stream.worker_id)
                if peer is None:
                    continue
                piece = pending[0]
                fp = failpoints.ACTIVE
                if fp is not None:
                    fp.fire("hedge-race")
                hsid = next(sid_counter)
                hedge_sids.add(hsid)
                hedges[piece] = {"primary": sid, "hedge": hsid}
                active.add(hsid)
                self._note_hedge("launched")
                logger.warning("stream of worker %s silent %.2fs (threshold %.2fs) — hedging "
                               "piece %d at watermark %d on %s", stream.worker_id, silent_s,
                               threshold, piece, marks.get(piece, 0), peer[0])
                launch(hsid, self._stream(peer[0], peer[1], [piece], epoch,
                                          {piece: marks.get(piece, 0)}))
                last_seen[sid] = now  # a full window before hedging its next piece

        book = _DeliveryBook(self, epoch)
        active = set()
        try:
            for sid, stream in list(streams.items()):
                launch(sid, stream)
            active.update(streams)
            recovering, fence_deferred = 0, False
            last_hedge_check = time.monotonic()
            while active or recovering:
                if hedge_armed:
                    # A timed get: silence must surface even while the queue
                    # is empty because everything stalled.
                    try:
                        kind, sid, item = ready.get(timeout=hedge_tick)
                    except queue.Empty:
                        maybe_hedge()
                        last_hedge_check = time.monotonic()
                        continue
                    if time.monotonic() - last_hedge_check >= hedge_tick:
                        last_hedge_check = time.monotonic()
                        maybe_hedge()
                else:
                    kind, sid, item = ready.get()
                if sid is not None and sid in retired:
                    # A retired stream's events are stale: its pieces were
                    # relaunched (or its hedge race settled).
                    if kind in ("end", "broken", "error"):
                        retired.discard(sid)
                    continue
                if kind == "batch":
                    batch, piece, ordinal, bid, t_enqueued = item
                    stream = streams[sid]
                    if hedge_armed:
                        now = time.monotonic()
                        self._gap_tracker.observe(now - last_seen.get(sid, now))
                        last_seen[sid] = now
                        if piece is None:
                            untagged_sids.add(sid)
                    # Ack before yielding: the worker refills its window while
                    # the trainer computes on this batch.
                    stream.add_credit(1)
                    if piece is not None and ordinal is not None:
                        with self._lock:
                            duplicate = ordinal < self._recv_watermarks.get(piece, 0)
                            if duplicate:
                                self._recovery_inc("duplicates_dropped")
                            else:
                                self._recv_watermarks[piece] = ordinal + 1
                        if duplicate:
                            CLIENT_DEDUP_DROPPED.labels(
                                "hedge" if piece in hedges or piece in hedge_won
                                else "takeover").inc()
                            continue
                    elif sequencer is not None:
                        raise ServiceError(
                            "ordered delivery needs the tagged stream protocol, but worker "
                            f"{stream.worker_id} sent an untagged batch")
                    CLIENT_READY_QUEUE_DEPTH.set(ready.qsize())
                    if sequencer is not None:
                        released = sequencer.push(piece, (ordinal, batch, stream, bid,
                                                          t_enqueued))
                        CLIENT_WATERMARK_LAG.set(sequencer.lag)
                        yield from book.emit(released)
                    else:
                        book.account_yielded(piece, ordinal, stream.worker_id, bid)
                        if tracing.COLLECTOR.enabled:
                            tracing.COLLECTOR.record_span("client.queue", t_enqueued,
                                                          time.perf_counter(), bid=bid)
                        yield batch
                elif kind in ("piece_done", "piece_failed"):
                    stream = streams.get(sid)
                    if stream is None:
                        continue
                    if kind == "piece_done":
                        piece = int(item)
                        if piece in hedge_won:
                            hedge_won.discard(piece)  # the slow primary's late marker
                            continue
                        pair = hedges.get(piece)
                        if pair is not None:
                            settle_hedge(piece, pair, sid)
                    else:
                        piece, failure = item
                        if sid in hedge_sids:
                            # A hedge is advisory: the primary still owns it.
                            drop_hedge(sid, "lost")
                            continue
                        if self._on_piece_error != "quarantine":
                            raise ServiceError(
                                f"worker {stream.worker_id} failed piece {piece}: {failure} "
                                "(on_piece_error='fail' — run with 'quarantine' to skip "
                                "poison pieces instead)")
                        # Complete the piece empty, so the epoch (and the
                        # sequencer) drains past it.
                        self._note_quarantined(piece, stream.worker_id, failure, epoch)
                    if sequencer is not None:
                        released = sequencer.finish_piece(piece, stream.worker_id)
                        CLIENT_WATERMARK_LAG.set(sequencer.lag)
                        yield from book.emit(released)
                    else:
                        book.complete_piece(piece, stream.worker_id)
                elif kind == "end":
                    stream = streams.pop(sid)
                    self._note_stream_success(stream.worker_id)
                    with self._lock:
                        # An untagged stream completes its pieces here, at
                        # stream granularity. Not in ordered mode: its
                        # markers complete when the sequencer releases them.
                        pending = ([] if sequencer is not None or sid in hedge_sids
                                   else [p for p in stream.pieces if p not in self._completed])
                        if pending:
                            self._completed.update(pending)
                            self._events.append((self._production_count, epoch,
                                                 sorted(pending)))
                            self._note_pieces_locked(stream.worker_id, len(pending))
                    active.discard(sid)
                    hedge_sids.discard(sid)
                elif kind == "error":
                    if sid is not None and sid in hedge_sids:
                        drop_hedge(sid, "lost", closed=True)
                        continue
                    raise item
                elif kind == "recovered":
                    recovering -= 1
                    for new_stream in item:
                        new_sid = next(sid_counter)
                        active.add(new_sid)
                        launch(new_sid, new_stream)
                    if recovering == 0 and fence_deferred:
                        fence_deferred = False
                        resync()
                elif kind == "fence":
                    # Deferred while a takeover is in flight: its streams were
                    # planned under the epoch this resync supersedes.
                    if recovering:
                        fence_deferred = True
                    else:
                        resync()
                else:  # "broken": recover on a helper thread, keep draining
                    if sid in hedge_sids:
                        # A broken hedge never enters recovery.
                        self._note_stream_failure(streams[sid].worker_id)
                        drop_hedge(sid, "lost", closed=True)
                        continue
                    stream = streams.pop(sid)
                    active.discard(sid)
                    recovering += 1
                    threading.Thread(target=recover, args=(stream,), daemon=True,
                                     name=f"service-recover-{stream.worker_id}").start()
            if sequencer is not None:
                # Every piece_done should have cleared the sequencer; flush
                # what a lost marker stranded.
                yield from book.emit(sequencer.drain())
        finally:
            stop.set()
            CLIENT_WATERMARK_LAG.set(0)
            # Closing the sockets unblocks readers parked in recv; the stop
            # flag, those parked on a full queue.
            for stream in streams.values():
                stream.close()
            with self._lock:
                self._ready_queue = None
                self._fence_pending = False
            for reader in readers:
                reader.join(timeout=5)
            self._join_reporters()

    def _note_stream_recv(self, worker_id, stall_s, got_batch):
        """Reader-thread callback: seconds blocked waiting on the worker,
        and one more batch held here."""
        CLIENT_RECV_STALL.labels(worker_id).inc(stall_s)
        with self._lock:
            counters = self._per_worker.setdefault(
                worker_id, {"batches": 0, "stall_s": 0.0, "inflight": 0})
            counters["stall_s"] += stall_s
            if got_batch:
                counters["inflight"] += 1

    def _roll_epoch_locked(self, epoch):
        """Start the next epoch's delivery state; per-batch snapshot events
        older than the epoch just finished are pruned."""
        self._completed = set()
        self._recv_watermarks = {}
        self._resume_watermarks = {}
        self._epoch = epoch
        self._epoch_starts.append((self._production_count, epoch, set(), {}))
        self._batch_events = [e for e in self._batch_events if e[1] >= epoch - 1]

    def _note_consumed_locked(self, worker_id):
        CLIENT_BATCHES.labels(worker_id).inc()
        counters = self._per_worker.setdefault(
            worker_id, {"batches": 0, "stall_s": 0.0, "inflight": 0})
        counters["batches"] += 1
        counters["inflight"] = max(0, counters["inflight"] - 1)

    def _note_pieces_locked(self, worker_id, n):
        counters = self._per_worker.setdefault(
            worker_id, {"batches": 0, "stall_s": 0.0, "inflight": 0})
        counters["pieces"] = counters.get("pieces", 0) + n

    def _pending_and_starts(self, pieces):
        """The not yet completed subset of ``pieces`` and their watermarks:
        what every re-serve re-grants."""
        with self._lock:
            pending = [p for p in pieces if p not in self._completed]
            starts = {p: self._recv_watermarks.get(p, 0) for p in pending}
        return pending, starts

    def _retry_stream(self, stream):
        """Reconnect to the same worker and resume its pending pieces at
        their watermarks; None when it stays unreachable, its retry budget
        is spent, or its circuit breaker is open (fail fast into the
        takeover)."""
        stream.close()
        pending, starts = self._pending_and_starts(stream.pieces)
        if not pending:
            return _EndedStream(stream)
        breaker = self._note_stream_failure(stream.worker_id)
        if not breaker.allow(time.monotonic()):
            logger.warning("circuit breaker %s for worker %s — skipping the reconnect, "
                           "taking the takeover path", breaker.state, stream.worker_id)
            return None

        def attempt():
            fp = failpoints.ACTIVE
            if fp is not None:
                fp.fire("breaker-trip")  # a reconnect reset, fed to the breaker
            fresh = self._stream(stream.worker_id, stream.address, pending, stream.epoch,
                                 starts)
            try:
                event = fresh.next_event()  # forces the connect and a first reply
            except BaseException:
                fresh.close()
                raise
            return fresh, event

        try:
            fresh, event = retry_with_backoff(
                attempt, retries=self._max_retries, base_delay=self._backoff_base,
                max_delay=self._backoff_max, retry_on=(OSError, ProtocolError),
                no_retry_on=(ServiceError,), budget=self._budget(stream.worker_id),
                description=f"reconnect to worker {stream.worker_id}")
        except (OSError, ProtocolError):
            self._note_stream_failure(stream.worker_id)
            return None
        self._note_stream_success(stream.worker_id)
        if event[0] == "end":
            return _EndedStream(fresh)
        return _BufferedStream(fresh, event)

    # -- dynamic mode ------------------------------------------------------

    def _dynamic_stream(self, wid, address, pairs, epoch):
        return _DynamicStream(wid, address, pairs, epoch, self._connect_timeout,
                              credits=self._effective_credits(),
                              shuffle_seed=self._shuffle_seed,
                              transform_placement=self._iter_transform_placement,
                              recv_timeout=self._stream_recv_timeout_s,
                              max_frame_bytes=self._max_frame_bytes, job_id=self.job_id,
                              packing=self._iter_packing_dict(), **self._iter_rewrite_kwargs())

    def _fetch_dynamic_plan(self, epoch):
        """The epoch's initial per-worker deques (pieces stamped with their
        generation); the plan is the freshest state, so the fencing epoch
        it carries is the one this client acts under."""
        reply = self._dispatcher_request({
            "type": "dynamic_plan", "client_id": self.client_id,
            "client_index": self.client_index, "num_clients": self.num_clients,
            "epoch": epoch})
        with self._lock:
            self._synced_fencing_epoch = int(reply.get("fencing_epoch", 0))
            self._fence_pending = False
        return reply

    def _iter_dynamic(self, info):
        num_epochs, epoch, first = info["num_epochs"], self._epoch, True
        heartbeat_stop = threading.Event()
        heartbeat = None
        if self._heartbeat_interval_s is not None:
            heartbeat = threading.Thread(target=self._heartbeat_loop, args=(heartbeat_stop,),
                                         daemon=True,
                                         name=f"service-heartbeat-{self.client_id}")
            heartbeat.start()
        try:
            while num_epochs is None or epoch < num_epochs:
                plan = self._fetch_dynamic_plan(epoch)
                if not plan["assignments"] and num_epochs is None:
                    logger.warning("empty dynamic shard and num_epochs is None — ending the "
                                   "stream")
                    return
                with self._lock:
                    self._recv_watermarks = dict(self._resume_watermarks) if first else {}
                first = False
                yield from self._drain_dynamic(plan, epoch)
                epoch += 1
                with self._lock:
                    self._roll_epoch_locked(epoch)
        finally:
            heartbeat_stop.set()
            if heartbeat is not None:
                heartbeat.join(timeout=5)

    def _drain_dynamic(self, plan, epoch):
        """The dynamic drain (see the module docstring): persistent
        per-worker streams fed from the dispatcher's deques, rebalanced by
        a sync thread. Exactly once across a steal comes from the
        revoke-then-extend handshake, with the ``(piece, generation)`` tag
        of every batch as the net under it; across a takeover from the
        watermark every grant carries as its ``start``. Delivery books are
        static mode's, so ``state_dict`` works per piece."""
        with self._lock:
            skip = set(self._completed)
            marks = dict(self._recv_watermarks)
        piece_state = {}   # piece -> {"wid", "gen", "done", "received"}
        outstanding = {}   # wid -> not-done pieces granted to it
        addresses = {wid: tuple(addr) for wid, addr in plan["workers"].items()}
        initial_grants = {}
        for wid, pairs in plan["assignments"].items():
            outstanding.setdefault(wid, set())
            for entry in pairs:
                piece, gen = int(entry[0]), int(entry[1])
                done = piece in skip
                piece_state[piece] = {"wid": wid, "gen": gen, "done": done, "received": False}
                if not done:
                    outstanding[wid].add(piece)
                    initial_grants.setdefault(wid, []).append((piece, gen, marks.get(piece, 0)))
        remaining = sum(len(ps) for ps in outstanding.values())
        if remaining == 0:
            return
        sequencer = (_OrderedSequencer(piece_order(
            self._shuffle_seed, epoch, [p for p, st in piece_state.items() if not st["done"]]))
            if self._ordered else None)
        depth = (self._ready_queue_depth if self._ready_queue_depth is not None
                 else self._derived_ready_depth(len(initial_grants)))
        ready = queue.Queue(maxsize=depth)
        stop = threading.Event()
        sync_stop = threading.Event()
        sync_poke = threading.Event()
        readers = []
        streams = {}          # sid -> _DynamicStream
        sid_by_wid = {}       # wid -> its live sid
        recovering = set()    # wids mid-takeover (their grants deferred)
        deferred_grants = {}  # wid -> [(piece, gen, start)] awaiting recovery
        pending_steals = {}   # req -> {"wid": donor, "moves": [(piece, to, gen)]}
        failed_steals = []    # [[piece, kept_wid, kept_gen, failed_gen]] for the next sync
        rows_by_wid = {}      # rows received per worker (the sync's rates)
        sid_counter = itertools.count()
        req_counter = itertools.count()
        with self._lock:
            self._ready_queue = ready
            self._live_stream_count = max(1, len(initial_grants))

        def start_reader(sid, wid, stream):
            streams[sid] = stream
            sid_by_wid[wid] = sid
            with self._lock:
                self._live_stream_count = max(1, len(streams))
            reader = _DynamicStreamReader(sid, stream, ready, stop, self._note_stream_recv)
            readers.append(reader)
            reader.start()

        def launch(wid, pairs):
            start_reader(next(sid_counter), wid,
                         self._dynamic_stream(wid, addresses[wid], pairs, epoch))

        def post(event):
            while not stop.is_set():
                try:
                    ready.put(event, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def note_failed_steal(piece, failed_gen):
            """Report a steal that could not apply; the dispatcher reverts
            it only against the generation it names (the report may arrive
            after a newer grant moved the piece)."""
            st = piece_state[piece]
            with self._lock:
                failed_steals.append([piece, st["wid"], st["gen"], failed_gen])
                self._recovery_inc("steals_failed")

        def grant(wid, pairs):
            """``(piece, gen, start)`` grants to a worker's live stream, or a
            new one; deferred while the worker is mid-takeover."""
            if wid in recovering:
                deferred_grants.setdefault(wid, []).extend(pairs)
                return
            sid = sid_by_wid.get(wid)
            if sid is not None and sid in streams:
                streams[sid].extend(pairs)
            elif wid in addresses:
                launch(wid, pairs)
            else:  # no address for this worker: give the pieces back
                for piece, gen, _start in pairs:
                    note_failed_steal(piece, gen)

        def apply_deltas(reply):
            with self._lock:
                self._synced_fencing_epoch = max(self._synced_fencing_epoch,
                                                 int(reply.get("fencing_epoch", 0)))
                self._fence_pending = False
            for wid, addr in (reply.get("workers") or {}).items():
                addresses[wid] = tuple(addr)
            by_donor = {}
            for steal in reply.get("steals", []):
                piece, gen = int(steal["piece"]), int(steal["generation"])
                from_wid, to_wid = steal["from"], steal["to"]
                st = piece_state.get(piece)
                if st is None or st["done"]:
                    continue  # reported done at the next sync anyway
                if st["wid"] == to_wid and st["gen"] == gen:
                    continue  # applied already
                if st["wid"] != from_wid or from_wid in recovering \
                        or sid_by_wid.get(from_wid) not in streams:
                    # The donor moved or broke since the plan: report where
                    # the piece is.
                    note_failed_steal(piece, gen)
                    continue
                by_donor.setdefault(from_wid, []).append((piece, to_wid, gen))
            for donor, moves in by_donor.items():
                req = next(req_counter)
                pending_steals[req] = {"wid": donor, "moves": moves}
                streams[sid_by_wid[donor]].revoke([piece for piece, _, _ in moves], req)

        def on_revoked(item):
            req, revoked_pieces = item
            entry = pending_steals.pop(req, None)
            if entry is None:
                return
            revoked_pieces = set(int(p) for p in revoked_pieces)
            regroup = {}
            for piece, to_wid, gen in entry["moves"]:
                st = piece_state.get(piece)
                if st is None or st["done"]:
                    continue
                if piece in revoked_pieces:
                    with self._lock:
                        outstanding.get(st["wid"], set()).discard(piece)
                        st["wid"], st["gen"] = to_wid, gen
                        outstanding.setdefault(to_wid, set()).add(piece)
                        self._recovery_inc("steals_applied")
                        start = self._recv_watermarks.get(piece, 0)
                    regroup.setdefault(to_wid, []).append((piece, gen, start))
                else:
                    # The donor had sent (or is sending) it: the steal loses.
                    note_failed_steal(piece, gen)
            for to_wid, pairs in regroup.items():
                grant(to_wid, pairs)

        def fail_pending_steals_via(wid):
            """A donor broke mid-handshake: its unacked steals fail (the
            pieces ride the takeover with the rest)."""
            for req in [r for r, e in pending_steals.items() if e["wid"] == wid]:
                for piece, _to, gen in pending_steals.pop(req)["moves"]:
                    st = piece_state.get(piece)
                    if st is not None and not st["done"]:
                        note_failed_steal(piece, gen)

        def recover(wid, sid):
            """Reconnect, else take over, off the consumer thread; pieces
            resume at their watermarks either way."""
            with self._lock:
                pairs = sorted((piece, piece_state[piece]["gen"],
                                self._recv_watermarks.get(piece, 0))
                               for piece in outstanding.get(wid, set()))
            if not pairs:
                post(("dgone", sid, wid))
                return
            try:
                def attempt():
                    fresh = self._dynamic_stream(wid, addresses[wid], pairs, epoch)
                    try:
                        fresh._ensure_conn()  # the dial and the stream request
                    except BaseException:
                        fresh.close()
                        raise
                    return fresh

                try:
                    fresh = retry_with_backoff(
                        attempt, retries=self._max_retries, base_delay=self._backoff_base,
                        max_delay=self._backoff_max, retry_on=(OSError, ProtocolError),
                        no_retry_on=(ServiceError,), description=f"reconnect to worker {wid}")
                except (OSError, ProtocolError):
                    fresh = None
                if fresh is not None:
                    if not post(("drecovered", sid, (wid, fresh))):
                        fresh.close()
                    return
                with self._lock:
                    token = self._synced_fencing_epoch
                request = {"type": "report_failure", "client_id": self.client_id,
                           "worker_id": wid, "pieces": [t[0] for t in pairs],
                           "fencing_epoch": token}
                reply = self._dispatcher_request(request)
                if reply.get("type") == "stale_fencing":
                    with self._lock:
                        self._recovery_inc("stale_fencing_retries")
                    reply = self._dispatcher_request(
                        dict(request, fencing_epoch=int(reply["fencing_epoch"])))
                post(("dtakeover", sid, (wid, reply)))
            except BaseException as exc:
                post(("error", None, exc))

        def sync_loop():
            last_t, last_rows, rate_ema = time.monotonic(), {}, {}
            while not sync_stop.is_set():
                sync_poke.wait(self._dynamic_sync_interval_s)
                sync_poke.clear()
                if sync_stop.is_set():
                    return
                now = time.monotonic()
                dt = max(1e-6, now - last_t)
                with self._lock:
                    done = sorted(p for p, st in piece_state.items() if st["done"])
                    owned = {wid: sorted(ps) for wid, ps in outstanding.items()}
                    stealable = {wid: [p for p in ps if not piece_state[p]["received"]]
                                 for wid, ps in outstanding.items()}
                    rows_now = dict(rows_by_wid)
                    failed = list(failed_steals)
                    del failed_steals[:]
                # EMA rates: one sync window is shorter than a skewed
                # worker's batch period, so raw deltas flap between 0 and
                # bursts. A worker that never delivered stays at 0 ("no
                # rate yet" to the planner).
                for wid in owned:
                    inst = (rows_now.get(wid, 0) - last_rows.get(wid, 0)) / dt
                    prev = rate_ema.get(wid)
                    rate_ema[wid] = inst if prev is None else 0.5 * prev + 0.5 * inst
                rates = {wid: rate_ema.get(wid, 0.0) for wid in owned}
                last_t, last_rows = now, rows_now
                try:
                    reply = self._dispatcher_request({
                        "type": "dynamic_sync", "client_id": self.client_id, "epoch": epoch,
                        "done": done, "owned": owned, "stealable": stealable, "rates": rates,
                        "failed_steals": failed}, retries=0)
                except (ServiceError, OSError, ProtocolError):
                    with self._lock:
                        failed_steals.extend(failed)  # re-reported next tick
                        self._recovery_inc("heartbeat_failures")
                    continue
                if reply.get("type") == "unknown_plan":
                    post(("dreplan", None, None))
                elif reply.get("type") == "deltas":
                    post(("deltas", None, reply))

        def complete(piece, st, wid):
            """Mark a piece done (delivered or quarantined)."""
            with self._lock:
                st["done"] = True
                outstanding.get(st["wid"], set()).discard(piece)
            if sequencer is not None:
                released = sequencer.finish_piece(piece, wid)
                CLIENT_WATERMARK_LAG.set(sequencer.lag)
                return released
            book.complete_piece(piece, wid)
            return []

        def start_recovery(sid, stream, wid=None):
            wid = stream.worker_id if stream is not None else wid
            if sid_by_wid.get(wid) == sid:
                sid_by_wid.pop(wid, None)
            fail_pending_steals_via(wid)
            recovering.add(wid)
            threading.Thread(target=recover, args=(wid, sid), daemon=True,
                             name=f"service-dynrecover-{wid}").start()

        book = _DeliveryBook(self, epoch)
        sync_thread = threading.Thread(target=sync_loop, daemon=True,
                                       name=f"service-dynsync-{self.client_id}")
        try:
            for wid, pairs in initial_grants.items():
                launch(wid, pairs)
            sync_thread.start()
            while remaining > 0:
                kind, sid, item = ready.get()
                if kind == "dbatch":
                    piece, gen, ordinal, payload, bid, t_enqueued = item
                    stream = streams.get(sid)
                    if stream is None:
                        continue  # a torn-down stream's stale event
                    # Ack before yielding, like static.
                    stream.add_credit(1)
                    st = piece_state.get(piece)
                    if st is None or st["done"] or st["gen"] != gen:
                        # A superseded grant's batch: the dedup that makes a
                        # stolen piece count once. The watermark stays: the
                        # current owner serves this ordinal.
                        with self._lock:
                            self._recovery_inc("dedup_dropped")
                        CLIENT_DEDUP_DROPPED.labels("steal").inc()
                        continue
                    if ordinal is not None:
                        with self._lock:
                            duplicate = ordinal < self._recv_watermarks.get(piece, 0)
                            if duplicate:
                                self._recovery_inc("duplicates_dropped")
                            else:
                                self._recv_watermarks[piece] = ordinal + 1
                        if duplicate:
                            CLIENT_DEDUP_DROPPED.labels("takeover").inc()
                            continue
                    elif sequencer is not None:
                        raise ServiceError(
                            "ordered delivery needs ordinal-tagged batches, but worker "
                            f"{stream.worker_id} sent one untagged")
                    st["received"] = True
                    with self._lock:
                        # Rates credit the delivering worker at receipt.
                        rows_by_wid[stream.worker_id] = (
                            rows_by_wid.get(stream.worker_id, 0)
                            + (len(next(iter(payload.values()))) if payload else 0))
                    CLIENT_READY_QUEUE_DEPTH.set(ready.qsize())
                    if sequencer is not None:
                        released = sequencer.push(piece, (ordinal, payload, stream, bid,
                                                          t_enqueued))
                        CLIENT_WATERMARK_LAG.set(sequencer.lag)
                        yield from book.emit(released)
                    else:
                        book.account_yielded(piece, ordinal, stream.worker_id, bid)
                        if tracing.COLLECTOR.enabled:
                            tracing.COLLECTOR.record_span("client.queue", t_enqueued,
                                                          time.perf_counter(), bid=bid)
                        yield payload
                elif kind == "piece_done":
                    piece, gen, _rows = item
                    st = piece_state.get(piece)
                    if st is None or st["done"] or st["gen"] != gen:
                        continue
                    wid = st["wid"]
                    yield from book.emit(complete(piece, st, wid))
                    remaining -= 1
                    with self._lock:
                        drained = not outstanding.get(wid)
                        others_backlogged = any(len(ps) > 1 for w, ps in outstanding.items()
                                                if w != wid)
                    if remaining and drained and others_backlogged:
                        # This deque ran dry while a peer holds backlog:
                        # rebalance now, not at the next tick.
                        sync_poke.set()
                elif kind == "piece_failed":
                    piece, gen, failure = item
                    st = piece_state.get(piece)
                    if st is None or st["done"] or st["gen"] != gen:
                        continue  # a superseded grant's quarantine
                    stream = streams.get(sid)
                    wid = stream.worker_id if stream is not None else None
                    if self._on_piece_error != "quarantine":
                        raise ServiceError(
                            f"worker {wid} failed piece {piece}: {failure} (on_piece_error="
                            "'fail' — run with 'quarantine' to skip poison pieces instead)")
                    self._note_quarantined(piece, wid, failure, epoch)
                    yield from book.emit(complete(piece, st, wid))
                    remaining -= 1
                elif kind == "revoked":
                    on_revoked(item)
                elif kind == "deltas":
                    apply_deltas(item)
                elif kind == "fence":
                    # The dispatcher's state moved: the sync's absolute
                    # report is the reconciliation.
                    sync_poke.set()
                elif kind == "dreplan":
                    # The dispatcher lost the plan: re-seed it; the streams
                    # flow on and later syncs reconcile by corrective steals.
                    try:
                        self._fetch_dynamic_plan(epoch)
                        with self._lock:
                            self._recovery_inc("resyncs")
                    except (ServiceError, OSError):
                        with self._lock:
                            self._recovery_inc("resync_failures")
                elif kind == "error":
                    raise item
                elif kind == "drecovered":
                    wid, fresh = item
                    recovering.discard(wid)
                    old_sid = sid_by_wid.get(wid)
                    if old_sid is not None:
                        streams.pop(old_sid, None)
                    start_reader(next(sid_counter), wid, fresh)
                    pairs = deferred_grants.pop(wid, None)
                    if pairs:
                        fresh.extend(pairs)
                elif kind == "dtakeover":
                    wid, reply = item
                    recovering.discard(wid)
                    if sid_by_wid.get(wid) == sid:
                        sid_by_wid.pop(wid, None)
                    streams.pop(sid, None)
                    with self._lock:
                        self._recovery_inc("takeovers")
                        self._synced_fencing_epoch = max(self._synced_fencing_epoch,
                                                         int(reply.get("fencing_epoch", 0)))
                    for wid2, addr in (reply.get("workers") or {}).items():
                        addresses[wid2] = tuple(addr)
                    # Steals granted to the worker during its recovery are its
                    # pieces too (the dispatcher journaled them): taken over
                    # below with a second report, never left on a dead worker.
                    deferred_grants.pop(wid, None)
                    for wid2, pairs in (reply.get("assignments") or {}).items():
                        fresh_pairs = []
                        with self._lock:
                            for piece, gen in ((int(t[0]), int(t[1])) for t in pairs):
                                st = piece_state.get(piece)
                                if st is None or st["done"]:
                                    continue
                                outstanding.get(st["wid"], set()).discard(piece)
                                st["wid"], st["gen"] = wid2, gen
                                outstanding.setdefault(wid2, set()).add(piece)
                                fresh_pairs.append(
                                    (piece, gen, self._recv_watermarks.get(piece, 0)))
                        if fresh_pairs:
                            grant(wid2, fresh_pairs)
                    with self._lock:
                        stranded = bool(outstanding.get(wid))
                    if stranded:
                        start_recovery(sid, stream=None, wid=wid)
                elif kind == "dgone":
                    wid = item
                    recovering.discard(wid)
                    if sid_by_wid.get(wid) == sid:
                        sid_by_wid.pop(wid, None)
                    streams.pop(sid, None)
                    # Steals granted during the recovery: the ownership maps
                    # already name this worker, so re-grant them (a fresh
                    # stream) rather than orphan them.
                    deferred = deferred_grants.pop(wid, [])
                    if deferred:
                        with self._lock:
                            live = [(piece, gen, self._recv_watermarks.get(piece, 0))
                                    for piece, gen, _start in deferred
                                    if (st := piece_state.get(piece)) is not None
                                    and not st["done"] and st["wid"] == wid]
                        if live:
                            grant(wid, live)
                elif kind in ("end", "broken"):
                    # An end before finish_pieces is a failure while the
                    # worker still owes pieces.
                    stream = streams.pop(sid, None)
                    if stream is None:
                        continue
                    if kind == "broken":
                        stream.close()
                        start_recovery(sid, stream)
                    elif outstanding.get(stream.worker_id):
                        start_recovery(sid, stream)
                    elif sid_by_wid.get(stream.worker_id) == sid:
                        sid_by_wid.pop(stream.worker_id, None)
            if sequencer is not None:
                # Every piece_done cleared the sequencer; flush what a lost
                # marker stranded.
                yield from book.emit(sequencer.drain())
            # The epoch is complete: close the queues so the streams end,
            # then report the final state once (best effort).
            sync_stop.set()
            sync_poke.set()
            for stream in streams.values():
                stream.finish()
            deadline = time.monotonic() + 5.0
            waiting = set(streams)
            while waiting and time.monotonic() < deadline:
                try:
                    kind, sid, item = ready.get(timeout=0.2)
                except queue.Empty:
                    continue
                if kind in ("end", "broken") and sid in waiting:
                    waiting.discard(sid)
            try:
                self._dispatcher_request({
                    "type": "dynamic_sync", "client_id": self.client_id, "epoch": epoch,
                    "done": sorted(p for p, st in piece_state.items() if st["done"]),
                    "owned": {}, "stealable": {}, "rates": {}, "failed_steals": []},
                    retries=0)
            except (ServiceError, OSError, ProtocolError):
                pass  # the next epoch's plan supersedes it
        finally:
            stop.set()
            sync_stop.set()
            sync_poke.set()
            CLIENT_WATERMARK_LAG.set(0)
            for stream in streams.values():
                stream.close()
            with self._lock:
                self._ready_queue = None
                self._fence_pending = False
            if sync_thread.is_alive():
                sync_thread.join(timeout=5)
            for reader in readers:
                reader.join(timeout=5)
            self._join_reporters()

    # -- liveness and fencing ------------------------------------------------

    def _heartbeat_loop(self, stop_event):
        """Poll ``client_heartbeat`` while a static or dynamic drain runs: ship the
        mid-flight watermarks and the ready-queue fullness, sample the
        clock, follow the tracing flag and the brownout level, and post a
        ``fence`` into the drain when the dispatcher's epoch moved past the
        synced one (or it no longer knows this client). An unanswered tick
        is counted, never an error."""
        while not stop_event.wait(self._heartbeat_interval_s):
            with self._lock:
                marks = {str(p): n for p, n in self._recv_watermarks.items()
                         if n and p not in self._completed}
                epoch_now = self._epoch
                ready = self._ready_queue
                saturation = (round(ready.qsize() / ready.maxsize, 4)
                              if ready is not None and ready.maxsize > 0 else 0.0)
            try:
                # One dial (retries=0), so [t0, t1] brackets one round trip.
                t0 = time.perf_counter()
                reply = self._dispatcher_request(
                    {"type": "client_heartbeat", "client_id": self.client_id,
                     "epoch": epoch_now, "watermarks": marks,
                     "ready_saturation": saturation}, retries=0)
                t1 = time.perf_counter()
            except (ServiceError, OSError, ProtocolError):
                with self._lock:
                    self._recovery_inc("heartbeat_failures")
                continue
            remote_us = reply.get("dispatcher_time_us")
            if remote_us is not None:
                self._clock.add(tracing.COLLECTOR.ts_us((t0 + t1) / 2.0), float(remote_us),
                                (t1 - t0) * 1e6)
            self._sync_trace_arming(bool(reply.get("trace")))
            if "brownout_level" in reply:
                note_brownout_level(reply["brownout_level"])
            fencing = int(reply.get("fencing_epoch", 0))
            with self._lock:
                self._recovery["dispatcher"] = dict(reply.get("recovery") or {})
                stale = fencing > self._synced_fencing_epoch or not reply.get("known", True)
            if stale:
                self._post_fence(fencing)
        if self._trace_armed_remote:
            # Ship what was recorded since the last tick, then release.
            self._trace_armed_remote = False
            self._push_trace_ring()
            tracing.COLLECTOR.release()

    def _sync_trace_arming(self, armed):
        """Arm the collector when the fleet arms, push the ring each armed
        tick, release on disarm."""
        if armed and not self._trace_armed_remote:
            self._trace_armed_remote = True
            tracing.COLLECTOR.acquire()
            logger.info("client %s: fleet tracing armed by the dispatcher", self.client_id)
        elif not armed and self._trace_armed_remote:
            self._trace_armed_remote = False
            tracing.COLLECTOR.release()
            return
        if self._trace_armed_remote:
            self._push_trace_ring()

    def _push_trace_ring(self):
        """Ship-and-clear the span ring to the dispatcher with the clock
        offset; a failed push loses that tick's spans."""
        events, dropped = tracing.COLLECTOR.ship()
        if not events and not dropped:
            return
        try:
            self._dispatcher_request(
                {"type": "trace_push", "peer": self.client_id, "events": events,
                 "dropped": dropped, "offset_us": self._clock.offset_us(),
                 "min_rtt_us": self._clock.min_rtt_us()}, retries=0)
        except (ServiceError, OSError, ProtocolError):
            pass

    def _post_fence(self, fencing_epoch):
        """Hand the drain one ``fence`` event (dropped when no drain runs:
        the next assignment fetch syncs anyway)."""
        with self._lock:
            ready = self._ready_queue
            if ready is None or self._fence_pending:
                return
            self._fence_pending = True
        for _ in range(20):  # bounded: never wedge the heartbeat thread
            try:
                ready.put(("fence", None, fencing_epoch), timeout=0.1)
                return
            except queue.Full:
                with self._lock:
                    if self._ready_queue is not ready:
                        break
        with self._lock:
            self._fence_pending = False  # the next heartbeat re-detects

    def _reassign(self, stream):
        """Report ``stream``'s worker dead and return streams for its
        pending pieces on the survivors the dispatcher names, each piece at
        its watermark. A ``stale_fencing`` reply (the plan moved since this
        client fetched it) re-fetches the assignment and routes the broken
        pieces by it."""
        pending, starts = self._pending_and_starts(stream.pieces)
        logger.warning("worker %s unreachable after %d attempts; requesting re-assignment "
                       "of %d pieces", stream.worker_id, self._max_retries + 1, len(pending))
        with self._lock:
            token = self._synced_fencing_epoch
        reply = self._dispatcher_request({
            "type": "report_failure", "client_id": self.client_id,
            "worker_id": stream.worker_id, "pieces": pending, "fencing_epoch": token})
        if reply.get("type") == "stale_fencing":
            with self._lock:
                self._recovery_inc("stale_fencing_retries")
            fresh = self._request_assignment(stream.epoch)
            broken = set(pending)
            assignments = {wid: [p for p in pieces if p in broken]
                           for wid, pieces in fresh["assignments"].items()}
            reply = {"assignments": {wid: ps for wid, ps in assignments.items() if ps},
                     "workers": fresh["workers"]}
        with self._lock:
            self._recovery_inc("takeovers")
        return [self._stream(wid, reply["workers"][wid],
                             piece_order(self._shuffle_seed, stream.epoch, pieces),
                             stream.epoch, {p: starts.get(p, 0) for p in pieces})
                for wid, pieces in reply["assignments"].items()]

    # -- fcfs mode ---------------------------------------------------------

    def _list_workers(self):
        reply = self._dispatcher_request({"type": "list_workers"})
        return {wid: tuple(addr) for wid, addr in reply["workers"].items()}

    def _iter_fcfs(self, info):
        workers = {wid: tuple(addr) for wid, addr in info["workers"].items()}
        rr_counter = 0
        while True:
            reply = self._dispatcher_request({"type": "next_split",
                                              "client_id": self.client_id})
            if reply["type"] == "end_of_stream":
                return
            piece, epoch = reply["piece"], reply["epoch"]
            refreshed = False
            while True:
                if not workers:
                    # The local fleet view drained: replacements may have
                    # registered since.
                    workers = self._list_workers()
                    refreshed = True
                    if not workers:
                        raise ServiceError(f"no worker could serve split {piece} — no "
                                           "live workers registered")
                candidates = sorted(workers)
                start = rr_counter % len(candidates)
                rr_counter += 1
                served = False
                for wid in candidates[start:] + candidates[:start]:
                    served = yield from self._serve_split_with_retries(
                        wid, workers[wid], piece, epoch)
                    if served:
                        break
                    # Unreachable through the retries: report it and serve
                    # the piece elsewhere, from its start (at-least-once).
                    workers.pop(wid, None)
                    try:
                        self._dispatcher_request({"type": "report_failure",
                                                  "client_id": self.client_id,
                                                  "worker_id": wid, "pieces": []})
                    except ServiceError:
                        pass
                if served:
                    break
                if refreshed and not workers:
                    raise ServiceError(f"no worker could serve split {piece} — all "
                                       "workers unreachable")

    def _serve_split_with_retries(self, wid, address, piece, epoch):
        """Yield one split's batches from one worker, retrying connection
        failures on :func:`~petastorm_tpu_torch.utils.backoff_delays` (a
        retry restarts the piece). True when the split was served, False
        when the worker stayed unreachable."""
        from petastorm_tpu_torch.utils import backoff_delays

        delays = backoff_delays(self._max_retries, self._backoff_base, self._backoff_max)
        for attempt in range(self._max_retries + 1):
            # Sequential consumption: receive is consume, so each batch is
            # acked on arrival.
            stream = self._stream(wid, address, [piece], epoch, None, tagged=False,
                                  auto_replenish=True)
            try:
                yield from self._drain_one(stream)
                return True
            except (ConnectionError, OSError, ProtocolError) as exc:
                if attempt == self._max_retries:
                    return False
                sleep_s = next(delays)
                logger.warning("split %s failed on worker %s (%s); retry %d/%d in %.2fs",
                               piece, wid, exc, attempt + 1, self._max_retries, sleep_s)
                self._retry_sleep(sleep_s)
        return False

    def _drain_one(self, stream):
        try:
            while True:
                t0 = time.perf_counter()
                batch = stream.next_batch()
                self._note_stream_recv(stream.worker_id, time.perf_counter() - t0,
                                       batch is not None)
                if batch is None:
                    return
                with self._lock:
                    self._note_consumed_locked(stream.worker_id)
                self.last_bid = stream.last_bid
                yield batch
        finally:
            stream.close()

    # -- checkpoint / diagnostics -----------------------------------------

    def state_dict(self, yielded_batches=None):
        """The resumable position (static and dynamic modes, whose
        snapshots are interchangeable: a steal changes who served a piece,
        never whether it completed): the epoch in progress, the pieces fully
        yielded and the watermarks of pieces mid-delivery, as of the
        ``yielded_batches``-th batch (default: every batch produced), so
        batches a consumer holds in its prefetch queues are re-served on
        resume and none twice. With ``ordered=True`` and the same
        dispatcher seed the resumed stream continues the original's order.
        fcfs mode has no resumable position and raises ValueError."""
        with self._lock:
            if self._mode == "fcfs":
                raise ValueError(
                    "state_dict is not supported in fcfs mode: splits are handed out "
                    "first-come-first-served, so a client has no deterministic resumable "
                    "position — use static sharding for resumable training")
            if yielded_batches is not None and self._filter_dropped_batches:
                # The client filter dropped whole batches: the consumer's
                # count no longer indexes this source's production order.
                raise ValueError(
                    "state_dict(yielded_batches=...) is not supported while the "
                    "trainer-local row filter has dropped whole batches this iteration — "
                    "hoist the filter (filter_placement='worker') for prefetch-exact "
                    "checkpoints of filtered pipelines")
            count = (self._production_count if yielded_batches is None
                     else min(int(yielded_batches), self._production_count))
            epoch, base, base_marks = self._epoch_starts[0][1:]
            for start_count, start_epoch, start_base, start_marks in self._epoch_starts:
                if start_count <= count:
                    epoch, base, base_marks = start_epoch, start_base, start_marks
            completed = set(base)
            completed.update(piece for event_count, event_epoch, pieces in self._events
                             if event_epoch == epoch and event_count <= count
                             for piece in pieces)
            watermarks = dict(base_marks)
            for event_count, event_epoch, piece, ordinal in self._batch_events:
                if event_epoch == epoch and event_count <= count \
                        and ordinal + 1 > watermarks.get(piece, 0):
                    watermarks[piece] = ordinal + 1
            return {
                "version": 2,
                "mode": "dynamic" if self._mode == "dynamic" else "static",
                "client_index": self.client_index,
                "num_clients": self.num_clients,
                "epoch": epoch,
                "completed_pieces": sorted(completed),
                "watermarks": {str(p): n for p, n in sorted(watermarks.items())
                               if n and p not in completed},
                "shuffle_seed": self._shuffle_seed,
                "ordered": self._ordered,
                # Worker-placed packing and the hoisted filter: each changes
                # what the watermarks number.
                "packing": self._iter_packing_dict(),
                "filter": self._hoisted_filter_signature(),
            }

    def _validate_resume_state(self, state):
        if state.get("version") not in (1, 2):
            raise ValueError(f"Unsupported resume_state version {state.get('version')!r}")
        if state.get("mode") not in ("static", "dynamic"):
            raise ValueError("resume_state requires static or dynamic sharding mode")
        for key in ("client_index", "num_clients"):
            if state.get(key) != getattr(self, key):
                raise ValueError(f"resume_state mismatch on {key!r}: checkpoint has "
                                 f"{state.get(key)!r}, this client has "
                                 f"{getattr(self, key)!r}")
        saved_packing = state.get("packing")
        current_packing = self._packing.to_dict() if self._packing is not None else None
        if saved_packing != current_packing:
            raise ValueError(
                f"resume_state packing mismatch: checkpoint watermarks number batches under "
                f"{saved_packing!r}, this source runs {current_packing!r} — resuming would "
                f"re-grant at positions in a different batch vocabulary")
        saved_filter = state.get("filter")
        current_filter = self._hoisted_filter_signature(constructed=True)
        if saved_filter != current_filter:
            raise ValueError(
                f"resume_state hoisted-filter mismatch: checkpoint watermarks number "
                f"batches under worker-placed filter {saved_filter!r}, this source runs "
                f"{current_filter!r} — a hoisted predicate changes each piece's batch "
                f"vocabulary (pieces collate only survivors), so resuming would re-grant "
                f"at wrong positions")

    @property
    def diagnostics(self):
        """Client-side delivery counters: ``ready_queue_depth`` /
        ``ready_queue_capacity`` (0 / 0 outside a drain),
        ``credits_window``, ``transform_placement``, ``epoch_starts``
        (``[produced batch count, epoch]``), ``per_worker`` (``batches``
        consumed, ``stall_s`` blocked waiting on the worker,
        ``credits_outstanding``, ``pieces``), ``quarantined_pieces``,
        ``resilience`` (hedging, the hedge counts and fitted threshold, the
        per-peer breaker and retry-budget snapshots) and ``recovery``
        (resyncs, resync failures, streams retired, takeovers, stale-fencing
        retries, heartbeat failures, duplicates dropped, the dynamic mode's
        steals applied and failed and stale-generation batches dropped,
        pieces quarantined, the last fencing epoch seen, and the
        dispatcher's counters from the last heartbeat)."""
        with self._lock:
            ready = self._ready_queue
            return {
                "ready_queue_depth": ready.qsize() if ready is not None else 0,
                "ready_queue_capacity": ready.maxsize if ready is not None else 0,
                "credits_window": self._credits,
                "transform_placement": self._iter_transform_placement,
                "rewrites": {
                    "filter_placement": self._iter_filter_placement,
                    "stage_fusion": "fused" if self._iter_fused else "off",
                    "cache_placement": self._iter_cache_stage or "post-transform",
                    "reader_family": self._iter_reader_family,
                    "filter_dropped_batches": self._filter_dropped_batches,
                },
                "epoch_starts": [[count, epoch] for count, epoch, *_ in self._epoch_starts],
                "per_worker": {
                    wid: {"batches": c["batches"], "stall_s": round(c["stall_s"], 3),
                          "credits_outstanding": c["inflight"], "pieces": c.get("pieces", 0)}
                    for wid, c in self._per_worker.items()},
                "quarantined_pieces": [dict(entry) for entry in self._quarantined],
                "resilience": {
                    "hedging": self._hedging,
                    "hedge_counts": dict(self._hedge_counts),
                    "hedge_threshold_s": self._gap_tracker.threshold_s(),
                    "breakers": {wid: b.snapshot() for wid, b in self._breakers.items()},
                    "retry_budgets": {wid: b.snapshot() for wid, b in self._budgets.items()},
                },
                "recovery": {key: dict(value) if isinstance(value, dict) else value
                             for key, value in self._recovery.items()},
            }

    def remote_diagnostics(self):
        """Each live worker's ``diagnostics`` (its streams' reader
        diagnostics and flow state)."""
        info = self._dispatcher_request({"type": "list_workers"})
        out = {}
        for wid, addr in info["workers"].items():
            try:
                with FramedConnection.connect(tuple(addr),
                                              timeout=self._connect_timeout) as conn:
                    _, payload = conn.request({"type": "diagnostics"})
                out[wid] = payload
            except OSError as exc:
                out[wid] = {"error": f"unreachable: {exc}"}
        return out

    def dispatcher_status(self):
        """The dispatcher's control-plane snapshot."""
        return self._dispatcher_request({"type": "status"})


class _BufferedStream:
    """A stream whose first event the reconnect probe already pulled: it
    hands that event back first, then proxies."""

    def __init__(self, stream, first_event):
        self._stream = stream
        self._first = first_event
        self.worker_id = stream.worker_id
        self.address = stream.address
        self.pieces = stream.pieces
        self.epoch = stream.epoch
        self.credits = stream.credits
        self.last_bid = stream.last_bid
        self.last_piece = stream.last_piece
        self.last_ordinal = stream.last_ordinal

    def next_event(self):
        if self._first is not None:
            event, self._first = self._first, None
            return event
        event = self._stream.next_event()
        self.last_bid = self._stream.last_bid
        self.last_piece = self._stream.last_piece
        self.last_ordinal = self._stream.last_ordinal
        return event

    def add_credit(self, n=1):
        self._stream.add_credit(n)

    def close(self):
        self._stream.close()


class _EndedStream:
    """A stream that ended during the reconnect probe, or had nothing left
    to re-serve."""

    def __init__(self, stream):
        self.worker_id = stream.worker_id
        self.address = stream.address
        self.pieces = stream.pieces
        self.epoch = stream.epoch
        self.credits = stream.credits
        self.last_bid = self.last_piece = self.last_ordinal = None

    def next_event(self):
        return ("end", None)

    def add_credit(self, n=1):
        pass

    def close(self):
        pass
