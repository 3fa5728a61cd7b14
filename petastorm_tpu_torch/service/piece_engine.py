"""The streaming piece engine: one reader pipeline per stream (the port's own
copy of ``petastorm_tpu/service/piece_engine.py``).

A worker stream builds ONE reader (``dynamic_ventilation=True``: one
dataset enumeration, one pool) and feeds row-group pieces through it from a
mutable queue:

- :meth:`StreamingPieceEngine.enqueue` appends a piece mid-stream (a
  work-stealing grant);
- :meth:`StreamingPieceEngine.revoke` removes pieces no batch of which was
  handed out yet: queued pieces, and pieces already decoded whose batches
  still wait in the engine's ready set, so a slow worker's unsent backlog is
  stealable up to the send boundary;
- :meth:`StreamingPieceEngine.finish` closes the queue; the engine ends once
  everything drained.

Batches are piece-aligned (a ragged tail per piece). Every event names its
piece and the ownership ``generation`` the dispatcher stamped on it, which
lets the client dedup by ``(piece, generation)``. The reader is built lazily
at the first cache miss, so a warm stream builds none; a warm piece's
pre-serialized frames are staged straight from the
:class:`~petastorm_tpu_torch.cache_impl.BatchCache`, a cold one decodes
through the shared pool and fills it. Decode looks ahead ``lookahead``
pieces. ``on_piece_error="quarantine"`` turns a piece whose decode fails
(or the ``piece.decode`` poison failpoint) into a ``piece_failed`` event and
rebuilds the pipeline.

Two graph rewrites run here. Stage fusion (``fused=True``) has the pool
task collate, transform and serialize its piece (the reader's publish
hook) and the engine route the piece's wire-ready batches whole; the bytes
equal the unfused path's, since the same collation, transform and
serializer run. ``cache_stage="post-decode"`` fills the cache with the
batches before the transform and re-applies the transform on every warm
serve.

Threading: :meth:`next_event` runs on the stream-serving thread only;
``enqueue`` / ``revoke`` / ``finish`` may come from a control thread. A
piece's completion rides the pool's item-done markers (FIFO with its
outputs), so its tail is flushed after every one of its outputs was
consumed.

Worker-side sequence packing (``packer_factory``) packs each cold piece's
collated rows before serialization and the cache fill, with one fresh
packer a piece: packed batches stay piece-aligned, the cache holds packed
frames, and event ordinals, watermarks and warm serves count packed
batches.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.reader_impl.delivery_tracker import FusedBatch, FusedPiecePayload
from petastorm_tpu_torch.reader_impl.framed_socket import encode_payload
from petastorm_tpu_torch.service.packing_stage import PackingCollator
from petastorm_tpu_torch.telemetry.metrics import (
    QUARANTINE_REPORTS,
    WORKER_FUSED_STAGE_SECONDS,
)
from petastorm_tpu_torch.workers_pool import EmptyResultError, TimeoutWaitingForResultError

logger = logging.getLogger(__name__)

#: Piece lifecycle states. "decoding" covers a piece staged into the ready
#: set with nothing handed out yet: it is still revocable. "failed": a
#: quarantined poison piece.
_QUEUED, _DECODING, _SERVING, _DONE, _REVOKED, _FAILED = (
    "queued", "decoding", "serving", "done", "revoked", "failed")

#: The collator slot of a piece the fused pool task collates.
_FUSED_PIECE = object()

#: Where the cache sits: after the batch transform (entries hold
#: transformed bytes, warm serves do no work) or before it (entries hold
#: the decoded bytes; every warm serve re-applies the transform).
CACHE_STAGES = ("post-transform", "post-decode")


class _PieceCollator:
    """Collation of ONE piece's reader outputs into ``batch_size`` batches
    (rows buffered, or column batches sliced and stitched), so batch
    boundaries align with piece boundaries."""

    def __init__(self, batch_size, batched_output, ngram, normalize_object=False):
        self._batch_size = batch_size
        self._batched = batched_output
        self._normalize_object = normalize_object
        if not batched_output:
            from petastorm_tpu_torch.torch_utils.batcher import (
                collate_ngram_rows,
                collate_rows,
            )

            self._collate = collate_ngram_rows if ngram else collate_rows
        self._rows = []       # row mode: buffered rows
        self._pending = {}    # column mode: field -> [chunks]
        self._pending_rows = 0
        self._names = None

    def add(self, output):
        """Feed one reader output; the batches it completed."""
        if not self._batched:
            self._rows.append(output)
            if len(self._rows) < self._batch_size:
                return []
            batch, self._rows = self._collate(self._rows), []
            return [batch]
        batch_dict = output._asdict() if hasattr(output, "_asdict") else dict(output)
        if self._names is None:
            self._names = list(batch_dict)
            self._pending = {name: [] for name in self._names}
        rows_in = len(next(iter(batch_dict.values())))
        for name in self._names:
            self._pending[name].append(np.asarray(batch_dict[name]))
        self._pending_rows += rows_in
        out = []
        while self._pending_rows >= self._batch_size:
            out.append(self._emit(self._batch_size))
        return out

    def _emit(self, n):
        out, rest = {}, {}
        for name in self._names:
            chunks = self._pending[name]
            joined = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            column = joined[:n]
            if self._normalize_object and column.dtype == object:
                # A columnar reader makes a nullable column object-dtype for
                # the whole piece; the row family decides per batch. Apply
                # the batch rule to each slice so the families agree.
                from petastorm_tpu_torch.torch_utils.batcher import _stack_column

                column = _stack_column(list(column))
            out[name] = column
            rest[name] = [joined[n:]] if joined.shape[0] > n else []
        self._pending = rest
        self._pending_rows -= n
        return out

    def flush_all(self):
        """The piece's ragged tail, as a list of at most one batch."""
        if not self._batched:
            if not self._rows:
                return []
            batch, self._rows = self._collate(self._rows), []
            return [batch]
        if not self._pending_rows:
            return []
        return [self._emit(self._pending_rows)]


def _rows_of(batch):
    return len(next(iter(batch.values()))) if batch else 0


class StreamingPieceEngine:
    """Serve an editable queue of pieces through one reader pipeline.

    :param reader: a ``dynamic_ventilation=True`` reader over the whole
        piece universe, or a zero-argument callable returning one (built
        lazily at the first cache miss; needed for quarantine, which
        rebuilds it). The engine stops and joins what it built.
    :param batch_size: rows per batch (a piece's last batch ragged).
    :param cache: a :class:`~petastorm_tpu_torch.cache_impl.BatchCache`
        (not owned), with ``cache_key_fn(piece)`` and the per-lookup
        ``cache_note_fn(hit)``.
    :param lookahead: cold pieces kept in the decode pipeline; a piece in
        it is committed to this worker (only unsent work is stealable).
    :param permute_fn: ``(piece, n_batches) -> order``: the serve-time batch
        permutation. Event ordinals number the permuted positions; a cold
        piece is buffered until its batch count is known, and the cache
        fill keeps canonical order.
    :param transform_fn: applied to each cold batch before serialization and
        before the cache fill.
    :param fused: stage fusion: the pool task collates, transforms and
        serializes each piece (row family on a thread or dummy pool;
        otherwise downgraded with a warning, bytes identical).
    :param cache_stage: ``"post-transform"`` or ``"post-decode"`` (the
        fill takes the batches before ``transform_fn``, and warm serves
        re-apply it).
    :param handoff_note_fn: ``fn(seconds)``: the stream thread's collation
        and serialization time, flushed once a piece (fusion's trigger).
    :param columnar_collate: re-apply the row family's dense-vs-object rule
        to object columns of each batch (the columnar reader family).
    :param on_piece_error: ``"fail"`` (a decode error raises) or
        ``"quarantine"`` (the pieces in flight are reported as
        ``("piece_failed", piece, generation, error)`` and the reader is
        rebuilt; the ``piece.decode`` failpoint is attributed exactly).

    :param packer_factory: a zero-argument callable returning a fresh
        :class:`~petastorm_tpu_torch.service.packing_stage.StreamPacker`:
        each cold piece's collated rows are packed before serialization
        and the cache fill, and the packer is flushed at the piece
        boundary. Ordinals number packed batches, so the cache entry's
        frame index is what warm serves and watermark seeks count.
        Refused together with ``transform_fn``.
    """

    def __init__(self, reader, batch_size, cache=None, cache_key_fn=None, cache_note_fn=None,
                 lookahead=2, permute_fn=None, transform_fn=None, on_piece_error="fail",
                 packer_factory=None, fused=False, cache_stage="post-transform",
                 handoff_note_fn=None, columnar_collate=False):
        if on_piece_error not in ("fail", "quarantine"):
            raise ValueError(f"on_piece_error must be 'fail' or 'quarantine', got "
                             f"{on_piece_error!r}")
        if cache_stage not in CACHE_STAGES:
            raise ValueError(f"cache_stage must be one of {CACHE_STAGES}, got {cache_stage!r}")
        if packer_factory is not None and transform_fn is not None:
            raise ValueError(
                "packer_factory and transform_fn cannot combine: the "
                "batch transform is a row-batch stage and packing "
                "changes the batch vocabulary — apply the transform "
                "upstream (transform_spec) or run it trainer-side")
        self._packer_factory = packer_factory
        # Set before a reader instance is installed: installing reads them.
        self._fused = bool(fused)
        self._cache_stage = cache_stage
        self._batch_size = int(batch_size)
        self._cache = cache
        self._transform = transform_fn
        self._handoff = handoff_note_fn
        self._handoff_pending = 0.0  # stream thread only
        self._reader = None
        self._reader_factory = None
        if callable(reader) and not hasattr(reader, "read_next_tagged"):
            self._reader_factory = reader
        else:
            if on_piece_error == "quarantine":
                # Quarantine tears a (possibly wedged) reader down and
                # rebuilds it, which a bare instance cannot do.
                raise ValueError(
                    "on_piece_error='quarantine' needs a reader FACTORY (zero-arg "
                    "callable), not a reader instance: the engine must be able to "
                    "rebuild the pipeline after tearing down one a poison piece wedged")
            self._install_reader(reader)
        self._columnar_collate = bool(columnar_collate)
        self._cache_key_fn = cache_key_fn
        self._cache_note_fn = cache_note_fn
        self._permute = permute_fn
        self._lookahead = max(1, int(lookahead))
        self._on_piece_error = on_piece_error
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._queue = deque()    # pieces awaiting dispatch
        self._state = {}         # piece -> lifecycle state
        self._gen = {}           # piece -> ownership generation
        self._start = {}         # piece -> first batch ordinal to emit
        self._ordinal = {}       # piece -> next batch ordinal (cold path)
        self._rows = {}          # piece -> rows emitted
        self._collators = {}     # piece -> _PieceCollator (cold pieces)
        self._builders = {}      # piece -> cache fill builder (or None)
        self._pending = {}       # piece -> buffered cold batches (permuted serving)
        self._inflight = set()   # pieces submitted whose item-done is unseen
        self._out = deque()      # ready events
        self._finish = False
        self._finished = False
        self._pull_s = 0.0       # decode wait, attributed to the next batch
        self._served_pieces = 0
        self._revoked_pieces = 0
        self._quarantined_pieces = 0
        self._rows_emitted = 0

    def _install_reader(self, reader):
        if not getattr(reader, "dynamic", False):
            raise ValueError("StreamingPieceEngine requires a dynamic_ventilation reader")
        reader.set_item_done_hook(self._on_item_done)
        if self._fused:
            installed = (not reader.batched_output
                         and reader.set_publish_transform(self._make_fused_transform(reader)))
            if not installed:
                logger.warning("engine: stage fusion requested but this reader cannot fuse "
                               "(a batched-output family, or a pool without a publish "
                               "hook); serving unfused, bytes identical")
                self._fused = False
        self._reader = reader

    def _ensure_reader(self):
        """Build the lazily constructed reader (the first cache miss)."""
        if self._reader is None:
            self._install_reader(self._reader_factory())
        return self._reader

    @property
    def reader(self):
        """The owned reader; ``None`` until a piece missed the cache."""
        return self._reader

    @property
    def fused(self):
        """Whether stage fusion is in force (it may have been downgraded
        when the reader was installed)."""
        return self._fused

    def _make_fused_transform(self, reader):
        """The fused pool task's tail, run on the pool's worker thread by
        the publish hook: a piece's decoded rows to wire-ready frames, by
        the namedtuple conversion, collation, transform and serialization
        the unfused stream thread runs. Collation and serialization seconds
        go to ``petastorm_service_worker_fused_stage_seconds_total{stage}``;
        the transform keeps its own family (the worker passes its timed
        wrapper)."""
        schema = reader.schema
        ngram = getattr(reader, "ngram", None)
        batch_size = self._batch_size
        transform = self._transform
        packer_factory = self._packer_factory
        # Post-decode cache placement with a transform: the cache wants the
        # bytes before the transform, the wire after it. Serialize both.
        want_pre = (self._cache is not None and transform is not None
                    and self._cache_stage == "post-decode")
        m_collate = WORKER_FUSED_STAGE_SECONDS.labels("collate")
        m_serialize = WORKER_FUSED_STAGE_SECONDS.labels("serialize")

        def fuse(pair):
            key, rows = pair
            t0 = time.perf_counter()
            if ngram is not None:
                outputs = [ngram.make_namedtuple(schema, row) for row in rows]
            else:
                outputs = schema.make_namedtuples(rows)
            collator = _PieceCollator(batch_size, False, ngram)
            if packer_factory is not None:
                collator = PackingCollator(collator, packer_factory())
            batches = []
            for output in outputs:
                batches.extend(collator.add(output))
            batches.extend(collator.flush_all())
            m_collate.inc(time.perf_counter() - t0)
            fused, serialize_s = FusedPiecePayload(), 0.0
            for batch in batches:
                pre_fmt = pre_frames = None
                if want_pre:
                    ts = time.perf_counter()
                    pre_fmt, pre_frames = encode_payload(batch)
                    # Copied now: the frames alias the decoded arrays, which
                    # an in-place transform below would change first.
                    pre_frames = [bytes(f) for f in pre_frames]
                    serialize_s += time.perf_counter() - ts
                if transform is not None:
                    batch = transform(batch)
                ts = time.perf_counter()
                fmt, frames = encode_payload(batch)
                serialize_s += time.perf_counter() - ts
                fused.append(FusedBatch(_rows_of(batch), fmt, frames, pre_fmt=pre_fmt,
                                        pre_frames=pre_frames))
            m_serialize.inc(serialize_s)
            return key, fused

        return fuse

    # -- queue edits (any thread) -------------------------------------------

    def enqueue(self, piece, generation=0, start=0):
        """Append a piece to the serve queue. Re-enqueueing a revoked piece
        re-arms it (an aborted steal handing it back); an active or served
        piece is ignored. ``start``: the first batch ordinal to emit (the
        client's watermark); the cold path still decodes from the piece's
        beginning and the cache fill still receives every batch, but
        events below ``start`` are suppressed. The warm path seeks straight
        to the ``start``-th cached batch."""
        piece = int(piece)
        with self._lock:
            state = self._state.get(piece)
            if state in (_QUEUED, _DECODING, _SERVING):
                return False
            if state == _DONE:
                logger.warning("engine: ignoring enqueue of already-served piece %d", piece)
                return False
            self._state[piece] = _QUEUED
            self._gen[piece] = int(generation)
            self._start[piece] = max(0, int(start))
            self._queue.append(piece)
        self._wake.set()
        return True

    def revoke(self, pieces):
        """Remove every named piece no batch of which was handed out by
        :meth:`next_event`; returns the pieces removed (the rest stream on
        and stay owned)."""
        removed = []
        with self._lock:
            for piece in pieces:
                piece = int(piece)
                state = self._state.get(piece)
                if state == _QUEUED:
                    try:
                        self._queue.remove(piece)
                    except ValueError:
                        pass
                elif state != _DECODING:
                    continue  # serving or done: too late; unknown: nothing to do
                # A decoding piece stays in _inflight until its item-done
                # marker drains; its outputs are dropped meanwhile.
                self._state[piece] = _REVOKED
                self._collators.pop(piece, None)
                self._builders.pop(piece, None)
                self._pending.pop(piece, None)
                self._revoked_pieces += 1
                removed.append(piece)
            if removed:
                dropped = set(removed)
                self._out = deque(ev for ev in self._out if ev[1] not in dropped)
        if removed:
            self._wake.set()
        return removed

    def finish(self):
        """No more enqueues: the engine ends once queue and pipeline drain."""
        with self._lock:
            self._finish = True
        self._wake.set()

    # -- the serving loop (stream thread only) -------------------------------

    @property
    def finished(self):
        return self._finished

    def next_event(self, timeout=0.1):
        """The next ready event, or ``None`` after about ``timeout`` idle:
        ``("batch", piece, generation, ordinal, rows, fmt, frames,
        decode_s)`` (``ordinal`` the batch's position within its piece),
        ``("piece_done", piece, generation, rows)`` after a piece's last
        batch, or ``("piece_failed", piece, generation, error)`` under
        quarantine. Decode errors raise under ``on_piece_error="fail"``."""
        deadline = time.perf_counter() + timeout
        while True:
            self._dispatch_queued()
            ev = self._pop_ready()
            if ev is not None:
                return ev
            with self._lock:
                pulling = bool(self._inflight)
                finishing = (self._finish and not self._inflight and not self._queue
                             and not self._out)
            if finishing:
                if not self._finished:
                    self._finished = True
                    if self._reader is not None:
                        try:
                            self._reader.finish_pieces()
                        except Exception:  # a teardown race
                            logger.debug("engine: finish_pieces raced teardown",
                                         exc_info=True)
                return None
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return None
            if not pulling:
                # Idle: waiting for a steal grant or finish.
                self._wake.wait(remaining)
                self._wake.clear()
                continue
            t0 = time.perf_counter()
            try:
                out, piece = self._reader.read_next_tagged(timeout=max(remaining, 0.001))
            except TimeoutWaitingForResultError:
                return None
            except EmptyResultError:
                # The feed closed under us (stop): report idle.
                self._finished = True
                return None
            except Exception as exc:
                if self._on_piece_error != "quarantine":
                    raise
                self._quarantine_inflight(exc)
                continue
            self._pull_s += time.perf_counter() - t0
            self._route(out, piece)

    def _pop_ready(self):
        # The lifecycle moves at hand-out time: a piece whose batches are
        # all staged but unsent is still _DECODING, so still stealable.
        with self._lock:
            if not self._out:
                return None
            ev = self._out.popleft()
            if ev[0] == "batch":
                self._state[ev[1]] = _SERVING
            elif ev[0] == "piece_done":
                self._state[ev[1]] = _DONE
                self._served_pieces += 1
            return ev

    def _fail_piece(self, piece, gen, error):
        """Quarantine one piece: drop whatever of it is buffered and emit
        ``piece_failed`` in place of its batches."""
        message = str(error)
        with self._lock:
            self._state[piece] = _FAILED
            self._inflight.discard(piece)
            self._collators.pop(piece, None)
            self._builders.pop(piece, None)
            self._pending.pop(piece, None)
            self._out = deque(ev for ev in self._out if ev[1] != piece)
            self._out.append(("piece_failed", piece, gen, message))
            self._quarantined_pieces += 1
        QUARANTINE_REPORTS.labels("worker").inc()
        logger.warning("engine: quarantining poison piece %d (%s)", piece, message)

    def _quarantine_inflight(self, exc):
        """A decode error from the shared pool (quarantine policy): blame
        the pieces in flight (``lookahead`` bounds them), fail each, and tear
        the reader down; the next cold dispatch rebuilds it. Queued pieces
        re-dispatch on the fresh pipeline."""
        with self._lock:
            victims = sorted(self._inflight)
            reader, self._reader = self._reader, None
        logger.warning("engine: decode error under the quarantine policy — attributing it "
                       "to in-flight piece(s) %s and rebuilding the reader: %r", victims, exc)
        if reader is not None:
            try:
                reader.stop()
                reader.join()
            except Exception:
                logger.warning("engine: poisoned reader teardown failed", exc_info=True)
        self._pull_s = 0.0
        for piece in victims:
            self._fail_piece(piece, self._gen.get(piece, 0), exc)
        if not victims:
            # The pipeline's own error (construction, ventilation).
            raise exc

    def _dispatch_queued(self):
        """Top the pipeline up to ``lookahead`` cold pieces in flight; warm
        pieces are staged from the cache without taking a slot."""
        while True:
            with self._lock:
                if not self._queue or len(self._inflight) >= self._lookahead:
                    return
                piece = self._queue.popleft()
                gen = self._gen[piece]
            fp = failpoints.ACTIVE
            if fp is not None and fp.poison_piece(piece):
                # Injected poison fires before dispatch: exact attribution.
                if self._on_piece_error != "quarantine":
                    raise RuntimeError(f"piece {piece} is poisoned (failpoint piece.decode) "
                                       "and on_piece_error='fail'")
                self._fail_piece(piece, gen, "failpoint piece.decode: poisoned piece")
                continue
            entry = tier = None
            if self._cache is not None and self._cache_key_fn is not None:
                entry, tier = self._cache.get_tiered(self._cache_key_fn(piece))
                if self._cache_note_fn is not None:
                    self._cache_note_fn(entry is not None)
            if entry is not None:
                self._stage_cached(piece, gen, entry, tier)
                continue
            reader = self._ensure_reader()
            with self._lock:
                if self._state.get(piece) != _QUEUED:
                    continue  # revoked between pop and dispatch
                self._state[piece] = _DECODING
                self._inflight.add(piece)
                self._ordinal[piece] = 0
                # A fused piece is collated by its pool task; the sentinel
                # keeps the revoke and item-done bookkeeping.
                collator = _FUSED_PIECE if self._fused else _PieceCollator(
                    self._batch_size, reader.batched_output, getattr(reader, "ngram", None),
                    normalize_object=self._columnar_collate)
                if collator is not _FUSED_PIECE and self._packer_factory is not None:
                    # One fresh packer a piece: a re-decode of the piece
                    # replays the same packed stream (the watermarks).
                    collator = PackingCollator(collator, self._packer_factory())
                self._collators[piece] = collator
                self._builders[piece] = (self._cache.begin_fill(self._cache_key_fn(piece))
                                         if self._cache is not None else None)
            reader.submit_piece(piece)

    def _stage_cached(self, piece, gen, entry, tier=None):
        """A warm piece's cached batches into the ready set, from the
        ``start`` watermark on (a frame-index seek), in the permuted order
        when ``permute_fn`` is armed. Revocable until its first batch is
        handed out."""
        start = self._start.get(piece, 0)
        n = entry.num_batches
        order = self._permute(piece, n) if self._permute is not None else range(n)
        # Post-decode placement: entries hold the bytes before the
        # transform, so each warm serve decodes, transforms and re-encodes
        # (timed into the worker's transform family).
        serve_transform = self._transform if self._cache_stage == "post-decode" else None
        events, rows = [], 0
        for ordinal, source in enumerate(order):
            if ordinal < start:
                continue
            cached = entry.batch_at(source)
            if serve_transform is not None:
                batch = serve_transform(cached.to_dict())
                fmt, frames = encode_payload(batch)
                events.append(("batch", piece, gen, ordinal, _rows_of(batch), fmt, frames, 0.0))
                rows += _rows_of(batch)
                continue
            events.append(("batch", piece, gen, ordinal, cached.rows, cached.fmt,
                           cached.frames, 0.0))
            rows += cached.rows
        events.append(("piece_done", piece, gen, rows))
        with self._lock:
            if self._state.get(piece) != _QUEUED:
                return  # revoked while the entry was fetched
            self._state[piece] = _DECODING  # staged; serving at the first pop
            self._rows[piece] = rows
            self._rows_emitted += rows
            self._out.extend(events)
        if self._permute is not None and self._cache is not None:
            self._cache.note_permuted_serve(tier)

    def _route(self, output, piece):
        """Attribute one reader output to its piece and collate it."""
        if piece is None:
            raise RuntimeError("streaming engine received an untagged reader output — "
                               "per-piece attribution requires tagged payloads")
        if isinstance(output, FusedPiecePayload):
            self._route_fused(output, piece)
            return
        with self._lock:
            collator = self._collators.get(piece)
            builder = self._builders.get(piece)
            gen = self._gen.get(piece, 0)
        if collator is None or collator is _FUSED_PIECE:
            return  # revoked mid-decode (or a stray of a fused piece): dropped
        t0 = time.perf_counter()
        batches = collator.add(output)
        self._note_handoff(time.perf_counter() - t0)
        for batch in batches:
            self._emit_batch(piece, gen, batch, builder)

    def _note_handoff(self, seconds):
        if self._handoff is not None and seconds > 0:
            self._handoff_pending += seconds

    def _flush_handoff(self):
        """The piece's hand-off seconds to the counter: one locked increment
        a piece, not one an output (which would inflate what it measures)."""
        if self._handoff is not None and self._handoff_pending > 0:
            self._handoff(self._handoff_pending)
            self._handoff_pending = 0.0

    def _route_fused(self, batches, piece):
        """One fused piece: the pool task made every wire-ready batch, so
        this fills the cache in canonical order (the pre-transform frames
        under the post-decode placement) and emits the batches, permuted,
        from the ``start`` watermark on."""
        with self._lock:
            if self._collators.get(piece) is not _FUSED_PIECE:
                return  # revoked between dispatch and publish
            builder = self._builders.get(piece)
            gen = self._gen.get(piece, 0)
            start = self._start.get(piece, 0)
        if builder is not None:
            for fb in batches:
                if fb.pre_frames is not None:
                    builder.add_frames(fb.rows, fb.pre_fmt, fb.pre_frames)
                else:
                    builder.add_frames(fb.rows, fb.fmt, fb.frames)
        n = len(batches)
        order = self._permute(piece, n) if self._permute is not None else range(n)
        decode_s, self._pull_s = self._pull_s, 0.0
        events, rows = [], 0
        for ordinal, source in enumerate(order):
            if ordinal < start:
                continue  # below the re-serve watermark
            fb = batches[source]
            events.append(("batch", piece, gen, ordinal, fb.rows, fb.fmt, fb.frames,
                           decode_s if not events else 0.0))
            rows += fb.rows
        with self._lock:
            if self._state.get(piece) == _REVOKED:
                return
            self._rows[piece] = self._rows.get(piece, 0) + rows
            self._rows_emitted += rows
            self._out.extend(events)

    def _emit_batch(self, piece, gen, batch, builder):
        pre_filled = False
        if self._transform is not None:
            if builder is not None and self._cache_stage == "post-decode":
                # Post-decode placement: the fill takes the batch before
                # the transform runs (add_batch copies, so an in-place
                # transform cannot reach the entry).
                t_ser = time.perf_counter()
                builder.add_batch(batch)
                self._note_handoff(time.perf_counter() - t_ser)
                pre_filled = True
            batch = self._transform(batch)
        permuting = self._permute is not None
        with self._lock:
            ordinal = self._ordinal.get(piece, 0)
            self._ordinal[piece] = ordinal + 1
            # Permuted serving applies `start` at the flush: a batch's
            # permuted position is unknown until the piece's count is.
            start = 0 if permuting else self._start.get(piece, 0)
            revoked = self._state.get(piece) == _REVOKED
        decode_s, self._pull_s = self._pull_s, 0.0
        if builder is not None and not revoked:
            # The fill gets every batch (a watermark never publishes a
            # truncated entry); only the emission honors `start`.
            t_ser = time.perf_counter()
            if pre_filled:
                fmt, frames = encode_payload(batch)
                rows = _rows_of(batch)
            else:
                rows, fmt, frames = builder.add_batch(batch)
            self._note_handoff(time.perf_counter() - t_ser)
            if ordinal < start:
                return
        else:
            if revoked or ordinal < start:
                return  # never sent: skip the serialization
            t_ser = time.perf_counter()
            fmt, frames = encode_payload(batch)
            self._note_handoff(time.perf_counter() - t_ser)
            rows = _rows_of(batch)
        with self._lock:
            if self._state.get(piece) == _REVOKED:
                return
            if permuting:
                # Canonical order until the piece completes; then flushed
                # permuted (one piece's batches held at most).
                self._pending.setdefault(piece, []).append((rows, fmt, frames, decode_s))
                return
            self._rows[piece] = self._rows.get(piece, 0) + rows
            self._rows_emitted += rows
            self._out.append(("batch", piece, gen, ordinal, rows, fmt, frames, decode_s))

    def _flush_permuted(self, piece, gen):
        """A cold piece's buffered batches in the permuted order, from the
        ``start`` watermark in permuted positions: the warm path's walk, so
        a re-serve replays identically warm or cold."""
        with self._lock:
            pending = self._pending.pop(piece, None) or []
            start = self._start.get(piece, 0)
        order = self._permute(piece, len(pending))
        events, rows = [], 0
        decode_s = sum(item[3] for item in pending)
        for ordinal, source in enumerate(order):
            if ordinal < start:
                continue
            batch_rows, fmt, frames, _ = pending[source]
            # The piece's decode time rides its first emitted batch.
            events.append(("batch", piece, gen, ordinal, batch_rows, fmt, frames,
                           decode_s if not events else 0.0))
            rows += batch_rows
        with self._lock:
            if self._state.get(piece) == _REVOKED:
                return
            self._rows[piece] = self._rows.get(piece, 0) + rows
            self._rows_emitted += rows
            self._out.extend(events)

    def _on_item_done(self, item):
        """The pool's hook (on the stream thread, inside the results pull):
        the piece published everything; flush its tail, commit its cache
        fill and emit ``piece_done``."""
        piece = item.get("piece_index") if isinstance(item, dict) else None
        if piece is None:
            return
        piece = int(piece)
        with self._lock:
            self._inflight.discard(piece)
            state = self._state.get(piece)
            collator = self._collators.pop(piece, None)
            builder = self._builders.pop(piece, None)
            gen = self._gen.get(piece, 0)
        if state not in (_DECODING, _SERVING) or collator is None:
            return  # revoked: the partial fill is dropped
        if collator is not _FUSED_PIECE:
            # A fused piece's task emitted its tail already.
            for tail in collator.flush_all():
                self._emit_batch(piece, gen, tail, builder)
            self._flush_handoff()
        if builder is not None:
            try:
                builder.commit()
            except Exception:
                logger.warning("cache fill commit failed for piece %d", piece, exc_info=True)
        if self._permute is not None and collator is not _FUSED_PIECE:
            self._flush_permuted(piece, gen)
        with self._lock:
            if self._state.get(piece) == _REVOKED:
                return
            # Still revocable until piece_done is handed out.
            self._out.append(("piece_done", piece, gen, self._rows.get(piece, 0)))

    # -- lifecycle and observability -------------------------------------------

    @property
    def diagnostics(self):
        """The owned reader's diagnostics (once built) and the engine's
        ``engine_*`` counters."""
        reader = self._reader
        out = dict(reader.diagnostics) if reader is not None else {}
        with self._lock:
            out.update({
                "engine_pieces_queued": len(self._queue),
                "engine_pieces_in_flight": len(self._inflight),
                "engine_pieces_served": self._served_pieces,
                "engine_pieces_revoked": self._revoked_pieces,
                "engine_pieces_quarantined": self._quarantined_pieces,
                "engine_rows_emitted": self._rows_emitted,
                "engine_finished": self._finished,
                "engine_fused": self._fused,
            })
        return out

    def queued_pieces(self):
        with self._lock:
            return list(self._queue)

    def stop(self):
        """Stop the owned reader (nothing, if none was built)."""
        with self._lock:
            self._finish = True
        if self._reader is not None:
            self._reader.stop()

    def join(self):
        if self._reader is not None:
            self._reader.join()

    def close(self):
        """Stop and join the owned reader."""
        try:
            self.stop()
        finally:
            self.join()
