"""Sequence packing as a first-class service stage (the port's own copy of
``petastorm_tpu/service/packing_stage.py``).

``torch_utils/packing.py::pack_ragged`` is a whole-stream generator: give it
every ragged row and it hands back dense ``[B, T]`` batches. A *service*
stage cannot work that way — the worker's streaming engine feeds rows
piece by piece and must checkpoint mid-stream, the trainer's batch source
must resume bit-exactly after a kill, and the cache needs to know how many
batches an entry holds when that count is no longer derivable from the row
count (packing is a ratio-changing operator: N variable-length rows → M
dense batches, M a function of the length *distribution* through first-fit
placement). This module is the stateful, checkpointable core that makes
the generator's layout contract (segment ids, positions, first-fit — see
``docs/guides/llm.md``) servable:

- :class:`PackingSpec` — the wire/fingerprint description of one packing
  configuration. Rides stream requests (worker placement), cache keys
  (packed entries must never serve an unpacked stream or a different
  geometry), and checkpoints (a resume under a different spec is refused,
  not silently re-packed).
- :class:`StreamPacker` — the incremental packer. ``add_batch`` /
  ``add_row`` consume rows as they arrive and emit packed batches as rows
  fill them; the **open batch** (rows placed but not yet emitted) is
  explicit state with a crc-guarded ``state_dict`` / ``load_state_dict``
  round-trip, so a kill-then-restore resumes the packed stream bit-exactly
  instead of replaying or losing the carry-over. Emission order is a pure
  function of the input row order — two packers fed the same rows emit the
  same bytes.
- :class:`PackingCollator` — the worker-side adapter: wraps the streaming
  engine's per-piece collator so a piece's decoded rows are packed *before*
  serialization and the cache fill. Cache entries then hold packed frames
  (a warm epoch serves packed batches with zero re-pack), ordinals and
  watermarks number *packed* batches, and the packer is flushed at the
  piece boundary so packed batches stay piece-aligned — every delivery
  invariant (exactly-once re-grants, serve-time permutation, revocation)
  applies to the packed stream unchanged.
- :class:`PackedBatchSource` — the trainer-side placement of the same
  stage, and the placement *switch*: ``placement="worker"`` arms packing
  on the wrapped :class:`~petastorm_tpu_torch.service.client.ServiceBatchSource`
  (stream requests carry the spec; workers pack pre-serialization);
  ``placement="trainer"`` strips it and packs locally, carrying the open
  batch across piece and epoch boundaries with its state snapshotted into
  ``state_dict`` v2. :meth:`~PackedBatchSource.set_packing_placement` is
  the ``set_transform_placement``-style binding the pipeline graph
  exposes to the autotuner (``docs/guides/pipeline.md``).

Failure injection: the ``packing.state`` failpoint (action ``torn``) tears
a snapshot's serialized open-batch state the way a crash mid-checkpoint
would; ``load_state_dict`` detects the tear by crc and refuses it loudly
(like the journal's mid-file corruption) instead of resuming a silently
corrupted carry-over.
"""

from __future__ import annotations

import base64
import binascii
import time

import numpy as np

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.torch_utils.packing import (
    PACK_POSITION_KEY,
    PACK_SEGMENT_KEY,
)
from petastorm_tpu_torch.telemetry.log import service_logger
from petastorm_tpu_torch.telemetry.metrics import (
    PACKING_BATCHES,
    PACKING_FILL_RATIO,
    PACKING_SECONDS,
    PACKING_SEQUENCES,
    PACKING_TOKENS,
)

logger = service_logger(__name__)

#: state_dict schema version for :class:`StreamPacker` snapshots.
PACKER_STATE_VERSION = 1

#: Dropped-field combinations already warned about (process-wide): the
#: worker builds one packer per piece, so per-instance warning state
#: would re-log the same drop for every piece of every stream.
_WARNED_DROPS = set()


class PackingStateError(ValueError):
    """A packer snapshot failed validation (torn/corrupt open-batch state,
    or a spec mismatch): resuming it would corrupt the packed stream, so
    the restore is refused loudly."""


class PackingSpec:
    """One packing configuration, canonical across every layer.

    :param slot_len: tokens per batch row (the static T).
    :param slots: batch rows per packed batch (the static B).
    :param sequence_fields: the fields whose leading axis is the sequence
        (lengths may differ per row; trailing dims must agree row-to-row).
    :param length_field: optional int column holding each row's true
        sequence length — the standard ragged-in-Parquet layout (static
        shapes on disk, true length as data). Consumed by the packing
        stage, never emitted into packed batches.
    """

    def __init__(self, slot_len, slots, sequence_fields, length_field=None):
        self.slot_len = int(slot_len)
        self.slots = int(slots)
        if self.slot_len <= 0 or self.slots <= 0:
            raise ValueError(
                f"slot_len and slots must be positive, got "
                f"slot_len={slot_len!r} slots={slots!r}")
        fields = tuple(str(f) for f in sequence_fields or ())
        if not fields:
            raise ValueError("sequence_fields must name at least one field")
        if len(set(fields)) != len(fields):
            raise ValueError(
                f"sequence_fields has duplicates: {list(fields)}")
        self.sequence_fields = fields
        self.length_field = (str(length_field)
                             if length_field is not None else None)
        if self.length_field in self.sequence_fields:
            raise ValueError(
                f"length_field {self.length_field!r} cannot also be a "
                f"sequence field (it is metadata consumed by the packer)")

    def to_dict(self):
        """JSON-safe wire form (stream requests, checkpoints, journals)."""
        return {"slot_len": self.slot_len, "slots": self.slots,
                "sequence_fields": list(self.sequence_fields),
                "length_field": self.length_field}

    @classmethod
    def from_dict(cls, d):
        if isinstance(d, PackingSpec):
            return d
        return cls(d["slot_len"], d["slots"], d["sequence_fields"],
                   d.get("length_field"))

    def key_dict(self):
        """The cache-fingerprint ingredient: everything that changes the
        packed bytes. Deterministically ordered."""
        return {"slot_len": self.slot_len, "slots": self.slots,
                "sequence_fields": list(self.sequence_fields),
                "length_field": self.length_field}

    def __eq__(self, other):
        return (isinstance(other, PackingSpec)
                and self.to_dict() == other.to_dict())

    def __repr__(self):
        return (f"PackingSpec(slot_len={self.slot_len}, slots={self.slots},"
                f" sequence_fields={list(self.sequence_fields)},"
                f" length_field={self.length_field!r})")


def packed_token_count(batch):
    """Real (non-padding) token positions in one packed batch."""
    return int((np.asarray(batch[PACK_SEGMENT_KEY]) >= 0).sum())


def _encode_array(arr):
    arr = np.ascontiguousarray(arr)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


def _decode_array(d):
    raw = base64.b64decode(d["data"].encode("ascii"))
    arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
    return arr.reshape(d["shape"]).copy()


class StreamPacker:
    """Incremental first-fit sequence packer with checkpointable state.

    Emission is identical to :func:`~petastorm_tpu_torch.torch_utils.packing.
    pack_ragged` fed the same row stream (pinned by tier-1 goldens):
    first-fit into the leftmost row with room, over-long sequences raise,
    zero-length sequences are skipped, the open batch is emitted when the
    next sequence fits nowhere (and on :meth:`flush`, if it holds
    anything).

    :param spec: the :class:`PackingSpec` (or its dict form).
    :param placement: metric label — ``"worker"`` or ``"trainer"``
        (where this stage instance runs).
    """

    def __init__(self, spec, placement="trainer"):
        self.spec = PackingSpec.from_dict(spec)
        self.placement = str(placement)
        self._keys = list(self.spec.sequence_fields)
        self._open = None          # open-batch state dict, or None
        self._sequences = 0        # sequences packed (lifetime)
        self._tokens = 0           # real tokens packed (lifetime)
        self._emitted = 0          # packed batches emitted (lifetime)
        self._emitted_tokens = 0   # real tokens in emitted batches
        self._m_batches = PACKING_BATCHES.labels(self.placement)
        self._m_sequences = PACKING_SEQUENCES.labels(self.placement)
        self._m_tokens = PACKING_TOKENS.labels(self.placement)
        self._m_seconds = PACKING_SECONDS.labels(self.placement)
        self._m_fill = PACKING_FILL_RATIO.labels(self.placement)

    # -- packing ----------------------------------------------------------

    def _fresh(self, proto_row):
        spec = self.spec
        cols = {}
        for key in self._keys:
            if key not in proto_row:
                raise ValueError(
                    f"packing field {key!r} missing from row (row has "
                    f"{sorted(proto_row)})")
            arr = np.asarray(proto_row[key])
            if arr.ndim < 1:
                raise ValueError(
                    f"packing field {key!r} must have a sequence axis "
                    f"(got a scalar)")
            cols[key] = np.zeros((spec.slots, spec.slot_len)
                                 + arr.shape[1:], arr.dtype)
        return {
            "cols": cols,
            "seg": np.full((spec.slots, spec.slot_len), -1, np.int32),
            "pos": np.zeros((spec.slots, spec.slot_len), np.int32),
            "used": np.zeros(spec.slots, np.int64),
            "count": np.zeros(spec.slots, np.int32),
        }

    def _emit(self):
        st = self._open
        out = {k: v for k, v in st["cols"].items()}
        out[PACK_SEGMENT_KEY] = st["seg"]
        out[PACK_POSITION_KEY] = st["pos"]
        self._open = None
        self._emitted += 1
        tokens = int(st["used"].sum())
        self._emitted_tokens += tokens
        self._m_batches.inc()
        capacity = self.spec.slots * self.spec.slot_len
        self._m_fill.set(round(tokens / capacity, 4))
        return out

    def add_row(self, row):
        """Place one ragged row (``{field: [length, ...]}``); return the
        packed batches completed by it (0 or 1)."""
        t0 = time.perf_counter()
        row = {k: np.asarray(row[k]) for k in self._keys}
        length = row[self._keys[0]].shape[0]
        for key in self._keys:
            if row[key].shape[0] != length:
                raise ValueError(
                    f"field {key!r} length {row[key].shape[0]} != "
                    f"{self._keys[0]!r} length {length} (packed fields "
                    f"must share the sequence axis)")
        if length > self.spec.slot_len:
            raise ValueError(
                f"sequence of length {length} does not fit slot_len "
                f"{self.spec.slot_len}; split long sequences upstream")
        out = []
        if length == 0:
            # No tokens to place: skipping keeps segment ids dense (the
            # same rule as pack_ragged).
            return out
        if self._open is None:
            self._open = self._fresh(row)
        st = self._open
        fit = np.nonzero(st["used"] + length <= self.spec.slot_len)[0]
        if fit.size == 0:
            out.append(self._emit())
            self._open = st = self._fresh(row)
            fit = np.array([0])
        b = int(fit[0])
        start = int(st["used"][b])
        for key in self._keys:
            st["cols"][key][b, start:start + length] = row[key]
        st["seg"][b, start:start + length] = st["count"][b]
        st["pos"][b, start:start + length] = np.arange(length)
        st["used"][b] += length
        st["count"][b] += 1
        self._sequences += 1
        self._tokens += int(length)
        self._m_sequences.inc()
        self._m_tokens.inc(int(length))
        self._m_seconds.observe(time.perf_counter() - t0)
        return out

    def add_batch(self, batch):
        """Consume one collated row batch (``{field: [N, ...]}`` plus an
        optional length column per the spec); return the packed batches
        it completed. Every row is either in a returned batch or in the
        open carry-over state when this returns."""
        spec = self.spec
        dropped = frozenset(k for k in batch if k not in self._keys
                            and k != spec.length_field)
        if dropped and dropped not in _WARNED_DROPS:
            # Same contract as pack_ragged's one-time warning: fields the
            # spec does not pack vanish from the served (and cached)
            # stream — losing labels silently is how data bugs ship.
            _WARNED_DROPS.add(dropped)
            logger.warning(
                "packing drops non-packed field(s) %s — packing has no "
                "per-sequence row to carry them on (keep them upstream, "
                "fold them into a packed field, or add them to "
                "sequence_fields)", sorted(dropped))
        cols = {}
        for key in self._keys:
            if key not in batch:
                raise ValueError(
                    f"packing field {key!r} missing from batch (batch has "
                    f"{sorted(batch)})")
            cols[key] = np.asarray(batch[key])
        n = cols[self._keys[0]].shape[0]
        lengths = None
        if spec.length_field is not None:
            if spec.length_field not in batch:
                raise ValueError(
                    f"length_field {spec.length_field!r} missing from "
                    f"batch (batch has {sorted(batch)})")
            lengths = np.asarray(batch[spec.length_field]).reshape(-1)
            if lengths.shape[0] != n:
                raise ValueError(
                    f"length_field {spec.length_field!r} has "
                    f"{lengths.shape[0]} entries for {n} rows")
        out = []
        for i in range(n):
            cut = int(lengths[i]) if lengths is not None else None
            out.extend(self.add_row(
                {k: cols[k][i][:cut] for k in self._keys}))
        return out

    def flush(self):
        """Emit the open batch (``None`` when nothing is carried): the
        piece-boundary call worker-side, the end-of-stream call
        trainer-side."""
        if self._open is None or int(self._open["count"].sum()) == 0:
            self._open = None
            return None
        return self._emit()

    # -- observability ----------------------------------------------------

    @property
    def open_sequences(self):
        """Sequences currently in the open (carry-over) batch."""
        return (int(self._open["count"].sum())
                if self._open is not None else 0)

    def stats(self):
        return {"sequences": self._sequences, "tokens": self._tokens,
                "packed_batches": self._emitted,
                "emitted_tokens": self._emitted_tokens,
                "open_sequences": self.open_sequences}

    # -- checkpointing ----------------------------------------------------

    def raw_state(self):
        """Cheap deep copy of the resumable state — array copies, no
        encoding, no crc. What :class:`PackedBatchSource` stores per
        row batch in its snapshot history; :meth:`serialize_state` turns
        the ONE boundary a checkpoint actually selects into the durable
        form (serializing every history entry eagerly would pay
        base64+crc of the whole open batch on the packing hot path)."""
        open_copy = None
        if self._open is not None:
            st = self._open
            open_copy = {
                "cols": {k: st["cols"][k].copy() for k in self._keys},
                "seg": st["seg"].copy(), "pos": st["pos"].copy(),
                "used": st["used"].copy(), "count": st["count"].copy(),
            }
        return {
            "open": open_copy,
            "counters": {"sequences": self._sequences,
                         "tokens": self._tokens,
                         "emitted": self._emitted,
                         "emitted_tokens": self._emitted_tokens},
        }

    def state_dict(self):
        """The packer's full resumable state, JSON-round-trippable. The
        open batch's arrays are serialized with a crc over their raw
        bytes; :meth:`load_state_dict` refuses a snapshot whose payload
        does not match (a torn write must fail the restore, not resume a
        corrupted carry-over — the ``packing.state`` failpoint injects
        exactly that tear)."""
        return self.serialize_state(self.raw_state())

    def serialize_state(self, raw):
        """Durable (JSON-safe, crc-guarded) form of a :meth:`raw_state`
        snapshot."""
        open_state = None
        crc = 0
        if raw.get("open") is not None:
            st = raw["open"]
            payloads = [np.ascontiguousarray(st["seg"]).tobytes(),
                        np.ascontiguousarray(st["pos"]).tobytes(),
                        np.ascontiguousarray(st["used"]).tobytes(),
                        np.ascontiguousarray(st["count"]).tobytes()]
            payloads += [np.ascontiguousarray(st["cols"][k]).tobytes()
                         for k in self._keys]
            for payload in payloads:
                crc = binascii.crc32(payload, crc)
            open_state = {
                "cols": {k: _encode_array(st["cols"][k])
                         for k in self._keys},
                "seg": _encode_array(st["seg"]),
                "pos": _encode_array(st["pos"]),
                "used": _encode_array(st["used"]),
                "count": _encode_array(st["count"]),
            }
            fp = failpoints.ACTIVE
            if fp is not None and fp.check("packing.state") == "torn":
                # Crash-mid-checkpoint: half the first column's payload
                # reaches the snapshot; the crc (computed over the real
                # bytes above) no longer matches, exactly like a torn
                # file write. load_state_dict must detect and refuse.
                first = open_state["cols"][self._keys[0]]
                first["data"] = first["data"][:len(first["data"]) // 2]
        return {
            "version": PACKER_STATE_VERSION,
            "spec": self.spec.to_dict(),
            "counters": dict(raw.get("counters") or {}),
            "open": open_state,
            "crc": crc,
        }

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` snapshot bit-exactly. Raises
        :class:`PackingStateError` on version/spec mismatch or a payload
        that fails the crc (torn snapshot)."""
        if not isinstance(state, dict) \
                or state.get("version") != PACKER_STATE_VERSION:
            raise PackingStateError(
                f"unsupported packer state version "
                f"{state.get('version') if isinstance(state, dict) else state!r}")
        spec = PackingSpec.from_dict(state["spec"])
        if spec != self.spec:
            raise PackingStateError(
                f"packer state was saved under {spec!r} but this packer "
                f"runs {self.spec!r} — a resume must not silently re-pack "
                f"under a different geometry")
        open_state = state.get("open")
        if open_state is None:
            self._open = None
        else:
            try:
                st = {
                    "cols": {k: _decode_array(open_state["cols"][k])
                             for k in self._keys},
                    "seg": _decode_array(open_state["seg"]),
                    "pos": _decode_array(open_state["pos"]),
                    "used": _decode_array(open_state["used"]),
                    "count": _decode_array(open_state["count"]),
                }
            except (KeyError, ValueError, binascii.Error) as exc:
                raise PackingStateError(
                    f"packer open-batch state is torn/corrupt: {exc}") \
                    from exc
            crc = 0
            for payload in ([st["seg"].tobytes(), st["pos"].tobytes(),
                             st["used"].tobytes(), st["count"].tobytes()]
                            + [st["cols"][k].tobytes()
                               for k in self._keys]):
                crc = binascii.crc32(payload, crc)
            if crc != int(state.get("crc", -1)):
                raise PackingStateError(
                    "packer open-batch state failed its crc check (torn "
                    "or corrupted snapshot) — refusing to resume a "
                    "corrupted carry-over; restore from an intact "
                    "checkpoint")
            self._open = st
        counters = state.get("counters") or {}
        self._sequences = int(counters.get("sequences", 0))
        self._tokens = int(counters.get("tokens", 0))
        self._emitted = int(counters.get("emitted", 0))
        self._emitted_tokens = int(counters.get("emitted_tokens", 0))


class PackingCollator:
    """Worker-side adapter: a streaming-engine piece collator whose row
    batches are packed before emission. ``add`` has the engine's collator
    contract (reader output in, COMPLETE batches out); ``flush_all``
    drains both the inner collator's ragged tail and the packer's open
    batch — called at the piece boundary, so packed batches are
    piece-aligned and a piece's packed emission is a pure function of its
    rows (what makes watermark re-serves and cache fills line up)."""

    def __init__(self, inner, packer):
        self._inner = inner
        self._packer = packer

    def add(self, output):
        out = []
        for row_batch in self._inner.add(output):
            out.extend(self._packer.add_batch(row_batch))
        return out

    def flush_all(self):
        out = []
        for tail in self._inner.flush_all():
            out.extend(self._packer.add_batch(tail))
        final = self._packer.flush()
        if final is not None:
            out.append(final)
        return out


class _PackedIterator:
    """Iterator shell matching the batch-source contract: carries the
    ``prefetched`` marker (the loader consumes prefetched sources
    directly, without a producer thread) and forwards ``close``."""

    def __init__(self, gen, prefetched):
        self._gen = gen
        self.prefetched = prefetched

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()


class PackedBatchSource:
    """Packing stage with flippable placement over a service batch source.

    Wraps a :class:`~petastorm_tpu_torch.service.client.ServiceBatchSource`
    (any batch source with the same contract works for trainer placement):

    - ``placement="worker"`` — the wrapped source's stream requests carry
      the spec; workers pack pre-serialization (cache entries hold packed
      frames, ordinals/watermarks number packed batches) and this wrapper
      passes delivered batches through untouched.
    - ``placement="trainer"`` — stream requests carry no packing; row
      batches are packed here, with the open batch carried across piece
      and epoch boundaries and snapshotted into :meth:`state_dict` (the
      v2 checkpoint carries the packer's open-batch state, so
      kill-then-restore resumes the packed stream bit-exactly).

    :meth:`set_packing_placement` flips between them at the next
    iteration boundary — the pipeline graph binds it as the
    ``packing_placement`` knob so the autotuner can move the stage the
    same way it moves the batch transform.

    Trainer-placement checkpoints: the wrapper snapshots
    ``(inner position, packer state, packed-batches emitted)`` *before*
    each row batch is consumed and keeps the last ``history`` snapshots,
    so ``state_dict(yielded_batches=n)`` — the loader passes the
    consumer's true position — resolves any prefetch lag to an exact
    boundary: resume restores the inner source at that row batch, the
    packer's open state, and skips the packed batches the boundary had
    already emitted. Pass the snapshot's ``["inner"]`` as the inner
    source's ``resume_state=`` and the whole snapshot as this wrapper's
    ``resume_state=``.

    :param history: trainer-placement snapshots retained; must exceed the
        consumer's prefetch depth (the loader's ``host_prefetch`` +
        ``device_prefetch``).
    """

    def __init__(self, source, packing, placement="worker", history=64,
                 resume_state=None):
        self.spec = PackingSpec.from_dict(packing)
        if placement not in ("worker", "trainer"):
            raise ValueError(
                f"placement must be 'worker' or 'trainer', got "
                f"{placement!r}")
        self._source = source
        self._placement = placement
        self._iter_placement = placement
        self._history_depth = max(1, int(history))
        self._history = []  # [(packed_emitted, inner_consumed, raw_state)]
        self._live_packer = None
        self._packed_emitted = 0
        #: Absolute packed-batch position where the CURRENT iteration's
        #: consumer-visible stream starts: the loader's
        #: ``yielded_batches`` counts are relative to the iteration,
        #: while the snapshot history counts absolute emission — this
        #: base is the translation that keeps checkpoint-of-a-resume
        #: (and checkpoints in later epochs) exact. Set at each trainer
        #: ``__call__``.
        self._iter_base = 0
        self._resume = None
        if resume_state is not None:
            if resume_state.get("kind") != "packed_v1":
                raise PackingStateError(
                    f"resume_state is not a PackedBatchSource snapshot "
                    f"(kind={resume_state.get('kind')!r})")
            saved_spec = PackingSpec.from_dict(resume_state["spec"])
            if saved_spec != self.spec:
                raise PackingStateError(
                    f"resume_state was saved under {saved_spec!r} but "
                    f"this source packs {self.spec!r}")
            self._resume = resume_state
            self._placement = resume_state.get("placement", placement)
            self._iter_placement = self._placement
            self._iter_base = (int(resume_state.get("packed_batches", 0))
                               + int(resume_state.get("skip", 0)))

    # -- placement (the autotuner's knob) ---------------------------------

    @property
    def packing_placement(self):
        """Where packing will run from the NEXT iteration on."""
        return self._placement

    def set_packing_placement(self, placement):
        """Flip the packing stage between the workers ("worker") and this
        trainer host ("trainer"). Takes effect at the next iteration
        boundary — each iteration's placement is frozen when it starts,
        so its streams and cache keys agree end to end."""
        if placement not in ("worker", "trainer"):
            raise ValueError(
                f"packing_placement must be 'worker' or 'trainer', got "
                f"{placement!r}")
        if placement != self._placement:
            logger.info("packing placement -> %s (next iteration)",
                        placement)
        self._placement = placement

    # -- the batch_source contract ----------------------------------------

    def __call__(self):
        self._iter_placement = self._placement
        worker_side = self._iter_placement == "worker"
        if hasattr(self._source, "set_packing"):
            self._source.set_packing(self.spec if worker_side else None)
        elif worker_side:
            raise ValueError(
                "placement='worker' needs a source that forwards the "
                "packing spec on its stream requests "
                "(ServiceBatchSource); this source cannot — use "
                "placement='trainer'")
        inner = self._source()
        prefetched = bool(getattr(inner, "prefetched", False))
        # The resume snapshot is consumed by the FIRST iteration of
        # either placement: the worker path carries no trainer-side
        # state to restore (the inner source was built with its slice),
        # but leaving it armed would misapply a stale worker-kind
        # snapshot to a later trainer-placement iteration after a
        # placement flip — desyncing the absolute packed accounting.
        resume, self._resume = self._resume, None
        if worker_side:
            return _PackedIterator(self._passthrough(inner), prefetched)
        packer = StreamPacker(self.spec, placement="trainer")
        self._live_packer = packer
        skip = 0
        if resume is not None and resume.get("placement") == "trainer":
            if resume.get("packer") is not None:
                packer.load_state_dict(resume["packer"])
            skip = int(resume.get("skip", 0))
            self._packed_emitted = int(resume.get("packed_batches", 0))
        # The consumer's batch 0 of THIS iteration sits at this absolute
        # position (past any re-emitted skip batches on a resume).
        self._iter_base = self._packed_emitted + skip
        # Seed the snapshot history at the iteration boundary: a
        # state_dict() before the first batch (or before the generator
        # first runs) must already have an exact position.
        self._history = []
        self._snapshot(0, packer)
        return _PackedIterator(self._pack_local(inner, packer, skip),
                               prefetched)

    def _passthrough(self, inner):
        try:
            for batch in inner:
                self._packed_emitted += 1
                yield batch
        finally:
            close = getattr(inner, "close", None)
            if callable(close):
                close()

    def _pack_local(self, inner, packer, skip):
        consumed = 0
        try:
            for batch in inner:
                if consumed:
                    self._snapshot(consumed, packer)
                consumed += 1
                for packed in packer.add_batch(batch):
                    # _packed_emitted counts ABSOLUTE emission (skipped
                    # re-emissions included) so history boundaries and
                    # resume cuts share one unit.
                    self._packed_emitted += 1
                    if skip > 0:
                        skip -= 1
                        continue
                    yield packed
            self._snapshot(consumed, packer)
            tail = packer.flush()
            if tail is not None:
                self._packed_emitted += 1
                if skip > 0:
                    skip -= 1
                else:
                    yield tail
        finally:
            close = getattr(inner, "close", None)
            if callable(close):
                close()

    def _snapshot(self, consumed, packer):
        # Raw (cheap) per-row-batch snapshots: serialization + crc are
        # deferred to state_dict(), which only pays them for the ONE
        # boundary a checkpoint selects.
        self._history.append(
            (self._packed_emitted, consumed, packer.raw_state()))
        while len(self._history) > self._history_depth:
            self._history.pop(0)

    # -- checkpointing -----------------------------------------------------

    def state_dict(self, yielded_batches=None):
        """The v2 resumable position: inner source position + the
        packer's open-batch state at an exact row-batch boundary.
        ``yielded_batches`` counts PACKED batches the consumer surfaced
        (the loader passes it); the snapshot resolves to the latest
        boundary at or before it and records how many packed batches to
        skip when the resumed packer re-emits them."""
        placement = self._iter_placement
        if placement == "worker":
            return {
                "kind": "packed_v1", "placement": "worker",
                "spec": self.spec.to_dict(),
                "inner": self._source.state_dict(
                    yielded_batches=yielded_batches),
            }
        # ``yielded_batches`` is iteration-relative (what the consumer
        # surfaced from THIS iteration); history boundaries are absolute
        # — translate through the iteration base so checkpoints of
        # resumed sources and later epochs land on the right boundary.
        target = (self._packed_emitted if yielded_batches is None
                  else self._iter_base + int(yielded_batches))
        boundary = None
        for entry in self._history:
            if entry[0] <= target:
                boundary = entry
        if boundary is None:
            raise ValueError(
                f"no packer snapshot at or before packed batch {target} "
                f"(history keeps {self._history_depth}; raise history= "
                f"above the consumer's prefetch depth)")
        emitted, consumed, raw = boundary
        if self._live_packer is None:
            raise ValueError(
                "no live packer to serialize a trainer-placement "
                "snapshot with — iterate before taking a state_dict")
        return {
            "kind": "packed_v1", "placement": "trainer",
            "spec": self.spec.to_dict(),
            "inner": self._source.state_dict(yielded_batches=consumed),
            "packer": self._live_packer.serialize_state(raw),
            "packed_batches": emitted,
            "skip": target - emitted,
        }

    # -- passthrough -------------------------------------------------------

    @property
    def source(self):
        """The wrapped batch source."""
        return self._source

    @property
    def diagnostics(self):
        diag = getattr(self._source, "diagnostics", None)
        out = dict(diag) if isinstance(diag, dict) else {}
        out["packing"] = {"placement": self._iter_placement,
                          "spec": self.spec.to_dict(),
                          "packed_batches": self._packed_emitted}
        return out

    def __getattr__(self, name):
        # Everything else (set_credits, transform, stop hooks, …)
        # delegates to the wrapped source so graph knobs and loader
        # plumbing bind through the wrapper transparently.
        return getattr(self._source, name)
