"""Sequence packing: ragged rows → dense ``[B, T]`` batches + segment ids.

The port's own copy of ``petastorm_tpu/jax_utils/packing.py`` (first-fit
packing bit-identical to the JAX package's, :func:`count_packed_batches`
and :func:`unpack`) and its packed delivery path,
:func:`make_packed_torch_dataloader`.

Conventions of the packed layout:

- ``segment_ids[b, t]``: index of the sequence occupying slot position ``t``
  of batch row ``b``; **-1 marks padding**;
- ``positions[b, t]``: offset within the sequence (0 at each start and on
  padding) — feed position embeddings from this, not from ``t``.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

PACK_SEGMENT_KEY = "__segment_ids__"
PACK_POSITION_KEY = "__positions__"


def packed_valid_mask(segment_ids):
    """Boolean [B, T] mask of real (non-padding) token positions."""
    return np.asarray(segment_ids) >= 0


def pack_ragged(rows, slot_len, slots, keys=None):
    """Pack an iterable of ragged row dicts into dense batches (generator).

    Every packed field's leading axis is the sequence length. ``keys``
    defaults to every array field of the first row; other fields are dropped
    with a one-time warning. Sequences go first-fit into the open batch's
    rows; a sequence longer than ``slot_len`` raises, an empty one is
    skipped; the final partial batch is emitted. Yields
    ``{key: [slots, slot_len, ...]}`` plus ``PACK_SEGMENT_KEY`` /
    ``PACK_POSITION_KEY`` int32 arrays.
    """
    state = None
    warned_dropped = False

    def fresh(proto):
        nonlocal keys, warned_dropped
        if keys is None:
            keys = [k for k, val in proto.items() if val.ndim >= 1]
            if not keys:
                raise ValueError("no packable (array) fields in row")
        else:
            unknown = [k for k in keys if k not in proto]
            if unknown:
                raise ValueError(
                    f"keys={unknown} not present in row (row has "
                    f"{sorted(proto)}) — packing an absent field is a "
                    f"configuration error, not a drop")
        dropped = sorted(k for k in proto if k not in keys)
        if dropped and not warned_dropped:
            warned_dropped = True
            logger.warning("pack_ragged: dropping non-packed field(s) %s",
                           dropped)
        return {"cols": {key: np.zeros((slots, slot_len) + proto[key].shape[1:],
                                       proto[key].dtype) for key in keys},
                "seg": np.full((slots, slot_len), -1, np.int32),
                "pos": np.zeros((slots, slot_len), np.int32),
                "used": np.zeros(slots, np.int64),
                "count": np.zeros(slots, np.int32)}

    def emit(st):
        out = dict(st["cols"])
        out[PACK_SEGMENT_KEY] = st["seg"]
        out[PACK_POSITION_KEY] = st["pos"]
        return out

    for row in rows:
        row = {k: np.asarray(v) for k, v in row.items()}
        if state is None:
            state = fresh(row)
        length = row[keys[0]].shape[0]
        for key in keys:
            if row[key].shape[0] != length:
                raise ValueError(
                    f"field {key!r} length {row[key].shape[0]} != "
                    f"{keys[0]!r} length {length} (packed fields must share "
                    "the sequence axis)")
        if length > slot_len:
            raise ValueError(
                f"sequence of length {length} does not fit slot_len "
                f"{slot_len}; split long sequences upstream")
        if length == 0:
            continue
        fit = np.nonzero(state["used"] + length <= slot_len)[0]
        if fit.size == 0:
            yield emit(state)
            state = fresh(row)
            fit = np.array([0])
        b = int(fit[0])
        start = int(state["used"][b])
        for key in keys:
            state["cols"][key][b, start:start + length] = row[key]
        state["seg"][b, start:start + length] = state["count"][b]
        state["pos"][b, start:start + length] = np.arange(length)
        state["used"][b] += length
        state["count"][b] += 1

    if state is not None and state["count"].sum() > 0:
        yield emit(state)


def iter_ragged_rows(reader, sequence_fields, length_field=None):
    """A reader's output as ragged row dicts for :func:`pack_ragged`: column
    batches are split back into rows, and each packed field is trimmed to the
    row's ``length_field`` (padded-on-disk layouts)."""
    batched = bool(getattr(reader, "batched_output", False))
    for item in reader:
        cols = {f: np.asarray(getattr(item, f)) for f in sequence_fields}
        if batched:
            lens = (np.asarray(getattr(item, length_field))
                    if length_field else None)
            for i in range(cols[sequence_fields[0]].shape[0]):
                cut = int(lens[i]) if lens is not None else None
                yield {f: cols[f][i][:cut] for f in sequence_fields}
        else:
            cut = int(getattr(item, length_field)) if length_field else None
            yield {f: cols[f][:cut] for f in sequence_fields}


def count_packed_batches(reader, slot_len, slots, sequence_fields, length_field=None):
    """The number of batches :func:`pack_ragged` emits for ``reader``,
    counted by draining (and closing) it: packed counts depend on the
    length distribution, so count on a separate reader built with the
    delivering reader's arguments, and agree the minimum across ranks
    before passing it as ``max_batches``. Raises ValueError for a reader
    with ``num_epochs=None``, which would never end."""
    if getattr(reader, "num_epochs", 1) is None:
        raise ValueError(
            "count_packed_batches would never terminate on an infinite "
            "reader (num_epochs=None): construct the counting reader with "
            "num_epochs=1 and scale the agreed count by your epoch budget")
    n = 0
    with reader:
        for _ in pack_ragged(iter_ragged_rows(reader, sequence_fields, length_field),
                             slot_len=slot_len, slots=slots):
            n += 1
    return n


def unpack(packed, key):
    """The sequences of ``packed[key]`` in packing order (batch row 0's
    segments first): the inverse of :func:`pack_ragged`. Takes numpy
    arrays or CPU tensors."""
    seg = np.asarray(packed[PACK_SEGMENT_KEY])
    values = np.asarray(packed[key])
    out = []
    for b in range(seg.shape[0]):
        for s in range(seg[b].max() + 1):
            mask = seg[b] == s
            if mask.any():
                out.append(values[b, mask])
    return out


def make_packed_torch_dataloader(reader, slot_len, slots, sequence_fields,
                                 length_field=None, max_batches=None,
                                 device="cuda", **loader_kwargs):
    """Packed delivery path: reader → ragged rows → :func:`pack_ragged` →
    :class:`~petastorm_tpu_torch.torch_utils.loader.TorchDataLoader`.

    Yields ``{field: [slots, slot_len]}`` tensors on ``device`` (``"cuda"``
    unless the caller asks for ``"cpu"``) plus ``PACK_SEGMENT_KEY`` /
    ``PACK_POSITION_KEY`` — feed the segment ids to ``flash_attention``.
    """
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    def source():
        return pack_ragged(
            iter_ragged_rows(reader, sequence_fields, length_field),
            slot_len=slot_len, slots=slots)

    return TorchDataLoader(reader, source, max_batches=max_batches,
                           device=device, **loader_kwargs)
