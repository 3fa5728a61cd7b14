"""Collation: reader output → fixed-size numpy batches.

The port's own copy of ``petastorm_tpu/jax_utils/batcher.py``. The
last-batch policy is explicit:

- ``last_batch="drop"`` — drop the final partial batch (default);
- ``last_batch="pad"`` — wrap-pad the final partial batch to full size and
  attach a boolean ``PAD_MASK_KEY`` column (True = real row), so losses can
  be masked;
- ``last_batch="keep"`` — yield the ragged final batch.

Rows arrive as schema namedtuples (``make_reader``), as NGram windows
(``make_reader(schema_fields=NGram(...))``, collated to ``[B, T, ...]`` by
:func:`collate_ngram_rows`) or as column-batch namedtuples of row-group
length (``make_columnar_reader``, re-sliced to the batch size).
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.reader_impl.shuffling_buffer import RandomShufflingBuffer

#: Name of the boolean mask column attached when ``last_batch="pad"``.
PAD_MASK_KEY = "__pad_mask__"

_LAST_BATCH_POLICIES = ("drop", "pad", "keep")


def _stack_column(values):
    """Per-row values → one ``[B, ...]`` array: dense for same-shaped arrays
    and numbers, an object array for strings, Decimals, ragged or null rows
    (the loader keeps those on the host)."""
    first = values[0]
    if isinstance(first, np.ndarray) and first.dtype != object:
        if all(isinstance(v, np.ndarray) and v.shape == first.shape
               and v.dtype == first.dtype for v in values):
            return np.stack(values)
    elif isinstance(first, (int, float, bool, np.generic)) and \
            all(v is not None for v in values):
        return np.asarray(values)
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def collate_rows(rows, fields=None):
    """Collate a list of namedtuple/dict rows into ``{field: [B, ...]}``."""
    if not rows:
        return {}
    first = rows[0]
    if isinstance(first, dict):
        names = fields or list(first)
        get = lambda row, name: row[name]  # noqa: E731
    else:
        names = fields or list(first._fields)
        get = getattr
    return {name: _stack_column([get(row, name) for row in rows]) for name in names}


def collate_ngram_rows(rows):
    """Collate NGram windows ``{offset: namedtuple}`` into ``[B, T, ...]``
    arrays, the sorted offsets forming the time axis. A field present at
    every timestep becomes ``{name: [B, T, ...]}``; one present at only some
    keeps its per-step identity as ``{f"{name}@{offset}": [B, ...]}``."""
    if not rows:
        return {}
    offsets = sorted(rows[0])
    fields_at = {off: set(rows[0][off]._fields) for off in offsets}
    common = set.intersection(*fields_at.values()) if offsets else set()
    out = {}
    for name in sorted(common):
        out[name] = _stack_column([
            np.stack([np.asarray(getattr(row[off], name)) for off in offsets])
            for row in rows])
    for off in offsets:
        for name in sorted(fields_at[off] - common):
            out[f"{name}@{off}"] = _stack_column(
                [np.asarray(getattr(row[off], name)) for row in rows])
    return out


def _pad_batch(batch, batch_size):
    """Wrap-pad every column to ``batch_size`` rows and attach PAD_MASK_KEY."""
    short = next(iter(batch.values())).shape[0] if batch else 0
    reps = -(-batch_size // max(short, 1))
    padded = {name: np.concatenate([col] * reps)[:batch_size]
              for name, col in batch.items()}
    mask = np.zeros(batch_size, dtype=bool)
    mask[:short] = True
    padded[PAD_MASK_KEY] = mask
    return padded


def batch_iterator(reader, batch_size, last_batch="drop", max_batches=None,
                   shuffle_buffer_size=0, shuffle_seed=None):
    """Yield ``{field: [batch_size, ...]}`` dicts from a reader.

    ``max_batches`` truncates the stream. ``shuffle_buffer_size`` > 0
    decorrelates the rows of a row group through a
    :class:`RandomShufflingBuffer` seeded by ``shuffle_seed`` (row readers
    only).
    """
    if last_batch not in _LAST_BATCH_POLICIES:
        raise ValueError(
            f"last_batch must be one of {_LAST_BATCH_POLICIES}, got {last_batch!r}")
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    if getattr(reader, "batched_output", False):
        if shuffle_buffer_size:
            raise ValueError(
                "shuffle_buffer_size requires a row reader (make_reader); "
                "column-batch readers shuffle at row-group granularity via "
                "shuffle_row_groups")
        source = _rebatch_column_batches(reader, batch_size)
    else:
        source = _batch_rows(reader, batch_size, shuffle_buffer_size, shuffle_seed)
    produced = 0
    # The limit is checked before the pull, so no batch is decoded past it.
    while max_batches is None or produced < max_batches:
        try:
            batch, full = next(source)
        except StopIteration:
            return
        if not full:
            if last_batch == "drop":
                return
            if last_batch == "pad":
                batch = _pad_batch(batch, batch_size)
        produced += 1
        yield batch


def _batch_rows(reader, batch_size, shuffle_buffer_size=0, shuffle_seed=None):
    """Row reader → (collated batch dict, is_full) pairs."""
    collate = collate_ngram_rows if getattr(reader, "ngram", None) is not None else collate_rows
    if shuffle_buffer_size:
        sbuf = RandomShufflingBuffer(
            shuffle_buffer_size, min_after_retrieve=shuffle_buffer_size // 2,
            extra_capacity=max(shuffle_buffer_size, 1000), random_seed=shuffle_seed)

        def rows():
            for row in reader:
                sbuf.add_many([row])
                while not sbuf.can_add() and sbuf.can_retrieve():
                    yield sbuf.retrieve()
            sbuf.finish()
            while sbuf.can_retrieve():
                yield sbuf.retrieve()

        source = rows()
    else:
        source = reader
    buf = []
    for row in source:
        buf.append(row)
        if len(buf) == batch_size:
            yield collate(buf), True
            buf = []
    if buf:
        yield collate(buf), False


def _rebatch_column_batches(reader, batch_size):
    """Column-batch reader → fixed-size (batch dict, is_full) pairs: record
    batches are sliced and stitched into exact ``batch_size`` chunks, the
    remainders carried across input batches."""
    pending = {}
    pending_rows = 0
    names = None

    def emit(n):
        nonlocal pending, pending_rows
        out, rest = {}, {}
        for name in names:
            joined = (pending[name][0] if len(pending[name]) == 1
                      else np.concatenate(pending[name]))
            out[name] = joined[:n]
            rest[name] = [joined[n:]] if joined.shape[0] > n else []
        pending = rest
        pending_rows -= n
        return out

    for col_batch in reader:
        batch_dict = col_batch._asdict() if hasattr(col_batch, "_asdict") else dict(col_batch)
        if names is None:
            names = list(batch_dict)
            pending = {name: [] for name in names}
        rows_in = len(next(iter(batch_dict.values())))
        for name in names:
            pending[name].append(np.asarray(batch_dict[name]))
        pending_rows += rows_in
        while pending_rows >= batch_size:
            yield emit(batch_size), True
    if pending_rows:
        yield emit(pending_rows), False
