"""Row decode worker: one work item (a row group, or one of its row-drop
partitions) → a list of decoded row dicts, or of NGram windows (the port's
own copy of ``petastorm_tpu/reader/py_dict_worker.py``).

Per ventilated item the worker asks the cache for the item's rows under a
key of (file, row group, predicate repr, fields, drop partition, transform
repr), the JAX package's key; on a miss it loads them:

- without a predicate it reads the columns of the read schema; with one,
  it reads the predicate's columns first, computes a keep-mask, and reads
  the other columns only to filter them to the surviving rows (two-phase
  read, below);
- ``shuffle_row_drop_partitions`` keeps rows ``this::num_partitions`` of
  what is left;
- the columns decode a column at a time (``decode_table``: the codecs'
  ``decode_column``), then split into row dicts; with an NGram the rows
  become ``{offset: row dict}`` windows, and the TransformSpec runs on each
  row (each timestep's row, for windows).

The rows are published as an ``(item_key, rows)`` pair; the consumer side
turns them into namedtuples and records the delivery in the reader's
tracker when the last of them is handed out.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.reader_impl.delivery_tracker import FusedPiecePayload, item_key
from petastorm_tpu_torch.schema.transform import transform_schema
from petastorm_tpu_torch.utils import decode_table, drop_partition
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class PyDictReaderWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        (self._filesystem, self._pieces, self._schema, self._read_schema,
         self._ngram, self._cache, self._transform_spec) = args
        # The consumer sees the post-transform schema; decode uses the read one.
        self._result_schema = (transform_schema(self._read_schema, self._transform_spec)
                               if self._transform_spec else self._read_schema)

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=(0, 1)):
        piece = self._pieces[piece_index]
        rows = self._cache.get(
            self._cache_key(piece, worker_predicate, shuffle_row_drop_partition),
            lambda: self._load_rows(piece, worker_predicate, shuffle_row_drop_partition))
        if rows:
            self.publish_func((item_key(piece_index, shuffle_row_drop_partition[0]), rows))

    def _cache_key(self, piece, worker_predicate, shuffle_row_drop_partition):
        # Cached rows are post-transform, so the transform is in the key.
        return (piece.path, piece.row_group, repr(worker_predicate),
                tuple(sorted(self._read_schema.fields)), shuffle_row_drop_partition,
                repr(self._transform_spec))

    def _needed_columns(self):
        if self._ngram is not None:
            return self._ngram.get_field_names_at_all_timesteps()
        return sorted(self._read_schema.fields)

    def _load_rows(self, piece, worker_predicate, shuffle_row_drop_partition):
        if worker_predicate is not None:
            table = self._read_with_predicate(piece, worker_predicate)
        else:
            table = piece.read(self._filesystem, columns=self._needed_columns())
        table = drop_partition(table, shuffle_row_drop_partition)
        rows = decode_table(table, self._read_schema)
        if self._ngram is not None:
            rows = self._ngram.form_ngram(rows, self._read_schema)
            if self._transform_spec and self._transform_spec.func:
                rows = [{offset: self._transform_spec.func(dict(ts_row))
                         for offset, ts_row in window.items()} for window in rows]
            return rows
        if self._transform_spec:
            rows = [self._apply_transform(row) for row in rows]
        return rows

    def _read_with_predicate(self, piece, predicate):
        """Two-phase read: the predicate's columns, a keep-mask over them,
        then the other needed columns, both filtered to the survivors and
        joined into one table for the column-wise decode.

        The mask is computed on the stored columns (``pa_mask``, else
        ``do_include_vectorized``) when every predicate field is a numeric
        or boolean scalar stored as itself, where stored and decoded values
        compare alike; otherwise ``do_include`` runs on each decoded row."""
        predicate_fields = sorted(predicate.get_fields())
        unknown = [f for f in predicate_fields if f not in self._schema.fields]
        if unknown:
            raise ValueError(f"Predicate fields not in schema: {unknown}")
        predicate_view = self._schema.create_schema_view(
            [self._schema.fields[f] for f in predicate_fields])
        predicate_table = piece.read(self._filesystem, columns=predicate_fields)
        mask = _stored_column_mask(predicate, predicate_view, predicate_table)
        if mask is None:
            mask = np.fromiter((bool(predicate.do_include(row))
                                for row in decode_table(predicate_table, predicate_view)),
                               dtype=bool, count=predicate_table.num_rows)
        keep = pa.array(mask)
        needed = self._needed_columns()
        other = [c for c in needed if c not in predicate_fields]
        survivors = predicate_table.filter(keep)
        data = {name: survivors.column(name) for name in predicate_fields if name in needed}
        if other:
            other_table = piece.read(self._filesystem, columns=other).filter(keep)
            data.update((name, other_table.column(name)) for name in other)
        return pa.table(data)

    def _apply_transform(self, row):
        if self._transform_spec.func:
            row = self._transform_spec.func(dict(row))
        return {name: row[name] for name in self._result_schema.fields if name in row}

    @property
    def result_schema(self):
        return self._result_schema


def _stored_column_mask(predicate, predicate_view, table):
    """The keep-mask computed on stored columns, or None for the per-row
    path: only scalar fields (no codec, or ``ScalarCodec``) of numeric or
    boolean dtype qualify. Decimals (stored as strings), datetimes and
    strings take the per-row path."""
    for field in predicate_view.fields.values():
        codec_name = type(field.codec).__name__ if field.codec is not None else None
        if field.shape not in ((), None) or codec_name not in (None, "ScalarCodec"):
            return None
        try:
            kind = np.dtype(field.numpy_dtype).kind
        except TypeError:  # Decimal and the like have no numpy dtype
            return None
        if kind not in "biuf":
            return None
    pa_mask = getattr(predicate, "pa_mask", None)
    if pa_mask is not None:
        return np.asarray(pa_mask(table), dtype=bool)
    columns = {name: table.column(name).to_numpy(zero_copy_only=False)
               for name in table.column_names}
    mask = predicate.do_include_vectorized(columns, table.num_rows)
    return np.asarray(mask, dtype=bool) if mask is not None else None


class PyDictResultsQueueReader:
    """Consumer side: published row lists → one namedtuple row at a time
    (or one ``{offset: namedtuple}`` window, with an NGram). A payload's
    delivery is recorded in ``delivery_tracker`` (set by the reader), in
    rows (windows, with an NGram), when its last row is handed out: rows
    still buffered at checkpoint time are re-read on resume."""

    batched_output = False

    def __init__(self):
        self._buffer = deque()
        self._pending_item = None  # (item_key, num_rows) awaiting its last row
        self.delivery_tracker = None
        #: Work-item tag of the payload the last row came from: one
        #: payload's rows drain before the buffer refills, so the tag holds
        #: for each of them (the streaming piece engine reads it).
        self.last_item_key = None

    def read_next(self, pool, schema, ngram=None, timeout=None):
        kwargs = {} if timeout is None else {"timeout": timeout}
        while not self._buffer:
            key, rows = pool.get_results(**kwargs)
            if isinstance(rows, FusedPiecePayload):
                # A fused pool task already collated and serialized the
                # whole piece: handed through whole, its delivery (in rows)
                # recorded now, since nothing of it is buffered here.
                self.last_item_key = key
                self._pending_item = None
                if self.delivery_tracker is not None:
                    self.delivery_tracker.record(key, rows.rows)
                return rows
            self._pending_item = (key, len(rows))
            self.last_item_key = key
            self._buffer.extend(schema.make_namedtuples(rows) if ngram is None else
                                (ngram.make_namedtuple(schema, row) for row in rows))
        row = self._buffer.popleft()
        if not self._buffer and self._pending_item is not None:
            if self.delivery_tracker is not None:
                self.delivery_tracker.record(*self._pending_item)
            self._pending_item = None
        return row
