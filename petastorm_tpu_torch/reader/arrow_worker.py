"""Batch worker for plain Parquet: one work item (a row group, or one of
its row-drop partitions) → one ``pa.Table``, no per-row decode (the port's
own copy of ``petastorm_tpu/reader/arrow_worker.py``).

The ``make_batch_reader`` path: columns stay columnar end to end, and the
consumer receives namedtuples of numpy *column batches*, one per work
item, which the loader's batcher re-slices into training batches.

- The predicate's mask is computed on numpy columns of the Arrow table
  (``evaluate_predicate_mask``), as the JAX worker computes it on the
  columns of a pandas frame: an integer column with nulls becomes float
  with NaN in both, a date column ``datetime.date`` objects, so null rows
  give the same mask. The table is then filtered in Arrow and keeps its
  Arrow types (the JAX worker's pandas round trip turns an integer column
  that held nulls into float64 even where no null survives).
- ``shuffle_row_drop_partitions`` keeps rows ``this::num_partitions``.
- ``TransformSpec.func`` takes and returns a pandas DataFrame, its
  contract; only that path imports pandas.
- The table goes through the cache (Arrow IPC entries) under the JAX
  package's key.

Each published table carries its work-item tag in its schema metadata,
and the consumer side records the delivery in the reader's tracker as it
hands the batch out.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.predicates import evaluate_predicate_mask
from petastorm_tpu_torch.reader_impl.delivery_tracker import (
    item_key,
    read_table_tag,
    tag_table,
)
from petastorm_tpu_torch.schema.transform import transform_schema
from petastorm_tpu_torch.utils import drop_partition
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class ArrowReaderWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        (self._filesystem, self._pieces, self._schema, self._read_schema,
         ngram, self._cache, self._transform_spec) = args
        if ngram is not None:
            raise NotImplementedError("NGram is not supported by make_batch_reader")

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=(0, 1)):
        piece = self._pieces[piece_index]
        # Cached tables are post-transform, so the transform is in the key.
        cache_key = (piece.path, piece.row_group, repr(worker_predicate),
                     tuple(sorted(self._read_schema.fields)), shuffle_row_drop_partition,
                     repr(self._transform_spec))
        table = self._cache.get(
            cache_key,
            lambda: self._load_table(piece, worker_predicate, shuffle_row_drop_partition))
        if table.num_rows > 0:
            self.publish_func(tag_table(
                table, item_key(piece_index, shuffle_row_drop_partition[0])))

    def _load_table(self, piece, worker_predicate, shuffle_row_drop_partition):
        columns = sorted(self._read_schema.fields)
        if worker_predicate is not None:
            predicate_fields = sorted(worker_predicate.get_fields())
            table = piece.read(self._filesystem,
                               columns=sorted(set(columns) | set(predicate_fields)))
            values = {f: _frame_like_numpy(table.column(f)) for f in predicate_fields}
            mask = evaluate_predicate_mask(worker_predicate, values, table.num_rows)
            table = table.filter(pa.array(mask)).select(columns)
        else:
            table = piece.read(self._filesystem, columns=columns)
        table = drop_partition(table, shuffle_row_drop_partition)
        if self._transform_spec is not None:
            table = self._transform(table)
        return table

    def _transform(self, table):
        try:
            import pandas  # noqa: F401 - the TransformSpec contract hands over a DataFrame
        except ImportError as exc:
            raise ImportError("make_batch_reader's transform_spec hands its function a "
                              "pandas DataFrame, and pandas is not installed") from exc
        frame = table.to_pandas()
        if self._transform_spec.func:
            frame = self._transform_spec.func(frame)
        result_schema = transform_schema(self._read_schema, self._transform_spec)
        missing = [c for c in result_schema.fields if c not in frame.columns]
        if missing:
            raise ValueError(f"TransformSpec output is missing declared fields: {missing}")
        return pa.Table.from_pandas(frame[list(result_schema.fields)], preserve_index=False)


def _frame_like_numpy(column):
    """An Arrow column as the numpy column a pandas frame of it gives:
    ``to_numpy`` (integers with nulls as float with NaN, like pandas),
    except dates, which pandas hands over as ``datetime.date`` objects."""
    if pa.types.is_date(column.type):
        return np.array(column.to_pylist(), dtype=object)
    return column.to_numpy(zero_copy_only=False)


class ArrowResultsQueueReader:
    """Consumer side: tagged ``pa.Table`` → namedtuple of numpy column
    arrays; the delivery is recorded in ``delivery_tracker`` (set by the
    reader) as the batch is handed out."""

    batched_output = True

    def __init__(self):
        self.delivery_tracker = None
        #: Work-item tag (``"piece:drop_partition"``) of the last output:
        #: the streaming piece engine attributes outputs to pieces by it.
        self.last_item_key = None

    def read_next(self, pool, schema, ngram=None, timeout=None):
        kwargs = {} if timeout is None else {"timeout": timeout}
        table = pool.get_results(**kwargs)  # raises EmptyResultError at the end
        key = read_table_tag(table)
        self.last_item_key = key
        if self.delivery_tracker is not None and key is not None:
            self.delivery_tracker.record(key, table.num_rows)
        return table_to_batch(table, schema)


def table_to_batch(table, schema):
    """An arrow table → the reader's batch namedtuple (columns of
    ``schema`` the table lacks are None)."""
    return schema.make_namedtuple(**{
        name: _column_to_numpy(table.column(name), field)
        for name, field in schema.fields.items() if name in table.column_names})


def _column_to_numpy(column, field):
    values = column.to_numpy(zero_copy_only=False)
    if field.shape and values.dtype == object:
        # Codec-less list columns: stacked into [batch, *shape] when the
        # rows agree, else left as an object array of ragged rows.
        try:
            return np.stack([np.asarray(v, dtype=np.dtype(field.numpy_dtype))
                             for v in values])
        except (ValueError, TypeError):
            return values
    return values
