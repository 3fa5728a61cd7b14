"""Batch worker for plain Parquet: one row group → one ``pa.Table``, no
per-row decode (the port's own copy of
``petastorm_tpu/reader/arrow_worker.py``).

The ``make_batch_reader`` path: columns stay columnar end to end, and the
consumer receives namedtuples of numpy *column batches*, one per row group,
which the loader's batcher re-slices into training batches. Each published
table carries its work-item tag in its schema metadata, and the consumer
side records the delivery in the reader's tracker as it hands the batch out.
(The worker predicate, row-drop partitions, caches and the pandas
``TransformSpec`` are not ported yet; the reader refuses them.)
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.reader_impl.delivery_tracker import (
    item_key,
    read_table_tag,
    tag_table,
)
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class ArrowReaderWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._filesystem, self._pieces, self._read_schema, transform_spec, ngram = args
        if ngram is not None:
            raise NotImplementedError("NGram is not supported by make_batch_reader")
        if transform_spec is not None:
            raise NotImplementedError(
                "make_batch_reader's pandas TransformSpec is not ported yet")

    def process(self, piece_index):
        table = self._pieces[piece_index].read(
            self._filesystem, columns=sorted(self._read_schema.fields))
        if table.num_rows > 0:
            self.publish_func(tag_table(table, item_key(piece_index, 0)))


class ArrowResultsQueueReader:
    """Consumer side: tagged ``pa.Table`` → namedtuple of numpy column
    arrays; the delivery is recorded in ``delivery_tracker`` (set by the
    reader) as the batch is handed out."""

    batched_output = True

    def __init__(self):
        self.delivery_tracker = None

    def read_next(self, pool, schema, ngram=None):
        table = pool.get_results()  # raises EmptyResultError at the end
        key = read_table_tag(table)
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
