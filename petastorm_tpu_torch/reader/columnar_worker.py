"""Columnar decode worker: one row group → dict of decoded ``[N, ...]``
arrays (the port's own copy of ``petastorm_tpu/reader/columnar_worker.py``,
without predicates, caches and transforms).

Codec columns decode vectorized (``codec.decode_column``) into dense column
arrays, so a row group becomes one dict with no per-row Python objects.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class ColumnarDecodeWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._filesystem, self._pieces, self._read_schema = args

    def process(self, piece_index):
        piece = self._pieces[piece_index]
        columns = sorted(self._read_schema.fields)
        table = piece.read(self._filesystem, columns=columns)
        if table.num_rows == 0:
            return
        batch = OrderedDict()
        for name in columns:
            field = self._read_schema.fields[name]
            cells = _column_cells(table.column(name))
            batch[name] = (field.codec.decode_column(field, cells)
                           if field.codec is not None else cells)
        self.publish_func(batch)


def _column_cells(column):
    """An arrow column as numpy cells; a column with nulls becomes an object
    array holding None (``to_numpy`` would turn int-with-null into NaN)."""
    if column.null_count:
        out = np.empty(len(column), dtype=object)
        for i, value in enumerate(column.to_pylist()):
            out[i] = value
        return out
    return column.to_numpy(zero_copy_only=False)


class ColumnarResultsQueueReader:
    """Consumer side: decoded column dict → namedtuple of column arrays."""

    batched_output = True

    def read_next(self, pool, schema):
        return schema.make_namedtuple(**pool.get_results())
