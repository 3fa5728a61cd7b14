"""Columnar decode worker: one row group → dict of decoded ``[N, ...]``
arrays (the port's own copy of ``petastorm_tpu/reader/columnar_worker.py``,
without predicates, caches and transforms).

Codec columns decode vectorized (``codec.decode_column``) into dense column
arrays, so a row group becomes one dict with no per-row Python objects,
published as an ``(item_key, columns)`` pair; the consumer side records the
delivery, in rows, in the reader's tracker as it hands the batch out.
"""

from __future__ import annotations

from collections import OrderedDict

from petastorm_tpu_torch.reader_impl.delivery_tracker import item_key
from petastorm_tpu_torch.utils import column_cells
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class ColumnarDecodeWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        # The columnar reader takes no TransformSpec: args[3] is None.
        self._filesystem, self._pieces, self._read_schema = args[:3]

    def process(self, piece_index):
        piece = self._pieces[piece_index]
        columns = sorted(self._read_schema.fields)
        table = piece.read(self._filesystem, columns=columns)
        if table.num_rows == 0:
            return
        batch = OrderedDict()
        for name in columns:
            field = self._read_schema.fields[name]
            cells = column_cells(table.column(name))
            batch[name] = (field.codec.decode_column(field, cells)
                           if field.codec is not None else cells)
        self.publish_func((item_key(piece_index, 0), batch))


class ColumnarResultsQueueReader:
    """Consumer side: decoded column dict → namedtuple of column arrays."""

    batched_output = True

    def __init__(self):
        self.delivery_tracker = None

    def read_next(self, pool, schema, ngram=None):
        key, batch = pool.get_results()
        if self.delivery_tracker is not None:
            self.delivery_tracker.record(key, len(next(iter(batch.values()), ())))
        return schema.make_namedtuple(**batch)
