"""Columnar decode worker: one work item (a row group, or one of its
row-drop partitions) → dict of decoded ``[N, ...]`` arrays (the port's own
copy of ``petastorm_tpu/reader/columnar_worker.py``).

The predicate and ``shuffle_row_drop_partitions`` apply to the encoded
Arrow table before any payload column decodes: the predicate's fields
decode first (vectorized, ``codec.decode_column``), give the keep-mask
(``evaluate_predicate_mask``), and the table is filtered and thinned. Then
every column decodes vectorized into a dense array, so a row group becomes
one dict with no per-row Python objects. ``TransformSpec.func`` takes and
returns that ``{field: [N, ...]}`` dict. Each codec column's decode of the
batch is one ``COLUMNAR_KERNEL_SECONDS`` observation, as in the JAX
worker (predicate fields are not). The batch goes through the cache
under the JAX package's key and is published as an ``(item_key, columns)``
pair; the consumer side records the delivery, in rows, in the reader's
tracker as it hands the batch out.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import pyarrow as pa

from petastorm_tpu_torch import failpoints as _failpoints
from petastorm_tpu_torch.predicates import evaluate_predicate_mask
from petastorm_tpu_torch.reader_impl.delivery_tracker import item_key
from petastorm_tpu_torch.schema.codecs import DataframeColumnCodec
from petastorm_tpu_torch.schema.transform import transform_schema
from petastorm_tpu_torch.telemetry.metrics import COLUMNAR_KERNEL_SECONDS
from petastorm_tpu_torch.utils import column_cells, drop_partition
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class ColumnarDecodeWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        (self._filesystem, self._pieces, self._schema, self._read_schema,
         ngram, self._cache, self._transform_spec) = args
        if ngram is not None:
            raise NotImplementedError("NGram is not supported by make_columnar_reader; "
                                      "use make_reader")

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=(0, 1)):
        piece = self._pieces[piece_index]
        cache_key = (piece.path, piece.row_group, repr(worker_predicate),
                     tuple(sorted(self._read_schema.fields)), shuffle_row_drop_partition,
                     repr(self._transform_spec), "columnar")
        batch = self._cache.get(
            cache_key,
            lambda: self._load_batch(piece, worker_predicate, shuffle_row_drop_partition))
        if batch and len(next(iter(batch.values()))) > 0:
            self.publish_func((item_key(piece_index, shuffle_row_drop_partition[0]), batch))

    def _load_batch(self, piece, worker_predicate, shuffle_row_drop_partition):
        columns = sorted(self._read_schema.fields)
        if worker_predicate is not None:
            predicate_fields = sorted(worker_predicate.get_fields())
            unknown = [f for f in predicate_fields if f not in self._schema.fields]
            if unknown:
                raise ValueError(f"Predicate fields not in schema: {unknown}")
            table = piece.read(self._filesystem,
                               columns=sorted(set(columns) | set(predicate_fields)))
            decoded = {name: self._decode(name, table, self._schema) for name in predicate_fields}
            mask = evaluate_predicate_mask(worker_predicate, decoded, table.num_rows)
            table = table.filter(pa.array(mask)).select(columns)
        else:
            table = piece.read(self._filesystem, columns=columns)
        table = drop_partition(table, shuffle_row_drop_partition)
        # The columnar decode boundary: the decode.columnar failpoint's
        # "fallback" decodes this batch through the codecs' per-row loop,
        # which the vectorized kernels equal.
        fp = _failpoints.ACTIVE
        rowwise = fp is not None and fp.fire("decode.columnar") == "fallback"
        batch = OrderedDict(
            (name, self._decode(name, table, self._read_schema, timed=True, rowwise=rowwise))
            for name in columns)
        if self._transform_spec is None:
            return batch
        if self._transform_spec.func:
            batch = self._transform_spec.func(batch)
        result_schema = transform_schema(self._read_schema, self._transform_spec)
        missing = [c for c in result_schema.fields if c not in batch]
        if missing:
            raise ValueError(f"TransformSpec output is missing declared fields: {missing}")
        return OrderedDict((c, batch[c]) for c in result_schema.fields)

    def _decode(self, name, table, schema, timed=False, rowwise=False):
        # Predicate fields may lie outside the requested schema view.
        field = self._read_schema.fields.get(name) or schema.fields.get(name)
        cells = column_cells(table.column(name))
        if field.codec is None:
            return cells
        if rowwise:
            return DataframeColumnCodec.decode_column(field.codec, field, cells)
        t0 = time.perf_counter()
        column = field.codec.decode_column(field, cells)
        if timed:
            COLUMNAR_KERNEL_SECONDS.observe(time.perf_counter() - t0)
        return column


class ColumnarResultsQueueReader:
    """Consumer side: decoded column dict → namedtuple of column arrays."""

    batched_output = True

    def __init__(self):
        self.delivery_tracker = None
        #: Work-item tag of the last column batch (see the row reader's).
        self.last_item_key = None

    def read_next(self, pool, schema, ngram=None, timeout=None):
        kwargs = {} if timeout is None else {"timeout": timeout}
        key, batch = pool.get_results(**kwargs)
        self.last_item_key = key
        if self.delivery_tracker is not None:
            self.delivery_tracker.record(key, len(next(iter(batch.values()), ())))
        return schema.make_namedtuple(**batch)
