"""Row decode worker: one row group → a list of decoded row dicts, or of
NGram windows (the port's own copy of
``petastorm_tpu/reader/py_dict_worker.py``, without predicates, caches,
delivery tracking and row-drop partitions).

Per ventilated row group the worker reads the columns of the read schema,
decodes them a column at a time (``decode_table``: the codecs'
``decode_column``, one imdecode / np.load pass per column, as the columnar
worker does), splits the columns into row dicts, applies the TransformSpec,
and publishes the rows; the consumer side turns them into namedtuples. With
an NGram the rows become ``{offset: row dict}`` windows first
(``NGram.form_ngram``) and the TransformSpec runs on each timestep's row.
"""

from __future__ import annotations

from collections import deque

from petastorm_tpu_torch.schema.transform import transform_schema
from petastorm_tpu_torch.utils import decode_table
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class PyDictReaderWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        (self._filesystem, self._pieces, self._read_schema, self._transform_spec,
         self._ngram) = args
        # The consumer sees the post-transform schema; decode uses the read one.
        self._result_schema = (transform_schema(self._read_schema, self._transform_spec)
                               if self._transform_spec else self._read_schema)

    def process(self, piece_index):
        columns = (self._ngram.get_field_names_at_all_timesteps() if self._ngram
                   else sorted(self._read_schema.fields))
        table = self._pieces[piece_index].read(self._filesystem, columns=columns)
        rows = decode_table(table, self._read_schema)
        if self._ngram is not None:
            rows = self._ngram.form_ngram(rows, self._read_schema)
            if self._transform_spec and self._transform_spec.func:
                rows = [{offset: self._transform_spec.func(dict(ts_row))
                         for offset, ts_row in window.items()} for window in rows]
        elif self._transform_spec:
            rows = [self._apply_transform(row) for row in rows]
        if rows:
            self.publish_func(rows)

    def _apply_transform(self, row):
        if self._transform_spec.func:
            row = self._transform_spec.func(dict(row))
        return {name: row[name] for name in self._result_schema.fields if name in row}


class PyDictResultsQueueReader:
    """Consumer side: published row lists → one namedtuple row at a time
    (or one ``{offset: namedtuple}`` window, with an NGram)."""

    batched_output = False

    def __init__(self):
        self._buffer = deque()

    def read_next(self, pool, schema, ngram=None):
        while not self._buffer:
            rows = pool.get_results()
            self._buffer.extend(schema.make_namedtuples(rows) if ngram is None else
                                (ngram.make_namedtuple(schema, row) for row in rows))
        return self._buffer.popleft()
