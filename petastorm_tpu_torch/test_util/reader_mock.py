"""A schema-driven fake reader for testing consumers without Parquet (the
port's own copy of ``petastorm_tpu/test_util/reader_mock.py``);
:func:`~petastorm_tpu_torch.torch_utils.loader.make_torch_dataloader` can
wrap it."""

from __future__ import annotations


class ReaderMock:
    """Yields ``schema.make_namedtuple(**row_generator(i))`` for
    ``i = 0, 1, ...``: forever, or ``num_rows`` rows."""

    def __init__(self, schema, row_generator, num_rows=None, batched_output=False):
        self.schema = schema
        self.ngram = None
        self.batched_output = batched_output
        self.last_row_consumed = False
        self._row_generator = row_generator
        self._num_rows = num_rows
        self._served = 0
        self.stopped = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._num_rows is not None and self._served >= self._num_rows:
            self.last_row_consumed = True
            raise StopIteration
        row = self._row_generator(self._served)
        self._served += 1
        return self.schema.make_namedtuple(**row)

    def next(self):
        return self.__next__()

    def reset(self):
        self._served = 0
        self.last_row_consumed = False

    def stop(self):
        self.stopped = True

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
