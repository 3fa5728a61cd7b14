"""``make_columnar_reader`` and ``Reader``.

The port's own copy of the parts of ``petastorm_tpu/reader/reader.py`` the
main path uses: a columnar reader over a petastorm-format dataset with
``num_epochs``, seeded ``shuffle_row_groups``, ``cur_shard``/
``shard_count`` row-group sharding and thread or dummy decode pools. The
planning arithmetic is the JAX package's — canonical row-group order, the
optional ``shard_seed`` pre-shuffle, round-robin ``pieces[s::count]`` — so
the same arguments give both packages the same row groups in the same
order. (Field selection, predicates, filters, caches, NGram windows,
transforms, the row and plain-Parquet readers, resume and the process pool
are not ported yet.)
"""

from __future__ import annotations

import random
import warnings

from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormMetadataError
from petastorm_tpu_torch.etl.metadata import get_schema, load_row_groups
from petastorm_tpu_torch.fs_utils import FilesystemResolver
from petastorm_tpu_torch.reader.columnar_worker import (
    ColumnarDecodeWorker,
    ColumnarResultsQueueReader,
)
from petastorm_tpu_torch.workers_pool import EmptyResultError
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator


def make_columnar_reader(dataset_url, reader_pool_type="thread",
                         workers_count=10, shuffle_row_groups=True,
                         num_epochs=1, cur_shard=None, shard_count=None,
                         shard_seed=None):
    """Columnar reader for petastorm-format datasets: yields namedtuples of
    decoded ``[N, ...]`` column arrays, one per row group
    (``batched_output=True``).

    ``shard_seed`` seeds both the shard pre-shuffle and the per-epoch
    row-group shuffle (as in the JAX package); ``None`` shuffles unseeded.
    """
    resolver = FilesystemResolver(dataset_url)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    try:
        stored_schema = get_schema(fs, path)
    except PetastormMetadataError as exc:
        raise RuntimeError(
            f"Dataset at {dataset_url!r} is not a petastorm dataset this "
            f"package can read: {exc}") from exc
    if reader_pool_type == "thread":
        pool = ThreadPool(workers_count)
    elif reader_pool_type == "dummy":
        pool = DummyPool()
    else:
        raise ValueError(f"Unknown reader_pool_type {reader_pool_type!r} "
                         "(this package has 'thread' and 'dummy')")
    return Reader(fs, path, schema=stored_schema, reader_pool=pool, shuffle_row_groups=shuffle_row_groups,
                  num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, shard_seed=shard_seed)


def split_pieces_for_shards(pieces, shard_count, shard_seed=None):
    """Partition pieces into ``shard_count`` shards: the optional
    ``shard_seed`` pre-shuffle, then round-robin ``pieces[s::count]``."""
    if shard_count is None:
        return [list(pieces)]
    if shard_seed is not None:
        pieces = list(pieces)
        random.Random(shard_seed).shuffle(pieces)
    return [pieces[s::shard_count] for s in range(shard_count)]


class Reader:
    """Iterator/context manager over column batches of a dataset."""

    def __init__(self, filesystem, dataset_path, schema, reader_pool, shuffle_row_groups=True, num_epochs=1,
                 cur_shard=None, shard_count=None, shard_seed=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError(f"cur_shard {cur_shard} out of range "
                             f"[0, {shard_count})")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError("num_epochs must be a positive integer or None")
        self.num_epochs = num_epochs
        self.last_row_consumed = False
        self.stopped = False
        self.schema = schema
        self._results_queue_reader = ColumnarResultsQueueReader()
        self._workers_pool = reader_pool

        pieces = load_row_groups(filesystem, dataset_path)
        if not pieces:
            raise NoDataAvailableError("The dataset has no row groups")
        shards = split_pieces_for_shards(pieces, shard_count, shard_seed)
        self.cur_shard, self.shard_count = cur_shard, shard_count
        pieces = shards[0] if shard_count is None else shards[cur_shard]
        if not pieces:
            warnings.warn(
                f"Shard {cur_shard}/{shard_count} received zero row groups; "
                "this reader yields nothing", UserWarning, stacklevel=3)
        self._pieces = pieces

        items = [{"piece_index": i} for i in range(len(pieces))]
        self._ventilator = ConcurrentVentilator(
            reader_pool.ventilate, items,
            iterations=num_epochs if items else 1,
            randomize_item_order=shuffle_row_groups,
            random_seed=shard_seed,
            max_ventilation_queue_size=min(len(items), 1000) or 1)
        reader_pool.start(ColumnarDecodeWorker,
                          (filesystem, pieces, schema),
                          ventilator=self._ventilator)

    @property
    def batched_output(self):
        return self._results_queue_reader.batched_output

    def __iter__(self):
        return self

    def __next__(self):
        if self.stopped:
            raise StopIteration
        try:
            return self._results_queue_reader.read_next(self._workers_pool,
                                                        self.schema)
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration from None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()

    def stop(self):
        self._workers_pool.stop()
        self.stopped = True

    def join(self):
        self._workers_pool.join()
