"""``make_reader``, ``make_columnar_reader``, ``make_batch_reader`` and
``Reader``.

The port's own copy of the parts of ``petastorm_tpu/reader/reader.py`` the
port uses:

- the row reader (decoded namedtuple rows, with ``schema_fields`` and a
  ``TransformSpec``; an :class:`~petastorm_tpu_torch.ngram.NGram` as
  ``schema_fields`` yields ``{offset: namedtuple}`` windows) and the
  columnar reader (one namedtuple of ``[N, ...]`` column arrays per row
  group) over a petastorm-format dataset;
- the batch reader over a plain Parquet store (one namedtuple of numpy
  column batches per row group, the schema inferred from Arrow), with
  ``filters`` that prune row groups by their Parquet statistics before
  anything is read;
- for all three: ``num_epochs``, seeded ``shuffle_row_groups``,
  ``cur_shard``/``shard_count`` row-group sharding, thread or dummy decode
  pools, and resumable iteration (``Reader.state_dict()`` /
  ``resume_state=``).

The planning arithmetic is the JAX package's — canonical row-group order
(or the ``filters``' fragment scan), the optional ``shard_seed``
pre-shuffle, round-robin ``pieces[s::count]``, the ventilator's seeded
per-epoch shuffle — so the same arguments give both packages the same row
groups in the same order, and a state written by either resumes the other.
(Row-level predicates, ``rowgroup_selector``, caches, row-drop partitions,
the batch reader's pandas ``TransformSpec``, several dataset URLs and the
process pool are not ported yet.)
"""

from __future__ import annotations

import random
import warnings

from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormMetadataError
from petastorm_tpu_torch.etl.metadata import (
    RowGroupPiece,
    get_schema,
    load_row_groups,
    piece_row_counts,
)
from petastorm_tpu_torch.fs_utils import FilesystemResolver
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader.arrow_worker import ArrowReaderWorker, ArrowResultsQueueReader
from petastorm_tpu_torch.reader.columnar_worker import (
    ColumnarDecodeWorker,
    ColumnarResultsQueueReader,
)
from petastorm_tpu_torch.reader.py_dict_worker import (
    PyDictReaderWorker,
    PyDictResultsQueueReader,
)
from petastorm_tpu_torch.reader_impl.delivery_tracker import DeliveryTracker, item_key
from petastorm_tpu_torch.schema.transform import transform_schema
from petastorm_tpu_torch.schema.unischema import Unischema
from petastorm_tpu_torch.workers_pool import EmptyResultError
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

#: ``make_batch_reader`` arguments of the JAX package that the port does not
#: take, with their JAX defaults: the default is accepted (it asks for
#: nothing), anything else raises NotImplementedError naming the argument.
UNPORTED_BATCH_READER_ARGS = {
    "results_queue_size": 50, "shuffle_row_drop_partitions": 1, "predicate": None,
    "rowgroup_selector": None, "cache_type": "null", "cache_location": None,
    "cache_size_limit": None, "cache_row_size_estimate": None,
    "cache_extra_settings": None, "hdfs_driver": "libhdfs", "transform_spec": None,
    "storage_options": None, "zmq_copy_buffers": True, "filesystem": None,
    "fast_gcs_listing": True, "piece_indices": None, "dynamic_ventilation": False,
}


def make_reader(dataset_url, schema_fields=None, reader_pool_type="thread",
                workers_count=10, shuffle_row_groups=True, num_epochs=1,
                cur_shard=None, shard_count=None, shard_seed=None,
                transform_spec=None, resume_state=None):
    """Row reader for petastorm-format datasets: yields one namedtuple of
    decoded fields per row (``batched_output=False``).

    ``schema_fields``: ``None`` (every field), a list of field names,
    full-match name regexes or :class:`UnischemaField` s, or an
    :class:`~petastorm_tpu_torch.ngram.NGram`: the reader then yields one
    ``{offset: namedtuple}`` window per item (``reader.ngram``).
    ``transform_spec`` runs on each decoded row dict (each timestep's, for
    windows) in the workers; ``reader.schema`` is the post-transform
    schema. ``shard_seed`` seeds both the shard pre-shuffle
    and the per-epoch row-group shuffle; ``None`` shuffles unseeded.
    ``resume_state``: a :meth:`Reader.state_dict` of a reader built with
    the same arguments, whose remaining row groups this one delivers.
    """
    fs, path, stored_schema = _open_dataset(dataset_url)
    return Reader(fs, path, schema=stored_schema, reader_pool=_make_pool(reader_pool_type, workers_count),
                  worker_class=PyDictReaderWorker,
                  results_queue_reader=PyDictResultsQueueReader(),
                  schema_fields=schema_fields, transform_spec=transform_spec,
                  shuffle_row_groups=shuffle_row_groups, num_epochs=num_epochs,
                  cur_shard=cur_shard, shard_count=shard_count, shard_seed=shard_seed,
                  resume_state=resume_state)


def make_columnar_reader(dataset_url, reader_pool_type="thread",
                         workers_count=10, shuffle_row_groups=True,
                         num_epochs=1, cur_shard=None, shard_count=None,
                         shard_seed=None, schema_fields=None, resume_state=None):
    """Columnar reader for petastorm-format datasets: yields namedtuples of
    decoded ``[N, ...]`` column arrays, one per row group
    (``batched_output=True``).

    ``shard_seed`` seeds both the shard pre-shuffle and the per-epoch
    row-group shuffle (as in the JAX package); ``None`` shuffles unseeded.
    ``schema_fields`` and ``resume_state`` as in :func:`make_reader`, but
    NGram windows are row-wise and not supported here.
    """
    if isinstance(schema_fields, NGram):
        raise ValueError("NGram is not supported by make_columnar_reader; "
                         "use make_reader")
    fs, path, stored_schema = _open_dataset(dataset_url)
    return Reader(fs, path, schema=stored_schema, reader_pool=_make_pool(reader_pool_type, workers_count),
                  worker_class=ColumnarDecodeWorker,
                  results_queue_reader=ColumnarResultsQueueReader(),
                  schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups,
                  num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, shard_seed=shard_seed,
                  resume_state=resume_state)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type="thread",
                      workers_count=10, shuffle_row_groups=True, num_epochs=1,
                      cur_shard=None, shard_count=None, shard_seed=None, filters=None,
                      resume_state=None, **unported):
    """Batch reader for **plain Parquet** stores (no petastorm metadata
    needed): yields namedtuples of numpy column batches, one per row group
    (``batched_output=True``), under a codec-less schema inferred from the
    store's Arrow schema (columns of unsupported types left out).

    ``schema_fields``: column names or full-match regexes. ``filters``:
    DNF triples ``[(column, op, value), ...]`` (ANDed), a list of such lists
    (ORed), or a ``pyarrow.dataset.Expression``; row groups whose Parquet
    statistics rule the filter out are never read. ``resume_state`` as in
    :func:`make_reader` (the filters are part of its fingerprint). Other
    arguments of the JAX package's ``make_batch_reader`` raise
    NotImplementedError unless given at their default.
    """
    for name, value in unported.items():
        if name not in UNPORTED_BATCH_READER_ARGS:
            raise TypeError(f"make_batch_reader() got an unexpected keyword argument {name!r}")
        if value != UNPORTED_BATCH_READER_ARGS[name]:
            raise NotImplementedError(f"make_batch_reader({name}=...) is not ported yet")
    if isinstance(dataset_url_or_urls, (list, tuple)):
        raise NotImplementedError("make_batch_reader over several dataset URLs is not ported yet")
    if isinstance(schema_fields, NGram):
        raise ValueError("NGram is not supported by make_batch_reader")
    import pyarrow.dataset as pads

    resolver = FilesystemResolver(dataset_url_or_urls)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    inferred = Unischema.from_arrow_schema(
        pads.dataset(path, filesystem=fs, format="parquet"), omit_unsupported_fields=True)
    return Reader(fs, path, schema=inferred, reader_pool=_make_pool(reader_pool_type, workers_count),
                  worker_class=ArrowReaderWorker,
                  results_queue_reader=ArrowResultsQueueReader(),
                  schema_fields=schema_fields, shuffle_row_groups=shuffle_row_groups,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  shard_seed=shard_seed, filters=filters, resume_state=resume_state)


def _open_dataset(dataset_url):
    """``(filesystem, path, stored Unischema)`` of a petastorm dataset."""
    resolver = FilesystemResolver(dataset_url)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    try:
        return fs, path, get_schema(fs, path)
    except PetastormMetadataError as exc:
        raise RuntimeError(
            f"Dataset at {dataset_url!r} is not a petastorm dataset this "
            f"package can read ({exc}); use make_batch_reader for plain "
            "Parquet stores") from exc


def _make_pool(reader_pool_type, workers_count):
    if reader_pool_type == "thread":
        return ThreadPool(workers_count)
    if reader_pool_type == "dummy":
        return DummyPool()
    raise ValueError(f"Unknown reader_pool_type {reader_pool_type!r} "
                     "(this package has 'thread' and 'dummy')")


def split_pieces_for_shards(pieces, shard_count, shard_seed=None):
    """Partition pieces into ``shard_count`` shards: the optional
    ``shard_seed`` pre-shuffle, then round-robin ``pieces[s::count]``."""
    if shard_count is None:
        return [list(pieces)]
    if shard_seed is not None:
        pieces = list(pieces)
        random.Random(shard_seed).shuffle(pieces)
    return [pieces[s::shard_count] for s in range(shard_count)]


def enumerate_row_group_pieces(filesystem, dataset_path, filters=None):
    """The row-group pieces a reader plans with: the canonical order
    (:func:`load_row_groups`) without ``filters``; with them, the fragment
    scan's (files by path, then row-group index) of the row groups whose
    Parquet statistics may satisfy the filter."""
    if filters is None:
        return load_row_groups(filesystem, dataset_path)
    import pyarrow.dataset as pads

    expression = _filters_to_expression(filters)
    dataset = pads.dataset(dataset_path, filesystem=filesystem, format="parquet")
    return [RowGroupPiece(fragment.path, rg.row_groups[0].id, rg.row_groups[0].num_rows)
            for fragment in sorted(dataset.get_fragments(filter=expression),
                                   key=lambda f: f.path)
            for rg in fragment.split_by_row_group(expression)]


_FILTER_OPS = {
    "=": lambda f, v: f == v, "==": lambda f, v: f == v,
    "!=": lambda f, v: f != v, "<": lambda f, v: f < v,
    ">": lambda f, v: f > v, "<=": lambda f, v: f <= v,
    ">=": lambda f, v: f >= v,
    "in": lambda f, v: f.isin(list(v)),
    "not in": lambda f, v: ~f.isin(list(v)),
}


def _filters_to_expression(filters):
    """DNF filters (or a ``pyarrow.dataset.Expression``) → an Expression:
    ``[(col, op, value), ...]`` is a conjunction, ``[[...], [...]]`` the
    disjunction of conjunctions."""
    import pyarrow.compute as pc
    import pyarrow.dataset as pads

    if isinstance(filters, pads.Expression):
        return filters

    def conjunction(triples):
        expr = None
        for col, op, value in triples:
            if op not in _FILTER_OPS:
                raise ValueError(f"Unsupported filter op {op!r}")
            term = _FILTER_OPS[op](pc.field(col), value)
            expr = term if expr is None else expr & term
        if expr is None:
            raise ValueError("Empty filter conjunction")
        return expr

    if all(isinstance(f, (list, tuple)) and len(f) == 3 and isinstance(f[1], str)
           for f in filters):
        return conjunction(filters)
    result = None
    for clause in filters:
        term = conjunction(clause)
        result = term if result is None else result | term
    return result


class Reader:
    """Iterator/context manager over the rows or column batches of a
    dataset, decoded by ``worker_class`` in ``reader_pool``."""

    def __init__(self, filesystem, dataset_path, schema, reader_pool, worker_class,
                 results_queue_reader, schema_fields=None, transform_spec=None,
                 shuffle_row_groups=True, num_epochs=1, cur_shard=None,
                 shard_count=None, shard_seed=None, filters=None, resume_state=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError(f"cur_shard {cur_shard} out of range "
                             f"[0, {shard_count})")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError("num_epochs must be a positive integer or None")
        self._filesystem = filesystem
        self._dataset_path = dataset_path
        self.num_epochs = num_epochs
        self.last_row_consumed = False
        self.stopped = False
        self.ngram = schema_fields if isinstance(schema_fields, NGram) else None
        if self.ngram is not None:
            self.ngram.resolve_regex_field_names(schema)
            read_schema = self.ngram.get_schema_view(schema)
        else:
            read_schema = schema.resolve_schema_view(schema_fields)
        self._transform_spec = transform_spec
        self.schema = (transform_schema(read_schema, transform_spec)
                       if transform_spec else read_schema)
        self._results_queue_reader = results_queue_reader
        self._workers_pool = reader_pool

        pieces = enumerate_row_group_pieces(filesystem, dataset_path, filters)
        if not pieces:
            raise NoDataAvailableError("No row groups left after filters — nothing to read")
        # Every shard's pieces are kept, so equal-step coordination
        # (torch_utils.sharding.derive_equal_step_max_batches) computes the
        # smallest shard's batch count locally on each rank.
        self._shard_piece_lists = split_pieces_for_shards(pieces, shard_count, shard_seed)
        self._shard_row_counts = None
        self.cur_shard, self.shard_count = cur_shard, shard_count
        self._shard_seed = shard_seed
        pieces = self._shard_piece_lists[0 if shard_count is None else cur_shard]
        if not pieces:
            warnings.warn(
                f"Shard {cur_shard}/{shard_count} received zero row groups; "
                "this reader yields nothing", UserWarning, stacklevel=3)
        self._pieces = pieces

        # Resumable iteration: payloads arrive tagged with their item key,
        # the tracker counts deliveries as they are consumed, and a resumed
        # reader ventilates each item only for its remaining epochs.
        items = [{"piece_index": i} for i in range(len(pieces))]
        self._num_items = len(items)
        # Filters change which pieces the positional item keys denote, so
        # they are part of the resume fingerprint (with the JAX package's
        # rowgroup_selector slot, None here).
        self._planning_repr = repr((filters, None))
        self._resume_state = resume_state
        iterations, per_item_iterations, prior_counts = num_epochs, None, None
        if resume_state is not None:
            self._validate_resume_state(resume_state)
            delivered = resume_state["delivered"]
            per_item_iterations = [max(0, num_epochs - delivered.get(item_key(i, 0), 0))
                                   for i in range(len(items))]
            prior_counts = dict(delivered)
            iterations = max(per_item_iterations, default=0)
            if iterations == 0:
                # Everything was delivered: a reader that yields nothing more.
                items, per_item_iterations = [], None
        self._delivery_tracker = DeliveryTracker(preload=prior_counts)
        results_queue_reader.delivery_tracker = self._delivery_tracker

        self._ventilator = ConcurrentVentilator(
            reader_pool.ventilate, items,
            iterations=iterations if items else 1,
            randomize_item_order=shuffle_row_groups,
            random_seed=shard_seed,
            max_ventilation_queue_size=min(len(items), 1000) or 1,
            per_item_iterations=per_item_iterations)
        self._diagnostics = {
            "rowgroups_total": len(pieces),
            "items_per_epoch": len(items),
            "workers_count": getattr(reader_pool, "workers_count", 1),
        }
        reader_pool.start(worker_class, (filesystem, pieces, read_schema, transform_spec,
                                         self.ngram),
                          ventilator=self._ventilator)

    @property
    def rows_per_epoch(self):
        """Rows this reader yields per epoch (its shard's row groups)."""
        return sum(piece_row_counts(self._filesystem, self._pieces).values())

    @property
    def shard_row_counts(self):
        """Row count of every shard, not just this reader's: the input of
        equal-step coordination. Footers are read once, on first use."""
        if self._shard_row_counts is None:
            counts = piece_row_counts(self._filesystem,
                                      [p for shard in self._shard_piece_lists for p in shard])
            self._shard_row_counts = [sum(counts[(p.path, p.row_group)] for p in shard)
                                      for shard in self._shard_piece_lists]
        return self._shard_row_counts

    @property
    def diagnostics(self):
        """Planning facts under the JAX reader's key names:
        ``rowgroups_total`` (this shard's row groups), ``items_per_epoch``
        (work items ventilated per epoch; 0 for a resumed reader with
        nothing left) and ``workers_count``."""
        return dict(self._diagnostics)

    def state_dict(self, yielded_rows=None):
        """Snapshot of iteration progress, the JAX package's dict key for
        key (``version`` 1): pass it back as ``resume_state=`` to the same
        factory with the same arguments. At-least-once at row-group
        granularity: fully delivered row groups are never re-read; the one
        being consumed is. Safe to call from another thread.

        ``yielded_rows``: for a consumer that buffers past the reader (the
        loader), the rows it has handed on; the newest deliveries beyond
        them are left out, so their rows are re-read on resume.
        """
        delivered = (self._delivery_tracker.counts() if yielded_rows is None
                     else self._delivery_tracker.counts_rolled_back_to(yielded_rows))
        return {
            "version": 1,
            "dataset_path": str(self._dataset_path),
            "num_items": self._num_items,
            "num_epochs": self.num_epochs,
            "shard": [self.cur_shard, self.shard_count, self._shard_seed],
            "drop_partitions": 1,
            "planning": self._planning_repr,
            "delivered": delivered,
        }

    def _validate_resume_state(self, state):
        if state.get("version") != 1:
            raise ValueError(f"Unsupported resume_state version {state.get('version')!r}")
        if self.num_epochs is None:
            raise ValueError(
                "resume_state requires finite num_epochs (an infinite stream "
                "has no resumable endpoint — just restart it)")
        expected = {
            "dataset_path": str(self._dataset_path),
            "num_items": self._num_items,
            "num_epochs": self.num_epochs,
            "shard": [self.cur_shard, self.shard_count, self._shard_seed],
            "drop_partitions": 1,
            "planning": self._planning_repr,
        }
        for key, want in expected.items():
            got = state.get(key)
            got = list(got) if isinstance(got, tuple) else got
            if got != want:
                raise ValueError(
                    f"resume_state mismatch on {key!r}: checkpoint has {got!r}, "
                    f"this reader has {want!r} — resume requires the same "
                    "dataset and reader configuration")

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
                                                        self.schema, self.ngram)
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
