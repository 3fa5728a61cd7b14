"""``make_reader``, ``make_columnar_reader``, ``make_batch_reader`` and
``Reader``.

The port's own copy of ``petastorm_tpu/reader/reader.py``:

- the row reader (decoded namedtuple rows, with ``schema_fields`` and a
  ``TransformSpec``; an :class:`~petastorm_tpu_torch.ngram.NGram` as
  ``schema_fields`` yields ``{offset: namedtuple}`` windows) and the
  columnar reader (one namedtuple of ``[N, ...]`` column arrays per work
  item) over a petastorm-format dataset;
- the batch reader over plain Parquet (one namedtuple of numpy column
  batches per work item, the schema inferred from Arrow), over one store
  or several Parquet file URLs, with a pandas ``TransformSpec``;
- for all three: ``filters`` that prune row groups by their Parquet
  statistics before anything is read; a ``rowgroup_selector`` over the
  store's row-group indexes, matched to the filtered pieces by (file, row
  group); a row ``predicate`` the workers evaluate before decoding the
  other columns; ``shuffle_row_drop_partitions``, which splits each row
  group into that many work items; the local-disk cache; ``num_epochs``,
  seeded ``shuffle_row_groups``, ``cur_shard``/``shard_count`` row-group
  sharding, thread, process or dummy decode pools (the process pool ships
  the row and columnar readers' payloads with pickle and the batch
  reader's with Arrow IPC, as the JAX package does), resumable iteration
  (``Reader.state_dict()`` / ``resume_state=``), ``Reader.reset()`` and the
  live ``Reader.diagnostics``, mirrored in the registry's ``READER_*``
  families.

The planning arithmetic is the JAX package's — canonical row-group order
(or the ``filters``' fragment scan), the selector, the optional
``shard_seed`` pre-shuffle, round-robin ``pieces[s::count]``, one work item
per (piece, drop partition), the ventilator's seeded per-epoch shuffle —
and so are the planning fingerprint ``repr((filters, rowgroup_selector))``
and the item keys ``item_key(piece_index, drop_partition)``, so the same
arguments give both packages the same work items in the same order, and a
state written by either resumes the other.
:meth:`Reader.resize_workers` resizes a thread pool while it runs.
"""

from __future__ import annotations

import random
import warnings

from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.errors import NoDataAvailableError, PetastormMetadataError
from petastorm_tpu_torch.etl.metadata import (
    RowGroupPiece,
    get_schema,
    load_row_groups,
    piece_row_counts,
)
from petastorm_tpu_torch.fs_utils import (
    FilesystemResolver,
    get_filesystem_and_path_or_paths,
)
from petastorm_tpu_torch.local_disk_arrow_table_cache import LocalDiskArrowTableCache
from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.predicates import PredicateBase
from petastorm_tpu_torch.reader.arrow_worker import ArrowReaderWorker, ArrowResultsQueueReader
from petastorm_tpu_torch.reader.columnar_worker import (
    ColumnarDecodeWorker,
    ColumnarResultsQueueReader,
)
from petastorm_tpu_torch.reader.py_dict_worker import (
    PyDictReaderWorker,
    PyDictResultsQueueReader,
)
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.delivery_tracker import DeliveryTracker, item_key
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.schema.transform import transform_schema
from petastorm_tpu_torch.schema.unischema import Unischema
from petastorm_tpu_torch.telemetry.metrics import READER_READERS, READER_ROWGROUPS_PLANNED
from petastorm_tpu_torch.workers_pool import EmptyResultError
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator, DynamicVentilator


def make_reader(dataset_url, schema_fields=None, reader_pool_type="thread",
                workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                shuffle_row_drop_partitions=1, predicate=None, rowgroup_selector=None,
                num_epochs=1, cur_shard=None, shard_count=None, shard_seed=None,
                cache_type="null", cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None, cache_extra_settings=None,
                hdfs_driver="libhdfs", transform_spec=None, filters=None, reader_engine=None,
                resume_state=None, zmq_copy_buffers=True, storage_options=None,
                filesystem=None, fast_gcs_listing=True, piece_indices=None,
                dynamic_ventilation=False):
    """Row reader for petastorm-format datasets: yields one namedtuple of
    decoded fields per row (``batched_output=False``).

    ``schema_fields``: ``None`` (every field), a list of field names,
    full-match name regexes or :class:`UnischemaField` s, or an
    :class:`~petastorm_tpu_torch.ngram.NGram`: the reader then yields one
    ``{offset: namedtuple}`` window per item (``reader.ngram``).
    ``transform_spec`` runs on each decoded row dict (each timestep's, for
    windows) in the workers; ``reader.schema`` is the post-transform
    schema. ``predicate``: a :class:`~petastorm_tpu_torch.predicates.
    PredicateBase`; its fields are read and tested first, the rest only for
    the rows it keeps. ``rowgroup_selector``: a selector of
    :mod:`petastorm_tpu_torch.selectors` over the store's row-group
    indexes. ``shuffle_row_drop_partitions``: each row group becomes that
    many work items, partition ``i`` holding rows ``i::n``.
    ``cache_type="local-disk"`` (with ``cache_location`` and
    ``cache_size_limit`` in bytes) caches each work item's decoded rows.
    ``shard_seed`` seeds both the shard pre-shuffle and the per-epoch
    row-group shuffle; ``None`` shuffles unseeded. ``reader_pool_type``:
    ``"thread"``, ``"process"`` (decode in fresh interpreters that see no
    card; ``zmq_copy_buffers`` sends the arrays' memory as frames of their
    own instead of one pickle) or ``"dummy"``. ``resume_state``: a
    :meth:`Reader.state_dict` of a reader built with the same arguments,
    whose remaining work items this one delivers. ``reader_engine``: only
    the deprecated ``"reader_v1"``, which changes nothing.
    ``storage_options`` (fsspec keyword arguments), ``filesystem`` (a
    pyarrow or fsspec filesystem) and ``fast_gcs_listing`` select the
    filesystem (:class:`~petastorm_tpu_torch.fs_utils.FilesystemResolver`);
    ``hdfs://`` connects through ``pyarrow.fs.HadoopFileSystem`` with
    namenode failover, and ``hdfs_driver`` is taken and unused, as in the
    JAX package.
    ``piece_indices``: an explicit plan, indices into the row-group pieces
    left after ``filters`` and the selector (sorted, deduplicated and
    range-checked, applied before sharding); the data service's workers
    read their assigned pieces through it. ``dynamic_ventilation=True``: no
    planned epochs; pieces are fed one at a time with
    :meth:`Reader.submit_piece` (the service's streaming piece engine),
    which needs ``shuffle_row_groups=False``, one drop partition and no
    ``resume_state``.
    """
    if reader_engine is not None:
        if reader_engine != "reader_v1":
            raise ValueError(f"reader_engine {reader_engine!r} is not supported; the only "
                             "legacy value is 'reader_v1' (deprecated, no effect)")
        warnings.warn("reader_engine is deprecated and has no effect; for a faster "
                      "columnar path use make_columnar_reader", DeprecationWarning,
                      stacklevel=2)
    fs, path, stored_schema = _open_dataset(dataset_url, storage_options, filesystem,
                                            fast_gcs_listing, hdfs_driver)
    return Reader(fs, path, schema=stored_schema,
                  reader_pool=_make_pool(reader_pool_type, workers_count, results_queue_size,
                                         PickleSerializer(), zmq_copy_buffers),
                  worker_class=PyDictReaderWorker,
                  results_queue_reader=PyDictResultsQueueReader(),
                  schema_fields=schema_fields, transform_spec=transform_spec,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  shard_seed=shard_seed, filters=filters,
                  cache=_make_cache(cache_type, cache_location, cache_size_limit,
                                    cache_row_size_estimate, cache_extra_settings),
                  resume_state=resume_state, piece_indices=piece_indices,
                  dynamic_ventilation=dynamic_ventilation)


def make_columnar_reader(dataset_url, schema_fields=None, reader_pool_type="thread",
                         workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                         shuffle_row_drop_partitions=1, predicate=None,
                         rowgroup_selector=None, num_epochs=1, cur_shard=None,
                         shard_count=None, shard_seed=None, cache_type="null",
                         cache_location=None, cache_size_limit=None,
                         cache_row_size_estimate=None, cache_extra_settings=None,
                         hdfs_driver="libhdfs", transform_spec=None, filters=None,
                         resume_state=None,
                         zmq_copy_buffers=True, storage_options=None, filesystem=None,
                         fast_gcs_listing=True, piece_indices=None,
                         dynamic_ventilation=False):
    """Columnar reader for petastorm-format datasets: yields namedtuples of
    decoded ``[N, ...]`` column arrays, one per work item
    (``batched_output=True``).

    The arguments are :func:`make_reader`'s, but NGram windows are
    row-wise and not supported here, and ``transform_spec.func`` takes and
    returns the decoded ``{field: [N, ...]}`` dict.
    """
    if isinstance(schema_fields, NGram):
        raise ValueError("NGram is not supported by make_columnar_reader; "
                         "use make_reader")
    fs, path, stored_schema = _open_dataset(dataset_url, storage_options, filesystem,
                                            fast_gcs_listing, hdfs_driver)
    return Reader(fs, path, schema=stored_schema,
                  reader_pool=_make_pool(reader_pool_type, workers_count, results_queue_size,
                                         PickleSerializer(), zmq_copy_buffers),
                  worker_class=ColumnarDecodeWorker,
                  results_queue_reader=ColumnarResultsQueueReader(),
                  schema_fields=schema_fields, transform_spec=transform_spec,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  shard_seed=shard_seed, filters=filters,
                  cache=_make_cache(cache_type, cache_location, cache_size_limit,
                                    cache_row_size_estimate, cache_extra_settings),
                  resume_state=resume_state, piece_indices=piece_indices,
                  dynamic_ventilation=dynamic_ventilation)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type="thread",
                      workers_count=10, results_queue_size=50, shuffle_row_groups=True,
                      shuffle_row_drop_partitions=1, predicate=None, rowgroup_selector=None,
                      num_epochs=1, cur_shard=None, shard_count=None, shard_seed=None,
                      cache_type="null", cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, cache_extra_settings=None,
                      hdfs_driver="libhdfs", transform_spec=None, filters=None,
                      resume_state=None,
                      zmq_copy_buffers=True, storage_options=None, filesystem=None,
                      fast_gcs_listing=True, piece_indices=None,
                      dynamic_ventilation=False):
    """Batch reader for **plain Parquet** stores (no petastorm metadata
    needed): yields namedtuples of numpy column batches, one per work item
    (``batched_output=True``), under a codec-less schema inferred from the
    store's Arrow schema (columns of unsupported types left out).

    ``dataset_url_or_urls``: one store's URL, or a list of Parquet file
    URLs read as one dataset. ``schema_fields``: column names or full-match
    regexes. ``filters``: DNF triples ``[(column, op, value), ...]``
    (ANDed), a list of such lists (ORed), or a ``pyarrow.dataset.
    Expression``; row groups whose Parquet statistics rule the filter out
    are never read. ``transform_spec.func`` takes and returns a pandas
    DataFrame (only this path needs pandas). The local-disk cache stores
    Arrow IPC, and a process pool ships the tables as Arrow IPC. The other
    arguments are :func:`make_reader`'s.
    """
    if isinstance(schema_fields, NGram):
        raise ValueError("NGram is not supported by make_batch_reader")
    import pyarrow.dataset as pads

    fs, path = get_filesystem_and_path_or_paths(
        dataset_url_or_urls, hdfs_driver=hdfs_driver, storage_options=storage_options,
        filesystem=filesystem,
        fast_gcs_listing=fast_gcs_listing)
    if isinstance(path, list) and len(path) == 1:
        path = path[0]
    inferred = Unischema.from_arrow_schema(
        pads.dataset(path, filesystem=fs, format="parquet"), omit_unsupported_fields=True)
    return Reader(fs, path, schema=inferred,
                  reader_pool=_make_pool(reader_pool_type, workers_count, results_queue_size,
                                         ArrowTableSerializer(), zmq_copy_buffers),
                  worker_class=ArrowReaderWorker,
                  results_queue_reader=ArrowResultsQueueReader(),
                  schema_fields=schema_fields, transform_spec=transform_spec,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  shard_seed=shard_seed, filters=filters,
                  cache=_make_cache(cache_type, cache_location, cache_size_limit,
                                    cache_row_size_estimate, cache_extra_settings,
                                    arrow_cache=True),
                  resume_state=resume_state, piece_indices=piece_indices,
                  dynamic_ventilation=dynamic_ventilation)


def _open_dataset(dataset_url, storage_options=None, filesystem=None, fast_gcs_listing=False,
                  hdfs_driver="libhdfs"):
    """``(filesystem, path, stored Unischema)`` of a petastorm dataset."""
    resolver = FilesystemResolver(dataset_url, hdfs_driver=hdfs_driver,
                                  storage_options=storage_options,
                                  filesystem=filesystem, fast_gcs_listing=fast_gcs_listing)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    try:
        return fs, path, get_schema(fs, path)
    except PetastormMetadataError as exc:
        raise RuntimeError(
            f"Dataset at {dataset_url!r} is not a petastorm dataset this "
            f"package can read ({exc}); use make_batch_reader for plain "
            "Parquet stores") from exc


def _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                cache_extra_settings, arrow_cache=False):
    if cache_type in (None, "null", "none"):
        return NullCache()
    if cache_type == "local-disk":
        if not cache_location or not cache_size_limit:
            raise ValueError("cache_type='local-disk' requires cache_location and "
                             "cache_size_limit")
        cls = LocalDiskArrowTableCache if arrow_cache else LocalDiskCache
        return cls(cache_location, cache_size_limit, cache_row_size_estimate,
                   **(cache_extra_settings or {}))
    raise ValueError(f"Unknown cache_type {cache_type!r}")


def _make_pool(reader_pool_type, workers_count, results_queue_size, serializer,
               zmq_copy_buffers):
    if reader_pool_type == "thread":
        return ThreadPool(workers_count, results_queue_size=results_queue_size)
    if reader_pool_type == "process":
        return ProcessPool(workers_count, serializer=serializer,
                           zmq_copy_buffers=zmq_copy_buffers,
                           results_queue_size=results_queue_size)
    if reader_pool_type == "dummy":
        return DummyPool()
    raise ValueError(f"Unknown reader_pool_type {reader_pool_type!r} "
                     "(one of 'thread', 'process', 'dummy')")


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
    """The row-group pieces a reader plans with: for one store without
    ``filters``, the canonical order (:func:`load_row_groups`); otherwise
    the fragment scan's (files by path, then row-group index), with
    ``filters``, of the row groups whose Parquet statistics may satisfy
    them. ``dataset_path`` may be a list of Parquet file paths."""
    if filters is None and not isinstance(dataset_path, list):
        return load_row_groups(filesystem, dataset_path)
    import pyarrow.dataset as pads

    expression = _filters_to_expression(filters) if filters is not None else None
    dataset = pads.dataset(dataset_path, filesystem=filesystem, format="parquet")
    return [RowGroupPiece(fragment.path, rg.row_groups[0].id, rg.row_groups[0].num_rows)
            for fragment in sorted(dataset.get_fragments(filter=expression),
                                   key=lambda f: f.path)
            for rg in (fragment.split_by_row_group(expression) if expression is not None
                       else fragment.split_by_row_group())]


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

    def __init__(self, pyarrow_filesystem, dataset_path, schema, reader_pool, worker_class,
                 results_queue_reader, schema_fields=None, transform_spec=None,
                 shuffle_row_groups=True, shuffle_row_drop_partitions=1, predicate=None,
                 rowgroup_selector=None, num_epochs=1, cur_shard=None, shard_count=None,
                 shard_seed=None, filters=None, cache=None, resume_state=None,
                 piece_indices=None, dynamic_ventilation=False):
        if predicate is not None and not isinstance(predicate, PredicateBase):
            raise ValueError("predicate must be an instance of PredicateBase")
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError(f"cur_shard {cur_shard} out of range "
                             f"[0, {shard_count})")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError("num_epochs must be a positive integer or None")
        self._filesystem = filesystem = pyarrow_filesystem
        self._dataset_path = dataset_path
        self._predicate = predicate
        self.num_epochs = num_epochs
        self.last_row_consumed = False
        self.stopped = False
        self.ngram = schema_fields if isinstance(schema_fields, NGram) else None
        if self.ngram is not None:
            self.ngram.resolve_regex_field_names(schema)
            read_schema = self.ngram.get_schema_view(schema)
            if not self.ngram.timestamp_overlap and shuffle_row_drop_partitions > 1:
                raise NotImplementedError(
                    "shuffle_row_drop_partitions with non-overlapping NGram windows "
                    "is not supported")
        else:
            read_schema = schema.resolve_schema_view(schema_fields)
        self._transform_spec = transform_spec
        self.schema = (transform_schema(read_schema, transform_spec)
                       if transform_spec else read_schema)
        self._results_queue_reader = results_queue_reader
        self._workers_pool = reader_pool

        pieces = enumerate_row_group_pieces(filesystem, dataset_path, filters)
        if rowgroup_selector is not None:
            # Without filters, one store's pieces are the canonical list.
            pieces = self._apply_selector(pieces, rowgroup_selector,
                                          pieces if filters is None else None)
        if piece_indices is not None:
            # An explicit split plan (the data service's dispatcher hands
            # these out): indices into the enumeration after filters and
            # the selector, applied before sharding.
            piece_indices = sorted(set(int(i) for i in piece_indices))
            out_of_range = [i for i in piece_indices if not 0 <= i < len(pieces)]
            if out_of_range:
                raise ValueError(
                    f"piece_indices {out_of_range} out of range for the {len(pieces)} "
                    "row-group pieces this planning config enumerates")
            pieces = [pieces[i] for i in piece_indices]
        if not pieces:
            raise NoDataAvailableError(
                "No row groups left after filters/selector — nothing to read")
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

        # One work item per (piece, drop partition), in the JAX package's
        # order. Payloads arrive tagged with their item key, the tracker
        # counts deliveries as they are consumed, and a resumed reader
        # ventilates each item only for its remaining epochs.
        items = [{"piece_index": piece_index, "worker_predicate": predicate,
                  "shuffle_row_drop_partition": (drop_partition, shuffle_row_drop_partitions)}
                 for piece_index in range(len(pieces))
                 for drop_partition in range(shuffle_row_drop_partitions)]
        self._num_items = len(items)
        self._shuffle_row_drop_partitions = shuffle_row_drop_partitions
        self._dynamic = bool(dynamic_ventilation)
        if self._dynamic:
            # The caller owns the (mutable) piece queue: planned epochs,
            # shuffling and resume trimming mean nothing here.
            if resume_state is not None:
                raise ValueError("dynamic_ventilation readers have no pre-planned "
                                 "ventilation to trim — resume_state is not supported")
            if shuffle_row_groups:
                raise ValueError("dynamic_ventilation serves an externally-ordered piece "
                                 "queue; shuffle_row_groups must be False")
            if shuffle_row_drop_partitions != 1:
                raise ValueError("dynamic_ventilation does not support "
                                 "shuffle_row_drop_partitions")
        # Filters, the selector and an explicit plan change which pieces the
        # positional item keys denote, so they are part of the resume
        # fingerprint (the two-element form without a plan, as in the JAX
        # package, so either package's states resume the other's).
        self._planning_repr = repr(
            (filters, rowgroup_selector) if piece_indices is None
            else (filters, rowgroup_selector, tuple(piece_indices)))
        self._resume_state = resume_state
        iterations, per_item_iterations, prior_counts = num_epochs, None, None
        if resume_state is not None:
            self._validate_resume_state(resume_state)
            delivered = resume_state["delivered"]
            per_item_iterations = [
                max(0, num_epochs - delivered.get(
                    item_key(it["piece_index"], it["shuffle_row_drop_partition"][0]), 0))
                for it in items]
            prior_counts = dict(delivered)
            iterations = max(per_item_iterations, default=0)
            if iterations == 0:
                # Everything was delivered: a reader that yields nothing more.
                items, per_item_iterations = [], None
        self._delivery_tracker = DeliveryTracker(preload=prior_counts)
        results_queue_reader.delivery_tracker = self._delivery_tracker

        if self._dynamic:
            self._ventilator = DynamicVentilator(reader_pool.ventilate)
        else:
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
        #: The reader's cache; :meth:`stop` calls its ``cleanup()``.
        self.cache = cache or NullCache()
        reader_pool.start(worker_class, (filesystem, pieces, schema, read_schema,
                                         self.ngram, self.cache, transform_spec),
                          ventilator=self._ventilator)
        READER_READERS.inc()
        READER_ROWGROUPS_PLANNED.set(len(pieces))

    def _apply_selector(self, pieces, rowgroup_selector, canonical=None):
        """The pieces among ``pieces`` whose canonical ordinals the selector
        keeps, matched by (file, row group): ``pieces`` may already be
        pruned by ``filters``. ``canonical``: the canonical piece list, when
        the caller has it."""
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes

        if isinstance(self._dataset_path, list):
            raise ValueError("rowgroup_selector is not supported with multiple dataset URLs")
        selected = rowgroup_selector.select_row_groups(
            get_row_group_indexes(self._filesystem, self._dataset_path))
        if canonical is None:
            canonical = load_row_groups(self._filesystem, self._dataset_path)
        selected_ids = {(p.path, p.row_group) for index, p in enumerate(canonical)
                        if index in selected}
        return [p for p in pieces if (p.path, p.row_group) in selected_ids]

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
        """The JAX reader's snapshot, merged in its order: the planning
        facts (``rowgroups_total``: this shard's row groups;
        ``items_per_epoch``: work items per epoch, 0 for a resumed reader
        with nothing left; ``workers_count``), then the pool's live
        counters (``items_processed``, ``results_queue_size``, ...), then
        the ventilator's (``items_ventilated``, ``items_in_flight``,
        ``epochs_completed``, ``ventilation_completed``), which win on a
        shared key. Safe to read mid-iteration."""
        snapshot = dict(self._diagnostics)
        snapshot.update(self._workers_pool.diagnostics)
        snapshot.update(self._ventilator.diagnostics)
        return snapshot

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
            "dataset_path": self._dataset_path_signature(),
            "num_items": self._num_items,
            "num_epochs": self.num_epochs,
            "shard": [self.cur_shard, self.shard_count, self._shard_seed],
            "drop_partitions": self._shuffle_row_drop_partitions,
            "planning": self._planning_repr,
            "delivered": delivered,
        }

    def _dataset_path_signature(self):
        path = self._dataset_path
        return sorted(str(p) for p in path) if isinstance(path, list) else str(path)

    def _validate_resume_state(self, state):
        if state.get("version") != 1:
            raise ValueError(f"Unsupported resume_state version {state.get('version')!r}")
        if self.num_epochs is None:
            raise ValueError(
                "resume_state requires finite num_epochs (an infinite stream "
                "has no resumable endpoint — just restart it)")
        expected = {
            "dataset_path": self._dataset_path_signature(),
            "num_items": self._num_items,
            "num_epochs": self.num_epochs,
            "shard": [self.cur_shard, self.shard_count, self._shard_seed],
            "drop_partitions": self._shuffle_row_drop_partitions,
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

    def next(self):
        return self.__next__()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()

    def stop(self):
        self._workers_pool.stop()
        self.stopped = True
        self.cache.cleanup()

    def join(self):
        self._workers_pool.join()

    def resize_workers(self, workers_count):
        """Change the decode pool's parallelism while the reader runs (the
        autotuner's ``workers_count`` knob): thread pools only. A process
        pool cannot resize in either package, its workers being processes
        started with it; the dummy pool has no workers to resize."""
        pool = self._workers_pool
        if isinstance(pool, ProcessPool):
            raise NotImplementedError(
                "ProcessPool cannot resize at runtime: its workers are processes "
                "started with the pool")
        resize = getattr(pool, "resize", None)
        if resize is None:
            raise NotImplementedError(
                f"{type(pool).__name__} cannot resize at runtime — use "
                f"reader_pool_type='thread'")
        resize(workers_count)

    def reset(self):
        """Start the same epochs again, once every row of the previous run
        was consumed (NotImplementedError mid-epoch, as in the JAX reader,
        and on a resumed reader, whose plan holds only the checkpoint's
        remaining work). The delivery accounting restarts with it: a
        ``state_dict()`` taken after ``reset()`` describes the new pass."""
        if not self.last_row_consumed:
            raise NotImplementedError(
                "Currently, reset() can only be called after all rows were consumed")
        if self._resume_state is not None:
            raise NotImplementedError(
                "reset() is not supported on a resumed reader — construct a fresh "
                "reader (without resume_state) for a new full pass")
        self.last_row_consumed = False
        self._delivery_tracker = DeliveryTracker()
        self._results_queue_reader.delivery_tracker = self._delivery_tracker
        self._ventilator.reset()

    # -- the dynamic piece feed (dynamic_ventilation=True readers) -----------

    @property
    def dynamic(self):
        """True for a reader fed through :meth:`submit_piece`."""
        return self._dynamic

    def _require_dynamic(self):
        if not self._dynamic:
            raise RuntimeError("this Reader was not constructed with dynamic_ventilation=True")

    def submit_piece(self, piece_index):
        """Feed one piece (its index in the reader's enumeration) to the
        pool; the caller owns admission control."""
        self._require_dynamic()
        piece_index = int(piece_index)
        if not 0 <= piece_index < len(self._pieces):
            raise ValueError(f"piece_index {piece_index} out of range for the "
                             f"{len(self._pieces)} row-group pieces planned")
        self._ventilator.submit({"piece_index": piece_index,
                                 "worker_predicate": self._predicate,
                                 "shuffle_row_drop_partition": (0, 1)})

    def finish_pieces(self):
        """Close the piece feed: once the pieces in flight drain, the
        consumer sees end-of-data instead of blocking."""
        self._require_dynamic()
        self._ventilator.finish()

    def set_publish_transform(self, fn):
        """Install ``fn((item_key, payload)) -> (item_key, payload)`` on the
        pool's publish path, where it runs on the pool's worker thread:
        how stage fusion collapses collation, transform and serialization
        into the decode task. True when the pool has the hook (thread and
        dummy pools); False for a process pool, whose payloads cross a
        process boundary a closure cannot."""
        self._require_dynamic()
        pool = self._workers_pool
        if not hasattr(pool, "publish_transform"):
            return False
        pool.publish_transform = fn
        return True

    def set_item_done_hook(self, hook):
        """Install ``hook(item_kwargs)``, called on the consuming thread as
        it drains a work item's completion marker, after every output of
        that item was returned (thread and dummy pools)."""
        self._require_dynamic()
        if not getattr(self._workers_pool, "supports_item_done_hook", False):
            raise ValueError(
                "the streaming piece feed needs per-item completion attribution, which "
                "only thread and dummy reader pools provide — use reader_pool_type="
                "'thread' (or 'dummy')")
        self._workers_pool.item_done_hook = hook

    def read_next_tagged(self, timeout=None):
        """``(next output, piece_index)``: one output and the index of the
        piece it came from (``None`` if untagged). The pool's timeout and
        end-of-data exceptions pass through."""
        out = self._results_queue_reader.read_next(self._workers_pool, self.schema,
                                                   self.ngram, timeout=timeout)
        key = self._results_queue_reader.last_item_key
        return out, (int(key.split(":", 1)[0]) if key else None)
