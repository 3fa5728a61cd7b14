"""One call from a DataFrame to PyTorch or TensorFlow input pipelines (the
port's own copy of ``petastorm_tpu/spark/dataset_converter.py``).

Reference parity: ``petastorm/spark/spark_dataset_converter.py``
(``make_spark_converter``, ``SparkDatasetConverter`` with
``make_torch_dataloader`` / ``.delete()``, cache-directory management,
dedup, ref-counting, atexit cleanup). As in the JAX package:

- the engine is pyarrow: the input is a ``pa.Table`` or a pandas DataFrame
  (a pyspark DataFrame is converted through ``toPandas()``), and
  materialization is ``pq.write_table``, no JVM; pandas is imported only
  for a DataFrame, so a ``pa.Table`` converts on a host without it;
- dedup hashes the content (the table's Arrow IPC stream into SHA-256,
  with the write options), so the same table under the same options gives
  the JAX converter's key, directory name and ``part-00000.parquet`` bytes.

The loaders:

- :meth:`DatasetConverter.make_torch_dataloader`: the reference's, the
  port's :class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader` over
  ``make_batch_reader``, as a context manager;
- :meth:`DatasetConverter.make_torch_device_dataloader`: the counterpart of
  the JAX converter's ``make_jax_dataloader``, the port's
  :func:`~petastorm_tpu_torch.torch_utils.loader.make_torch_dataloader`
  over ``make_batch_reader`` with ``loader_kwargs`` (``autotune=``,
  ``device_prefetch``, ...);
- :meth:`DatasetConverter.make_tf_dataset`: a ``tf.data.Dataset`` over
  ``make_batch_reader`` (:func:`~petastorm_tpu_torch.tf_utils.
  make_petastorm_dataset`), rebatched to ``batch_size`` when given.

The parent cache directory comes from (in priority order) the explicit
argument, :func:`set_parent_cache_dir_url`, or ``$PETASTORM_TPU_CACHE_DIR``,
standing in for the reference's Spark conf key
``petastorm.spark.converter.parentCacheDirUrl``.

The registry and its ref-counts belong to this package: a JAX converter and
a port converter of the same table under the same parent share one
directory, and the first ``delete()`` of either removes it from under the
other.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import shutil
import threading
import uuid

import numpy as np

logger = logging.getLogger(__name__)

_parent_cache_dir_url = None
_cache_lock = threading.Lock()
#: content hash -> CachedDataFrameMeta (reference: ``_cache_df_meta_list``)
_cache_registry = {}


def set_parent_cache_dir_url(url):
    """Set the parent directory under which materialized caches are created
    (reference conf key ``petastorm.spark.converter.parentCacheDirUrl``)."""
    global _parent_cache_dir_url
    _parent_cache_dir_url = url


def _resolve_parent_cache_dir(explicit):
    url = explicit or _parent_cache_dir_url \
        or os.environ.get("PETASTORM_TPU_CACHE_DIR")
    if not url:
        raise ValueError(
            "No cache directory configured: pass parent_cache_dir_url=, call "
            "set_parent_cache_dir_url(), or set $PETASTORM_TPU_CACHE_DIR "
            "(reference conf key petastorm.spark.converter.parentCacheDirUrl)")
    return url


def _local_path(url):
    return url[7:] if url.startswith("file://") else url


class CachedDataFrameMeta:
    """Bookkeeping for one materialized cache directory (ref-counted)."""

    def __init__(self, cache_key, dir_url, row_count):
        self.cache_key = cache_key
        self.dir_url = dir_url
        self.row_count = row_count
        self.ref_count = 0


def _to_arrow_table(df, dtype=None):
    """pyarrow / pandas / pyspark input → ``pa.Table``, floating columns
    cast to ``dtype`` when it is given."""
    import pyarrow as pa

    if hasattr(df, "toPandas"):  # a pyspark DataFrame
        df = df.toPandas()
    if isinstance(df, pa.Table):
        table = df
    else:
        import pandas as pd

        if not isinstance(df, pd.DataFrame):
            raise TypeError(
                f"Unsupported input {type(df)}; expected pandas DataFrame, "
                f"pyarrow Table, or pyspark DataFrame")
        table = pa.Table.from_pandas(df, preserve_index=False)
    if dtype:
        target = pa.from_numpy_dtype(np.dtype(dtype))
        cast_fields = [
            pa.field(f.name, target) if pa.types.is_floating(f.type) else f
            for f in table.schema]
        table = table.cast(pa.schema(cast_fields))
    return table


class _HashingSink:
    """File-like sink that feeds written bytes straight into a hasher, so an
    Arrow IPC stream is hashed without a copy."""

    def __init__(self, hasher):
        self._hasher = hasher

    def write(self, data):
        self._hasher.update(data)
        return len(data)

    def flush(self):
        pass

    @property
    def closed(self):
        return False

    def close(self):
        pass


def _content_hash(table, row_group_size_bytes, compression_codec, dtype):
    """The dedup key: SHA-256 of the schema, the write options and the
    table's Arrow IPC stream, which truncates buffers to their slices at
    every nesting level, so zero-copy slices hash by logical content.
    Identical content in other chunks may hash apart: that costs a second
    directory, never a wrong reuse."""
    import pyarrow as pa

    hasher = hashlib.sha256()
    hasher.update(str(table.schema).encode("utf-8"))
    hasher.update(f"{row_group_size_bytes}|{compression_codec}|{dtype}|"
                  f"{table.num_rows}".encode("utf-8"))
    with pa.ipc.new_stream(_HashingSink(hasher), table.schema) as writer:
        writer.write_table(table)
    return hasher.hexdigest()[:32]


def make_spark_converter(df, parquet_row_group_size_bytes=32 * 1024 * 1024,
                         compression_codec="snappy", dtype="float32",
                         parent_cache_dir_url=None):
    """Materialize ``df`` once (dedup by content hash) and return a
    :class:`DatasetConverter` over it.

    Reference parity: ``make_spark_converter(df, parquet_row_group_size_bytes,
    compression_codec, dtype)``. ``dtype`` casts floating columns (the
    reference's precision conversion); ``None`` keeps the dtypes.
    """
    import pyarrow.parquet as pq

    parent_path = _local_path(_resolve_parent_cache_dir(parent_cache_dir_url))
    table = _to_arrow_table(df, dtype=dtype)
    cache_key = _content_hash(table, parquet_row_group_size_bytes,
                              compression_codec, dtype)
    dir_path = os.path.join(parent_path, f"cache-{cache_key}")
    # Materialize outside the lock (a long write must not serialize
    # unrelated conversions); a temporary directory renamed into place makes
    # concurrent writers of the same content converge on one directory.
    if not os.path.isdir(dir_path):
        os.makedirs(parent_path, exist_ok=True)
        tmp_path = dir_path + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp_path)
        rows_per_group = max(
            1, int(parquet_row_group_size_bytes
                   // max(table.nbytes // max(table.num_rows, 1), 1)))
        pq.write_table(table,
                       os.path.join(tmp_path, "part-00000.parquet"),
                       row_group_size=rows_per_group,
                       compression=compression_codec)
        try:
            os.rename(tmp_path, dir_path)  # atomic publish
        except OSError:  # another writer published first
            shutil.rmtree(tmp_path, ignore_errors=True)
    else:
        logger.info("Reusing existing cache dir %s", dir_path)
    with _cache_lock:
        meta = _cache_registry.get(cache_key)
        if meta is None:
            meta = CachedDataFrameMeta(cache_key, f"file://{dir_path}",
                                       table.num_rows)
            _cache_registry[cache_key] = meta
        meta.ref_count += 1
    return DatasetConverter(meta)


class DatasetConverter:
    """Handle to a materialized cache directory; builds input pipelines
    over it (reference ``SparkDatasetConverter``: ``make_torch_dataloader``,
    ``__len__``, ``.delete()``)."""

    def __init__(self, cached_meta):
        self._meta = cached_meta
        self.cache_dir_url = cached_meta.dir_url

    def __len__(self):
        return self._meta.row_count

    # -- pipeline factories (context managers, the reference's shape) -----

    def _make_batch_reader(self, reader_kwargs):
        from petastorm_tpu_torch.reader.reader import make_batch_reader

        return make_batch_reader(self.cache_dir_url, **(reader_kwargs or {}))

    def make_tf_dataset(self, batch_size=None, num_epochs=None, workers_count=None,
                        shuffle_row_groups=True, **reader_kwargs):
        """The reference's TensorFlow pipeline: ``make_batch_reader`` over
        the cache directory → :func:`~petastorm_tpu_torch.tf_utils.
        make_petastorm_dataset`, unbatched and rebatched to ``batch_size``
        when given, as a context manager that stops the reader on exit.
        TensorFlow is the caller's framework here: no ``device``."""
        reader_kwargs.setdefault("shuffle_row_groups", shuffle_row_groups)
        if num_epochs is not None:
            reader_kwargs["num_epochs"] = num_epochs
        if workers_count is not None:
            reader_kwargs["workers_count"] = workers_count
        return _TFDatasetContextManager(self._make_batch_reader(reader_kwargs), batch_size)

    def make_torch_dataloader(self, batch_size=32, num_epochs=None,
                              workers_count=None, shuffling_queue_capacity=0,
                              device="cuda", **reader_kwargs):
        """The reference's loader: ``make_batch_reader`` over the cache
        directory → :class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader`
        on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``), as a
        context manager that stops the reader on exit."""
        if num_epochs is not None:
            reader_kwargs["num_epochs"] = num_epochs
        if workers_count is not None:
            reader_kwargs["workers_count"] = workers_count
        from petastorm_tpu_torch.pytorch import BatchedDataLoader

        reader = self._make_batch_reader(reader_kwargs)
        return _ClosingContextManager(
            BatchedDataLoader(reader, batch_size=batch_size,
                              shuffling_queue_capacity=shuffling_queue_capacity,
                              device=device))

    def make_torch_device_dataloader(self, batch_size=32, num_epochs=None,
                                     workers_count=None, loader_kwargs=None,
                                     **reader_kwargs):
        """The JAX converter's ``make_jax_dataloader`` in the port:
        ``make_batch_reader`` over the cache directory →
        :func:`~petastorm_tpu_torch.torch_utils.loader.make_torch_dataloader`
        ``(reader, batch_size, **loader_kwargs)`` (prefetched onto the card
        unless ``loader_kwargs`` holds ``device="cpu"``; ``autotune=`` arms
        the online autotuner), as a context manager that stops the loader
        and its reader on exit."""
        if num_epochs is not None:
            reader_kwargs["num_epochs"] = num_epochs
        if workers_count is not None:
            reader_kwargs["workers_count"] = workers_count
        from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

        reader = self._make_batch_reader(reader_kwargs)
        return _ClosingContextManager(
            make_torch_dataloader(reader, batch_size, **(loader_kwargs or {})))

    # -- lifecycle ---------------------------------------------------------

    def delete(self):
        """Drop this handle's reference; the last reference removes the
        cache directory (reference ``.delete()``)."""
        with _cache_lock:
            meta = self._meta
            meta.ref_count -= 1
            if meta.ref_count <= 0:
                _cache_registry.pop(meta.cache_key, None)
                shutil.rmtree(_local_path(meta.dir_url), ignore_errors=True)


#: Reference import-compatible alias.
SparkDatasetConverter = DatasetConverter
#: The reference's conf-key name, kept as a constant.
SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF = \
    "petastorm.spark.converter.parentCacheDirUrl"


class _ClosingContextManager:
    """``with converter.make_torch_dataloader() as loader:`` closes the
    loader (and its reader) on exit."""

    def __init__(self, loader):
        self._loader = loader

    def __enter__(self):
        return self._loader.__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        return self._loader.__exit__(exc_type, exc_val, exc_tb)


class _TFDatasetContextManager:
    """Yields a ``tf.data.Dataset``; stops the reader on exit."""

    def __init__(self, reader, batch_size):
        self._reader = reader
        self._batch_size = batch_size

    def __enter__(self):
        from petastorm_tpu_torch.tf_utils import make_petastorm_dataset

        dataset = make_petastorm_dataset(self._reader)
        if self._batch_size:
            dataset = dataset.unbatch().batch(self._batch_size)
        return dataset

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._reader.stop()
        self._reader.join()


@atexit.register
def _cleanup_remaining_caches():
    """Best-effort removal of still-referenced caches at interpreter exit
    (the reference registers the same kind of hook)."""
    with _cache_lock:
        for meta in list(_cache_registry.values()):
            shutil.rmtree(_local_path(meta.dir_url), ignore_errors=True)
        _cache_registry.clear()
