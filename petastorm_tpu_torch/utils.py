"""Column-wise decode of a row group (the port's own copy of
``petastorm_tpu/utils.py::decode_table``) and the row-drop partition of a
table, shared by the reader's workers; the live resize of a bounded queue
(``resize_bounded_queue``), which the loader's prefetch depths use."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.schema.codecs import ScalarCodec


class DecodeFieldError(RuntimeError):
    pass


def column_cells(column):
    """An arrow column as numpy cells; a column with nulls becomes an object
    array holding None (``to_numpy`` would turn int-with-null into NaN)."""
    if column.null_count:
        out = np.empty(len(column), dtype=object)
        for i, value in enumerate(column.to_pylist()):
            out[i] = value
        return out
    return column.to_numpy(zero_copy_only=False)


def decode_table(table, schema):
    """A row group's ``pa.Table`` → a list of decoded row dicts, one column
    at a time: a codec column through ``codec.decode_column`` (one imdecode /
    np.load pass into an ``[N, ...]`` block, one ``astype`` for numeric
    scalars), a codec-less tensor field (a Parquet list column) as one
    ndarray per cell, a codec-less scalar through ``ScalarCodec``. Columns
    not in ``schema`` are left out; null cells stay None."""
    names, columns = [], []
    for name in table.column_names:
        field = schema.fields.get(name)
        if field is None:
            continue
        names.append(name)
        columns.append(_decode_column(column_cells(table.column(name)), field))
    return [dict(zip(names, values)) for values in zip(*columns)]


def _decode_column(cells, field):
    try:
        if field.codec is not None:
            return field.codec.decode_column(field, cells)
        if field.shape:
            dtype = np.dtype(field.numpy_dtype)
            return [None if v is None else np.asarray(v, dtype=dtype) for v in cells]
        return ScalarCodec().decode_column(field, cells)
    except Exception as exc:
        raise DecodeFieldError(f"Decoding field {field.name!r} failed: {exc}") from exc


def drop_partition(table, shuffle_row_drop_partition):
    """Rows ``this::num_partitions`` of ``table`` for
    ``shuffle_row_drop_partition = (this, num_partitions)``."""
    this_partition, num_partitions = shuffle_row_drop_partition
    if num_partitions <= 1:
        return table
    return table.take(pa.array(np.arange(this_partition, table.num_rows, num_partitions)))


def resize_bounded_queue(q, maxsize):
    """Set a ``queue.Queue``'s bound while it is in use: waiters blocked on
    the old bound are woken, so a raise takes effect at once, and a shrink
    lets the queue drain down to the new bound (``put`` re-checks
    ``maxsize`` under the mutex, so nothing is dropped). ``mutex`` and
    ``not_full`` share one lock in ``queue.Queue``."""
    with q.mutex:
        q.maxsize = int(maxsize)
        q.not_full.notify_all()
