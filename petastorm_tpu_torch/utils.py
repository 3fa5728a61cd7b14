"""Column-wise decode of a row group (the port's own copy of
``petastorm_tpu/utils.py::decode_table``), shared by the row and columnar
workers."""

from __future__ import annotations

import numpy as np

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
