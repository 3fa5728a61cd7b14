"""Synthetic dataset factories (the port's own copy of
``petastorm_tpu/test_util/dataset_factory.py``): the same schemas and rows,
written through the port's writer, so each store is byte-equal to the JAX
factory's for the same arguments.

- :func:`create_test_dataset`: ``TestSchema``, 11 fields (png image,
  ndarray, a nullable compressed ndarray, Decimal, strings);
- :func:`create_test_token_dataset`: variable-length token documents,
  padded on disk with a length column (the packing workload);
- :func:`create_test_selective_dataset`: a cheap ``keep`` column and a
  png payload (the predicate workload);
- :func:`create_test_scalar_dataset`: plain Parquet without petastorm
  metadata (``make_batch_reader``).
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.etl.metadata import materialize_rows, write_rows
from petastorm_tpu_torch.schema.codecs import (
    CompressedImageCodec,
    CompressedNdarrayCodec,
    NdarrayCodec,
    ScalarCodec,
)
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

TestSchema = Unischema("TestSchema", [
    UnischemaField("id", np.int64, (), ScalarCodec(), False),
    UnischemaField("id2", np.int32, (), ScalarCodec(), False),
    UnischemaField("partition_key", str, (), ScalarCodec(), False),
    UnischemaField("python_primitive_uint8", np.uint8, (), ScalarCodec(), False),
    UnischemaField("image_png", np.uint8, (16, 32, 3), CompressedImageCodec("png"), False),
    UnischemaField("matrix", np.float32, (4, 8), NdarrayCodec(), False),
    UnischemaField("matrix_nullable", np.float64, (2, 3), CompressedNdarrayCodec(), True),
    UnischemaField("decimal", Decimal, (), ScalarCodec(), False),
    UnischemaField("string_value", str, (), ScalarCodec(), False),
    UnischemaField("sensor_name", str, (), ScalarCodec(), False),
    UnischemaField("timestamp_s", np.int64, (), ScalarCodec(), False),
])


def make_test_row(index, rng=None):
    """Row ``index`` of :data:`TestSchema`; ``matrix_nullable`` is None on
    every third row."""
    rng = rng or np.random.RandomState(index)
    return {
        "id": index,
        "id2": index % 5,
        "partition_key": f"p_{index % 4}",
        "python_primitive_uint8": np.uint8(index % 255),
        "image_png": rng.randint(0, 255, (16, 32, 3), dtype=np.uint8),
        "matrix": rng.rand(4, 8).astype(np.float32),
        "matrix_nullable": rng.rand(2, 3).astype(np.float64) if index % 3 else None,
        "decimal": Decimal(f"{index}.{index % 10}"),
        "string_value": f"string_{index}",
        "sensor_name": f"sensor_{index % 2}",
        "timestamp_s": 1_000_000 + index,
    }


def create_test_dataset(dataset_url, rows_count=30, rows_per_row_group=10,
                        rows_per_file=None, **write_kwargs):
    """Write a petastorm-format :data:`TestSchema` dataset; returns the
    source rows."""
    rows = [make_test_row(i) for i in range(rows_count)]
    materialize_rows(dataset_url, TestSchema, rows, rows_per_row_group=rows_per_row_group,
                     rows_per_file=rows_per_file, **write_kwargs)
    return rows


#: Token documents are stored padded to this length, with their true length.
TOKEN_MAX_LEN = 48


def _token_schema(max_len):
    return Unischema("TokenSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("tokens", np.int32, (max_len,), NdarrayCodec(), False),
        UnischemaField("length", np.int32, (), ScalarCodec(), False),
    ])


TokenSchema = _token_schema(TOKEN_MAX_LEN)


def make_token_row(index, max_len=TOKEN_MAX_LEN, skew=2.5):
    """One deterministic document: lengths are short-heavy (mean about
    ``max_len / (1 + skew)``; ``skew=1`` is uniform), tokens derived from
    the index."""
    rng = np.random.RandomState(977 + index)
    length = max(1, min(max_len, int(round(max_len * (1.0 - rng.power(skew))))))
    tokens = np.zeros(max_len, dtype=np.int32)
    tokens[:length] = (np.arange(length, dtype=np.int32) * 7919 + index * 31 + 1) % 50000
    return {"id": index, "tokens": tokens, "length": np.int32(length)}


def create_test_token_dataset(dataset_url, rows_count=60, rows_per_row_group=10,
                              max_len=TOKEN_MAX_LEN, skew=2.5, **write_kwargs):
    """Write a variable-length token dataset; returns the source rows."""
    schema = TokenSchema if max_len == TOKEN_MAX_LEN else _token_schema(max_len)
    rows = [make_token_row(i, max_len=max_len, skew=skew) for i in range(rows_count)]
    materialize_rows(dataset_url, schema, rows, rows_per_row_group=rows_per_row_group,
                     **write_kwargs)
    return rows


def _selective_schema(payload_shape):
    return Unischema("SelectiveSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("keep", np.int32, (), ScalarCodec(), False),
        UnischemaField("payload", np.uint8, tuple(payload_shape),
                       CompressedImageCodec("png"), False),
    ])


SelectiveSchema = _selective_schema((64, 64, 3))


def make_selective_row(index, keep_every=4, payload_shape=(64, 64, 3)):
    """One deterministic row: ``keep`` is 1 on every ``keep_every``-th row,
    the png payload derived from the index."""
    rng = np.random.RandomState(1789 + index)
    return {
        "id": index,
        "keep": np.int32(1 if index % keep_every == 0 else 0),
        "payload": rng.randint(0, 255, payload_shape, dtype=np.uint8),
    }


def create_test_selective_dataset(dataset_url, rows_count=120, rows_per_row_group=20,
                                  keep_every=4, payload_shape=(64, 64, 3), **write_kwargs):
    """Write a dataset where ``keep == 1`` selects ``1 / keep_every`` of the
    rows and every row carries a png payload; returns the source rows."""
    schema = _selective_schema(payload_shape)
    rows = [make_selective_row(i, keep_every=keep_every, payload_shape=tuple(payload_shape))
            for i in range(rows_count)]
    materialize_rows(dataset_url, schema, rows, rows_per_row_group=rows_per_row_group,
                     **write_kwargs)
    return rows


ScalarSchema = Unischema("ScalarSchema", [
    UnischemaField("id", np.int64, (), None, False),
    UnischemaField("float_col", np.float64, (), None, False),
    UnischemaField("int_col", np.int32, (), None, False),
    UnischemaField("string_col", str, (), None, False),
])


def create_test_scalar_dataset(dataset_url, rows_count=30, rows_per_row_group=10,
                               **write_kwargs):
    """Write plain Parquet (no petastorm metadata); returns the rows."""
    rows = [{"id": i, "float_col": i * 1.5, "int_col": np.int32(i * 2),
             "string_col": f"value_{i}"} for i in range(rows_count)]
    write_rows(dataset_url, ScalarSchema, rows, rows_per_row_group=rows_per_row_group,
               **write_kwargs)
    return rows
