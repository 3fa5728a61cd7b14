"""Unischema: a tensor-aware schema over Parquet columns.

The port's own copy of ``petastorm_tpu/schema/unischema.py``, cut to what the
main path uses: fields, the namedtuple row type the reader yields, the
storage arrow schema, and row encoding for the ETL writer. (Schema views,
arrow-schema inference and the Spark shims are not ported yet.)
"""

from __future__ import annotations

import re
from collections import OrderedDict, namedtuple

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.schema.codecs import ScalarCodec, numpy_to_arrow_type


class UnischemaField(
    namedtuple("UnischemaField", ["name", "numpy_dtype", "shape", "codec", "nullable"])
):
    """A single field: name, numpy dtype, tensor shape, storage codec,
    nullability. ``None`` entries of ``shape`` mean any size; ``codec=None``
    means a native Parquet column."""

    __slots__ = ()

    def __new__(cls, name, numpy_dtype, shape=(), codec=None, nullable=False):
        return super().__new__(cls, name, numpy_dtype, tuple(shape or ()), codec,
                               nullable)


class Unischema:
    """An ordered collection of :class:`UnischemaField`; each field is also
    an attribute (``schema.field_name``)."""

    def __init__(self, name, fields):
        self._name = name
        self._fields = OrderedDict((f.name, f) for f in fields)
        for field in self._fields.values():
            if hasattr(self, field.name):
                raise ValueError(
                    f"Field name {field.name!r} conflicts with a Unischema attribute")
            setattr(self, field.name, field)
        self._namedtuple = None

    @property
    def fields(self):
        return self._fields

    def make_namedtuple(self, **kwargs):
        """Row namedtuple from per-field kwargs (missing fields → None)."""
        if self._namedtuple is None:
            self._namedtuple = namedtuple(_sanitize_identifier(self._name),
                                          list(self._fields))
        return self._namedtuple(*map(kwargs.get, self._fields))

    def as_arrow_schema(self):
        """The storage arrow schema (codec-encoded columns are binary)."""
        return pa.schema([
            pa.field(f.name, _storage_arrow_type(f), nullable=f.nullable)
            for f in self._fields.values()])


def _sanitize_identifier(name):
    sanitized = re.sub(r"[^A-Za-z0-9_]", "_", name)
    if not sanitized or sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return sanitized


def _storage_arrow_type(field):
    codec = field.codec
    if codec is None:
        inner = numpy_to_arrow_type(field.numpy_dtype)
        for _ in field.shape:
            inner = pa.list_(inner)
        return inner
    if isinstance(codec, ScalarCodec):
        return codec.arrow_dtype_for_field(field)
    return codec.arrow_dtype()


def encode_row(unischema, row_dict):
    """Encode one row dict into storage cells: validates field names, applies
    codecs, inserts explicit nulls for missing nullable fields."""
    if not isinstance(row_dict, dict):
        raise TypeError(f"row must be a dict, got {type(row_dict)}")
    unknown = set(row_dict) - set(unischema.fields)
    if unknown:
        raise ValueError(f"Unknown fields in row: {sorted(unknown)}")
    encoded = {}
    for name, field in unischema.fields.items():
        if name not in row_dict and not field.nullable:
            raise ValueError(
                f"Field {name!r} is not nullable but is missing from the row")
        value = row_dict.get(name)
        if value is None:
            if not field.nullable:
                raise ValueError(f"Field {name!r} is not nullable but got None")
            encoded[name] = None
        elif field.codec is not None:
            encoded[name] = field.codec.encode(field, value)
        elif field.shape:
            encoded[name] = np.asarray(value, dtype=np.dtype(field.numpy_dtype)).tolist()
        else:
            encoded[name] = ScalarCodec().encode(field, value)
    return encoded
