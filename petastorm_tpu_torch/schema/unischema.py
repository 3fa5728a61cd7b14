"""Unischema: a tensor-aware schema over Parquet columns.

The port's own copy of ``petastorm_tpu/schema/unischema.py``, cut to what the
port uses: fields, the namedtuple row type the readers yield, schema views
(``schema_fields`` of the readers: fields and full-match name regexes), the
storage arrow schema, and row encoding for the ETL writer. (Arrow-schema
inference and the Spark shims are not ported yet.)
"""

from __future__ import annotations

import re
import warnings
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

    def make_namedtuples(self, row_dicts):
        """:meth:`make_namedtuple` over a list of row dicts."""
        self.make_namedtuple()
        return [self._namedtuple(*map(row.get, self._fields)) for row in row_dicts]

    def create_schema_view(self, fields):
        """A sub-schema in this schema's field order. ``fields`` holds
        :class:`UnischemaField` s of this schema and/or field-name regexes
        (full match)."""
        if not isinstance(fields, (list, tuple)):
            raise ValueError("fields must be a list of UnischemaField or regex strings")
        seen = set()
        for item in fields:
            if isinstance(item, UnischemaField):
                if item.name not in self._fields:
                    raise ValueError(
                        f"Field {item.name!r} does not belong to schema {self._name!r}")
                if item != self._fields[item.name]:
                    warnings.warn(
                        f"Field {item.name!r} differs from the schema's definition "
                        "(dtype/shape/codec/nullable mismatch); using the schema's field",
                        UserWarning, stacklevel=2)
                seen.add(item.name)
            elif isinstance(item, str):
                matches = match_unischema_fields(self, [item])
                if not matches:
                    raise ValueError(
                        f"Field regex {item!r} matched no fields of schema {self._name!r}")
                seen.update(f.name for f in matches)
            else:
                raise ValueError(f"Invalid field spec: {item!r}")
        return Unischema(f"{self._name}_view",
                         [f for f in self._fields.values() if f.name in seen])

    def resolve_schema_view(self, schema_fields):
        """``schema_fields=None`` -> this schema; else a view of it."""
        if schema_fields is None:
            return self
        return self.create_schema_view(list(schema_fields))

    def as_arrow_schema(self):
        """The storage arrow schema (codec-encoded columns are binary)."""
        return pa.schema([
            pa.field(f.name, _storage_arrow_type(f), nullable=f.nullable)
            for f in self._fields.values()])


def match_unischema_fields(schema, field_regexes):
    """The fields of ``schema`` whose names fully match any of
    ``field_regexes`` (anchored, not prefix matches)."""
    compiled = [re.compile(pattern) for pattern in field_regexes or ()]
    return [f for f in schema.fields.values()
            if any(c.fullmatch(f.name) for c in compiled)]


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
