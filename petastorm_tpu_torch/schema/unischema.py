"""Unischema: a tensor-aware schema over Parquet columns.

The port's own copy of ``petastorm_tpu/schema/unischema.py``, cut to what the
port uses: fields, the namedtuple row type the readers yield, schema views
(``schema_fields`` of the readers: fields and full-match name regexes), the
storage arrow schema, row encoding for the ETL writer (through
``insert_explicit_nulls``), inference of a codec-less schema from an Arrow
schema (``make_batch_reader``'s plain Parquet stores), and the JAX
package's value equality of fields, codecs and schemas. (The Spark shims
are not ported yet.)
"""

from __future__ import annotations

import re
import warnings
from collections import OrderedDict, namedtuple
from decimal import Decimal

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

    def __hash__(self):
        return hash((self.name, _dtype_token(self.numpy_dtype), self.shape, self.nullable))

    def __eq__(self, other):
        if not isinstance(other, UnischemaField):
            return NotImplemented
        return (self.name == other.name
                and _dtype_token(self.numpy_dtype) == _dtype_token(other.numpy_dtype)
                and self.shape == other.shape and self.codec == other.codec
                and self.nullable == other.nullable)

    def __ne__(self, other):
        result = self.__eq__(other)
        return result if result is NotImplemented else not result


def _dtype_token(numpy_dtype):
    """A comparable token for a field dtype (numpy dtype, Decimal, str, bytes)."""
    if numpy_dtype is Decimal:
        return "decimal"
    if numpy_dtype in (str, np.str_):
        return "str"
    if numpy_dtype in (bytes, np.bytes_):
        return "bytes"
    return np.dtype(numpy_dtype).str


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

    @property
    def field_names(self):
        """Field names in schema order."""
        return tuple(self._fields)

    def __eq__(self, other):
        if not isinstance(other, Unischema):
            return NotImplemented
        return list(self._fields.values()) == list(other._fields.values())

    def __ne__(self, other):
        result = self.__eq__(other)
        return result if result is NotImplemented else not result

    def __hash__(self):
        return hash(tuple(self._fields.values()))

    def __repr__(self):
        lines = [f"{self._name}:"]
        for field in self._fields.values():
            codec = type(field.codec).__name__ if field.codec else None
            lines.append(f"  {field.name}: {_dtype_token(field.numpy_dtype)} {field.shape} "
                         f"codec={codec} nullable={field.nullable}")
        return "\n".join(lines)

    def make_namedtuple(self, **kwargs):
        """Row namedtuple from per-field kwargs (missing fields → None)."""
        if self._namedtuple is None:
            self._namedtuple = namedtuple(_sanitize_identifier(self._name),
                                          list(self._fields))
        return self._namedtuple(*map(kwargs.get, self._fields))

    def make_namedtuple_tf(self, *args, **kwargs):
        """The row namedtuple from positional or keyword values as given
        (the TensorFlow adapters build it from tensors)."""
        self.make_namedtuple()
        return self._namedtuple(*args, **kwargs)

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

    def as_spark_schema(self):
        """The Spark ``StructType`` of the schema (needs pyspark;
        :mod:`petastorm_tpu_torch.compat.spark_shim`)."""
        from petastorm_tpu_torch.compat.spark_shim import unischema_as_spark_schema

        return unischema_as_spark_schema(self)

    @classmethod
    def from_arrow_schema(cls, arrow_schema_or_dataset, omit_unsupported_fields=False):
        """A codec-less Unischema inferred from an arrow schema (or a
        ``pyarrow.dataset.Dataset``): list columns become ``(None, ...)``
        shapes, strings ``str``, binaries ``bytes``, decimals ``Decimal``.
        A type with no numpy counterpart raises, or is left out with
        ``omit_unsupported_fields``."""
        arrow_schema = arrow_schema_or_dataset
        if not isinstance(arrow_schema, pa.Schema):
            arrow_schema = arrow_schema_or_dataset.schema
        fields = []
        for arrow_field in arrow_schema:
            try:
                numpy_dtype, shape = _arrow_to_numpy_dtype(arrow_field.type)
            except ValueError:
                if omit_unsupported_fields:
                    continue
                raise
            fields.append(UnischemaField(arrow_field.name, numpy_dtype, shape, None,
                                         arrow_field.nullable))
        return cls("inferred_schema", fields)


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


def _arrow_to_numpy_dtype(arrow_type):
    """arrow type -> (numpy dtype or str / bytes / Decimal, shape tuple)."""
    if pa.types.is_list(arrow_type) or pa.types.is_large_list(arrow_type):
        inner_dtype, inner_shape = _arrow_to_numpy_dtype(arrow_type.value_type)
        return inner_dtype, (None,) + inner_shape
    if pa.types.is_decimal(arrow_type):
        return Decimal, ()
    if pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type):
        return str, ()
    if pa.types.is_binary(arrow_type) or pa.types.is_large_binary(arrow_type):
        return bytes, ()
    if pa.types.is_timestamp(arrow_type):
        return np.dtype(f"datetime64[{arrow_type.unit}]"), ()
    if pa.types.is_date32(arrow_type):
        return np.dtype("datetime64[D]"), ()
    if pa.types.is_date64(arrow_type):
        return np.dtype("datetime64[ms]"), ()
    try:
        return np.dtype(arrow_type.to_pandas_dtype()), ()
    except (NotImplementedError, TypeError) as exc:
        raise ValueError(f"Unsupported arrow type: {arrow_type}") from exc


def insert_explicit_nulls(unischema, row_dict):
    """Set ``None`` in ``row_dict`` for each missing nullable field; raise
    for a missing non-nullable one."""
    for field_name, field in unischema.fields.items():
        if field_name not in row_dict:
            if not field.nullable:
                raise ValueError(
                    f"Field {field_name!r} is not nullable but is missing from the row")
            row_dict[field_name] = None
    return row_dict


def encode_row(unischema, row_dict):
    """Encode one row dict into storage cells: validates field names, fills
    missing nullable fields with explicit nulls (on a copy: the caller's
    dict is never changed), applies codecs."""
    if not isinstance(row_dict, dict):
        raise TypeError(f"row must be a dict, got {type(row_dict)}")
    unknown = set(row_dict) - set(unischema.fields)
    if unknown:
        raise ValueError(f"Unknown fields in row: {sorted(unknown)}")
    row_dict = insert_explicit_nulls(unischema, dict(row_dict))
    encoded = {}
    for name, field in unischema.fields.items():
        value = row_dict[name]
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


def dict_to_spark_row(unischema, row_dict):
    """A row dict encoded with the codecs as a Spark ``Row`` (needs pyspark;
    :mod:`petastorm_tpu_torch.compat.spark_shim`)."""
    from petastorm_tpu_torch.compat.spark_shim import dict_to_spark_row as _impl

    return _impl(unischema, row_dict)
