"""TensorFlow adapters: a reader as a ``tf.data.Dataset`` or eager tensors
(the port's own copy of ``petastorm_tpu/tf_utils.py``).

TensorFlow is the caller's framework here, so nothing takes a ``device``:
the dataset is TensorFlow's, on whatever device TensorFlow places it.

- ``from_generator`` with an ``output_signature`` (TF2), over row, batch and
  columnar readers; NGram readers give ``{offset: namedtuple}`` elements.
- TensorFlow's missing dtypes promote as in the JAX package: uint16 →
  int32, uint32 / uint64 → int64, Decimal → string, datetime64 → int64
  (epoch nanoseconds). A None value raises ValueError.

TensorFlow is imported inside the functions, never with this module, so
importing the package never loads it.
"""

from __future__ import annotations

import re
from collections import namedtuple
from decimal import Decimal

import numpy as np

#: numpy dtype name → TensorFlow dtype name, where TensorFlow lacks the
#: numpy one.
_NUMPY_TO_TF_PROMOTIONS = {"uint16": "int32", "uint32": "int64", "uint64": "int64"}


def _field_tf_dtype(field):
    """The ``tf.DType`` of a UnischemaField, after the promotions."""
    import tensorflow as tf

    if field.numpy_dtype is Decimal or field.numpy_dtype in (str, np.str_, bytes, np.bytes_):
        return tf.string
    np_dtype = np.dtype(field.numpy_dtype)
    if np_dtype.kind == "M":
        return tf.int64  # epoch nanoseconds
    return tf.dtypes.as_dtype(_NUMPY_TO_TF_PROMOTIONS.get(np_dtype.name, np_dtype.name))


def _schema_to_tf_dtypes(schema):
    """``{field_name: tf.DType}`` of a Unischema, in field order."""
    return {name: _field_tf_dtype(field) for name, field in schema.fields.items()}


def _sanitize_field_tf_name(name):
    """TensorFlow names reject some characters a field name may hold."""
    return re.sub(r"[^A-Za-z0-9_.\-/]", "_", name)


def _coerce_value(field, value, tf_dtype):
    """A reader value as the numpy value of its promoted TensorFlow dtype."""
    if value is None:
        raise ValueError(
            f"Field {field.name!r} is None; TF tensors cannot carry nulls — "
            f"filter nullable fields with a predicate/TransformSpec or select "
            f"non-nullable schema_fields")
    if field.numpy_dtype is Decimal:
        return str(value)
    np_dtype = (np.dtype(field.numpy_dtype)
                if field.numpy_dtype not in (str, np.str_, bytes, np.bytes_) else None)
    if np_dtype is not None and np_dtype.kind == "M":
        return np.asarray(value, dtype="datetime64[ns]").astype(np.int64)
    if tf_dtype.name in ("int32", "int64") and np_dtype is not None and np_dtype.kind == "u":
        return np.asarray(value).astype(tf_dtype.name)
    return value


def _row_signature(schema, batched):
    """``(names, TensorSpec tuple)`` of the generator's flat output."""
    import tensorflow as tf

    names, specs = [], []
    for name, field in schema.fields.items():
        shape = tuple(field.shape or ())
        specs.append(tf.TensorSpec(shape=(None,) + shape if batched else shape,
                                   dtype=_field_tf_dtype(field),
                                   name=_sanitize_field_tf_name(name)))
        names.append(name)
    return names, tuple(specs)


def make_petastorm_dataset(reader):
    """A reader as a ``tf.data.Dataset``.

    - ``make_reader``: one schema namedtuple a row; with an NGram,
      ``{offset: namedtuple}`` windows.
    - ``make_batch_reader`` / ``make_columnar_reader``: namedtuples of
      column batches, one a work item (``.unbatch().batch(B)`` for training).
    """
    import tensorflow as tf

    if reader.ngram is not None:
        return _make_ngram_dataset(tf, reader)
    schema = reader.schema
    names, specs = _row_signature(schema, batched=reader.batched_output)
    fields = [schema.fields[n] for n in names]
    dtypes = [_field_tf_dtype(f) for f in fields]

    def generator():
        for row in reader:
            yield tuple(_coerce_value(f, getattr(row, n), d)
                        for n, f, d in zip(names, fields, dtypes))

    dataset = tf.data.Dataset.from_generator(generator, output_signature=specs)
    return dataset.map(lambda *cols: schema.make_namedtuple_tf(*cols))


def _make_ngram_dataset(tf, reader):
    """An NGram reader as a dataset of ``{offset: namedtuple}`` windows."""
    ngram, schema = reader.ngram, reader.schema
    per_offset = []
    for offset in sorted(ngram.fields):
        names = sorted(ngram.get_field_names_at_timestep(offset))
        fields = [schema.fields[n] for n in names]
        per_offset.append((offset, names, fields, [_field_tf_dtype(f) for f in fields]))
    specs = tuple(
        tf.TensorSpec(shape=tuple(f.shape or ()), dtype=d,
                      name=_sanitize_field_tf_name(f"{n}_{offset}"))
        for offset, names, fields, dtypes in per_offset
        for n, f, d in zip(names, fields, dtypes))

    def generator():
        for window in reader:
            flat = []
            for offset, names, fields, dtypes in per_offset:
                step = window[offset]
                flat.extend(_coerce_value(f, getattr(step, n), d)
                            for n, f, d in zip(names, fields, dtypes))
            yield tuple(flat)

    dataset = tf.data.Dataset.from_generator(generator, output_signature=specs)
    step_types = {offset: namedtuple(f"NGramStep_{offset}",
                                     [_sanitize_field_tf_name(n) for n in names])
                  for offset, names, _, _ in per_offset}

    def reassemble(*cols):
        out, i = {}, 0
        for offset, names, _, _ in per_offset:
            out[offset] = step_types[offset](*cols[i:i + len(names)])
            i += len(names)
        return out

    return dataset.map(reassemble)


def tf_tensors(reader, shuffling_queue_capacity=0, min_after_dequeue=0):
    """An iterator of schema namedtuples of eager tensors, one a row. With
    ``shuffling_queue_capacity`` > 0 the rows pass through ``tf.data``'s
    shuffle buffer of ``max(shuffling_queue_capacity, min_after_dequeue +
    1)`` elements."""
    dataset = make_petastorm_dataset(reader)
    if shuffling_queue_capacity > 0:
        dataset = dataset.shuffle(max(shuffling_queue_capacity, min_after_dequeue + 1))
    return iter(dataset)
