"""Spark conversion of Unischemas, rows and codecs (the port's own copy of
``petastorm_tpu/compat/spark_shim.py``; optional, needs pyspark).

The package writes with pyarrow, so Spark types are a shim: each function
raises NotImplementedError when pyspark is absent and builds the JAX
package's Spark types when it is present. pyspark is imported once, with
this module.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

try:
    from pyspark.sql.types import (  # noqa: F401
        BinaryType,
        BooleanType,
        ByteType,
        DateType,
        DecimalType,
        DoubleType,
        FloatType,
        IntegerType,
        LongType,
        Row,
        ShortType,
        StringType,
        StructField,
        StructType,
        TimestampType,
    )

    _HAVE_PYSPARK = True
except ImportError:
    _HAVE_PYSPARK = False


def _require_pyspark(message=None):
    if not _HAVE_PYSPARK:
        raise NotImplementedError(
            message or "This operation requires pyspark, which is not installed; "
                       "this build's ETL engine is pyarrow (see petastorm_tpu_torch.etl).")


def _numpy_to_spark_type(numpy_dtype):
    _require_pyspark()
    if numpy_dtype is Decimal:
        return DecimalType(38, 18)
    if numpy_dtype in (str, np.str_):
        return StringType()
    if numpy_dtype in (bytes, np.bytes_):
        return BinaryType()
    dtype = np.dtype(numpy_dtype)
    mapping = {
        "b": BooleanType(), "i1": ByteType(), "i2": ShortType(), "i4": IntegerType(),
        "i8": LongType(), "u1": ShortType(), "u2": IntegerType(), "u4": LongType(),
        "u8": LongType(), "f2": FloatType(), "f4": FloatType(), "f8": DoubleType(),
    }
    if dtype.kind == "M":
        return DateType() if np.datetime_data(dtype)[0] == "D" else TimestampType()
    if dtype.kind in ("U", "S"):
        return StringType() if dtype.kind == "U" else BinaryType()
    key = dtype.kind if dtype.kind == "b" else dtype.kind + str(dtype.itemsize)
    if key not in mapping:
        raise ValueError(f"Unsupported numpy dtype for Spark conversion: {dtype}")
    return mapping[key]


def unischema_as_spark_schema(unischema):
    """``Unischema.as_spark_schema``: a ``StructType`` of the fields in
    schema order, each with its Spark type and nullability."""
    _require_pyspark()
    return StructType([
        StructField(field.name,
                    _numpy_to_spark_type(field.numpy_dtype) if field.codec is None
                    else _codec_spark_dtype(field),
                    field.nullable)
        for field in unischema.fields.values()])


def _codec_spark_dtype(field):
    from petastorm_tpu_torch.schema.codecs import ScalarCodec

    if isinstance(field.codec, ScalarCodec):
        return _numpy_to_spark_type(field.numpy_dtype)
    return BinaryType()  # the ndarray, compressed-ndarray and image codecs


def codec_spark_dtype(codec):
    """``DataframeColumnCodec.spark_dtype``: the Spark type of the codec's
    stored column. A ``ScalarCodec`` built from a type maps that type; one
    that takes its type from the field raises ValueError (use
    :func:`unischema_as_spark_schema`); every other codec stores bytes."""
    _require_pyspark("spark_dtype requires pyspark; this build's ETL engine is pyarrow")
    from petastorm_tpu_torch.schema.codecs import ScalarCodec
    from petastorm_tpu_torch.schema.unischema import _arrow_to_numpy_dtype

    if not isinstance(codec, ScalarCodec):
        return BinaryType()
    if codec.arrow_dtype() is None:
        raise ValueError("This ScalarCodec takes its type from the field; "
                         "use Unischema.as_spark_schema")
    return _numpy_to_spark_type(_arrow_to_numpy_dtype(codec.arrow_dtype())[0])


def dict_to_spark_row(unischema, row_dict):
    """Encode a row dict with the codecs and wrap it in a Spark ``Row``
    (bytes cells as ``bytearray``)."""
    _require_pyspark()
    from petastorm_tpu_torch.schema.unischema import encode_row

    return Row(**{name: bytearray(value) if isinstance(value, bytes) else value
                  for name, value in encode_row(unischema, row_dict).items()})
