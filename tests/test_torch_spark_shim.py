"""The port's Spark shim and Spark session handling against the JAX package's.

pyspark is not installed on this host. So:

- without it, ``Unischema.as_spark_schema``, ``dict_to_spark_row`` and
  ``DataframeColumnCodec.spark_dtype`` raise NotImplementedError in both
  packages;
- with a stub ``pyspark.sql.types`` put into ``sys.modules`` and both shims
  reloaded, ``as_spark_schema`` over a schema that reaches every branch of
  ``_numpy_to_spark_type`` and every codec, and ``dict_to_spark_row`` over
  seeded rows, give equal results in both packages; ``spark_dtype`` builds
  the codec's type in the port, where the JAX codec refuses (the port
  takes more here). The modules are restored afterwards;
- ``materialize_dataset`` with a duck-typed session makes the same Hadoop
  conf calls in both packages, restores or unsets each key, and attaches
  the same metadata, for a clean exit and for an exception inside the
  block (which attaches nothing).

Tolerance: none; types, rows, calls and bytes are compared exactly.
"""

import hashlib
import importlib
import os
import sys
import types
from decimal import Decimal

import numpy as np
import pytest

from petastorm_tpu.compat import spark_shim as jax_shim
from petastorm_tpu.etl import metadata as jax_metadata
from petastorm_tpu.schema import codecs as jax_codecs
from petastorm_tpu.schema import unischema as jax_unischema
from petastorm_tpu_torch.compat import spark_shim as port_shim
from petastorm_tpu_torch.etl import metadata as port_metadata
from petastorm_tpu_torch.schema import codecs as port_codecs
from petastorm_tpu_torch.schema import unischema as port_unischema

PACKAGES = {"port": (port_unischema, port_codecs, port_metadata),
            "jax": (jax_unischema, jax_codecs, jax_metadata)}

#: (name, numpy dtype) of the codec-less scalar fields: every branch of
#: ``_numpy_to_spark_type``.
SCALARS = [("decimal", Decimal), ("py_str", str), ("np_str", np.str_), ("py_bytes", bytes),
           ("np_bytes", np.bytes_), ("flag", np.bool_), ("i1", np.int8), ("i2", np.int16),
           ("i4", np.int32), ("i8", np.int64), ("u1", np.uint8), ("u2", np.uint16),
           ("u4", np.uint32), ("u8", np.uint64), ("f2", np.float16), ("f4", np.float32),
           ("f8", np.float64), ("day", np.dtype("datetime64[D]")),
           ("stamp", np.dtype("datetime64[ns]")), ("fixed_u", np.dtype("U4")),
           ("fixed_s", np.dtype("S4"))]


def _schema(package):
    unischema, codecs, _ = PACKAGES[package]
    field = unischema.UnischemaField
    fields = [field(name, dtype, (), None, i % 2 == 0) for i, (name, dtype) in enumerate(SCALARS)]
    fields += [field("scalar_codec", np.int32, (), codecs.ScalarCodec(), False),
               field("matrix", np.float32, (2, 3), codecs.NdarrayCodec(), False),
               field("packed", np.int16, (4,), codecs.CompressedNdarrayCodec(), True),
               field("image", np.uint8, (4, 4, 3), codecs.CompressedImageCodec("png"), False)]
    return unischema.Unischema("SparkSchema", fields)


def _row_schema(package):
    unischema, codecs, _ = PACKAGES[package]
    field = unischema.UnischemaField
    return unischema.Unischema("RowSchema", [
        field("id", np.int64, (), codecs.ScalarCodec(), False),
        field("name", str, (), codecs.ScalarCodec(), False),
        field("price", Decimal, (), codecs.ScalarCodec(), False),
        field("matrix", np.float32, (2, 3), codecs.NdarrayCodec(), False),
        field("packed", np.int16, (4,), codecs.CompressedNdarrayCodec(), True),
        field("image", np.uint8, (4, 4, 3), codecs.CompressedImageCodec("png"), False),
        field("plain_vec", np.float64, (3,), None, False)])


def _rows(count=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"id": i, "name": f"n{i}", "price": Decimal(f"{i}.25"),
             "matrix": rng.rand(2, 3).astype(np.float32),
             "packed": None if i == 1 else rng.randint(-9, 9, 4).astype(np.int16),
             "image": rng.randint(0, 255, (4, 4, 3)).astype(np.uint8),
             "plain_vec": rng.rand(3)} for i in range(count)]


# ---------------------------------------------------------------------------
# without pyspark
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["as_spark_schema", "dict_to_spark_row", "spark_dtype"])
def test_without_pyspark_both_packages_raise_not_implemented(call):
    assert not port_shim._HAVE_PYSPARK and not jax_shim._HAVE_PYSPARK
    for package in PACKAGES:
        unischema, codecs, _ = PACKAGES[package]
        schema = _row_schema(package)
        run = {"as_spark_schema": schema.as_spark_schema,
               "dict_to_spark_row": lambda: unischema.dict_to_spark_row(schema, _rows(1)[0]),
               "spark_dtype": codecs.NdarrayCodec().spark_dtype}[call]
        with pytest.raises(NotImplementedError, match="requires pyspark"):
            run()


# ---------------------------------------------------------------------------
# with a stub pyspark.sql.types
# ---------------------------------------------------------------------------

class _SparkType:
    def __init__(self, *args):
        self.args = args

    def __eq__(self, other):
        return type(self) is type(other) and self.args == other.args

    def __repr__(self):
        return f"{type(self).__name__}{self.args}"


class _Row(dict):
    """``Row(**kwargs)``: the fields and their values."""

    def __init__(self, **kwargs):
        super().__init__(kwargs)


def _stub_types():
    module = types.ModuleType("pyspark.sql.types")
    for name in ("BinaryType", "BooleanType", "ByteType", "DateType", "DecimalType",
                 "DoubleType", "FloatType", "IntegerType", "LongType", "ShortType",
                 "StringType", "StructField", "StructType", "TimestampType"):
        setattr(module, name, type(name, (_SparkType,), {}))
    module.Row = _Row
    return module


@pytest.fixture
def stub_pyspark(monkeypatch):
    """Both shims reloaded over a stub ``pyspark.sql.types``; restored (and
    reloaded without it) afterwards."""
    stub = _stub_types()
    pyspark, sql = types.ModuleType("pyspark"), types.ModuleType("pyspark.sql")
    pyspark.sql, sql.types = sql, stub
    for name, module in (("pyspark", pyspark), ("pyspark.sql", sql),
                         ("pyspark.sql.types", stub)):
        monkeypatch.setitem(sys.modules, name, module)
    importlib.reload(port_shim)
    importlib.reload(jax_shim)
    yield stub
    monkeypatch.undo()
    importlib.reload(port_shim)
    importlib.reload(jax_shim)
    assert not port_shim._HAVE_PYSPARK and not jax_shim._HAVE_PYSPARK


def test_as_spark_schema_equals_jax_over_every_branch(stub_pyspark):
    t = stub_pyspark
    port, jax = _schema("port").as_spark_schema(), _schema("jax").as_spark_schema()
    assert port == jax
    types_by_name = {f.args[0]: (f.args[1], f.args[2]) for f in port.args[0]}
    assert types_by_name["decimal"] == (t.DecimalType(38, 18), True)
    assert types_by_name["u2"] == (t.IntegerType(), False)
    assert types_by_name["u8"] == (t.LongType(), False)
    assert types_by_name["day"][0] == t.DateType() and types_by_name["stamp"][0] == \
        t.TimestampType()
    assert types_by_name["fixed_s"][0] == t.BinaryType()
    assert types_by_name["scalar_codec"][0] == t.IntegerType()
    assert all(types_by_name[n][0] == t.BinaryType() for n in ("matrix", "packed", "image"))
    for shim in (port_shim, jax_shim):
        with pytest.raises(ValueError, match="Unsupported numpy dtype"):
            shim._numpy_to_spark_type(np.complex64)


def test_dict_to_spark_row_equals_jax(stub_pyspark):
    port_schema, jax_schema = _row_schema("port"), _row_schema("jax")
    for row in _rows():
        port = port_unischema.dict_to_spark_row(port_schema, dict(row))
        jax = jax_unischema.dict_to_spark_row(jax_schema, dict(row))
        assert isinstance(port, stub_pyspark.Row) and port == jax
        assert list(port) == list(jax)
        assert isinstance(port["matrix"], bytearray)


def test_spark_dtype_builds_the_codec_type_where_jax_refuses(stub_pyspark):
    t = stub_pyspark
    for codec in (port_codecs.NdarrayCodec(), port_codecs.CompressedNdarrayCodec(),
                  port_codecs.CompressedImageCodec("png")):
        assert codec.spark_dtype() == t.BinaryType()
    assert port_codecs.ScalarCodec(np.int16).spark_dtype() == t.ShortType()
    assert port_codecs.ScalarCodec(str).spark_dtype() == t.StringType()
    with pytest.raises(ValueError, match="from the field"):
        port_codecs.ScalarCodec().spark_dtype()
    with pytest.raises(NotImplementedError, match="spark_dtype requires pyspark"):
        jax_codecs.NdarrayCodec().spark_dtype()


# ---------------------------------------------------------------------------
# materialize_dataset with a Spark session
# ---------------------------------------------------------------------------

class _HadoopConf:
    """A Hadoop configuration that records each call."""

    def __init__(self, calls, values):
        self._calls, self._values = calls, values

    def get(self, key):
        self._calls.append(("get", key))
        return self._values.get(key)

    def set(self, key, value):
        self._calls.append(("set", key, value))
        self._values[key] = value

    def setInt(self, key, value):  # noqa: N802 - the Hadoop name
        self._calls.append(("setInt", key, value))
        self._values[key] = str(value)

    def unset(self, key):
        self._calls.append(("unset", key))
        self._values.pop(key, None)


class _Session:
    """A duck-typed Spark session: ``sparkContext._jsc.hadoopConfiguration()``
    is a :class:`_HadoopConf`."""

    def __init__(self, values):
        self.calls, self.values = [], dict(values)
        conf = _HadoopConf(self.calls, self.values)
        jsc = types.SimpleNamespace(hadoopConfiguration=lambda: conf)
        self.sparkContext = types.SimpleNamespace(_jsc=jsc)


def _digests(path):
    return {name: hashlib.sha256(open(os.path.join(path, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(path))} if os.path.isdir(path) else {}


@pytest.mark.parametrize("fail", [False, True], ids=["clean", "raises"])
@pytest.mark.parametrize("kwargs,before", [
    ({}, {}),
    ({"row_group_size_mb": 8}, {"parquet.block.size": "1024"}),
    ({"use_summary_metadata": True},
     {"parquet.block.size": "1024", "parquet.summary.metadata.level": "ALL"}),
    ({"row_group_size_mb": 2, "use_summary_metadata": True},
     {"parquet.summary.metadata.level": "NONE"})])
def test_spark_session_conf_calls_equal_jax(tmp_path, kwargs, before, fail):
    results = {}
    for package in PACKAGES:
        unischema, _, metadata = PACKAGES[package]
        schema, session = _row_schema(package), _Session(before)
        url = f"file://{tmp_path}/{package}"
        try:
            with metadata.materialize_dataset(session, url, schema, **kwargs):
                metadata.write_rows(url, schema, _rows(), rows_per_row_group=2)
                if fail:
                    raise KeyError("inside the block")
        except KeyError as exc:
            assert fail and exc.args == ("inside the block",)
        results[package] = (session.calls, session.values, _digests(tmp_path / package))
    assert results["port"] == results["jax"]
    calls, values, files = results["port"]
    assert values == before
    assert calls[:2] == [("get", "parquet.block.size"),
                         ("get", "parquet.summary.metadata.level")]
    assert ("_common_metadata" in files) is not fail
