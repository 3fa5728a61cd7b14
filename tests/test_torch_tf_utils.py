"""The port's TensorFlow adapters against the JAX package's, on the same inputs.

Each case of ``tests/test_adapters.py``'s TF half runs through both
packages' ``tf_utils`` and the datasets must be element-wise equal (field
names, dtypes, shapes and values):

- the dtype promotions (uint16 → int32, uint32 / uint64 → int64, Decimal →
  string, datetime64 → int64 epoch ns) over a ``ReaderMock``;
- a row reader, a batch reader then ``unbatch().batch(4)``, a columnar
  reader and an NGram reader over one seeded store;
- a None value raises ValueError in both;
- ``tf_tensors`` with a shuffle buffer delivers the same multiset of rows;
- the dataset converter's ``make_tf_dataset``.

TensorFlow is imported by the tests, never by the package
(``test_importing_the_port_loads_no_tensorflow``).

Tolerance: none; every value is compared exactly.
"""

import os
import subprocess
import sys
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu import tf_utils as jax_tf
from petastorm_tpu_torch import tf_utils as port_tf

tf = pytest.importorskip("tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, GROUP = 40, 10


def _packages():
    """``{package: (unischema, codecs, ReaderMock, NGram, tf_utils, reader)}``:
    each package's modules and classes."""
    from petastorm_tpu.ngram import NGram as JaxNGram
    from petastorm_tpu.schema import codecs as jax_codecs
    from petastorm_tpu.schema import unischema as jax_unischema
    from petastorm_tpu.test_util.reader_mock import ReaderMock as JaxMock
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.schema import codecs
    from petastorm_tpu_torch.schema import unischema
    from petastorm_tpu_torch.test_util.reader_mock import ReaderMock

    return {"port": (unischema, codecs, ReaderMock, NGram, port_tf, port_reader_mod),
            "jax": (jax_unischema, jax_codecs, JaxMock, JaxNGram, jax_tf, jax_reader_mod)}


def _adapter_schema(unischema, codecs):
    field = unischema.UnischemaField
    return unischema.Unischema("AdapterSchema", [
        field("id", np.int64, (), codecs.ScalarCodec(), False),
        field("mat", np.float32, (2, 3), None, False),
        field("counts", np.uint16, (4,), None, False),
        field("big", np.uint32, (), None, False),
        field("huge", np.uint64, (2,), None, False),
        field("name", str, (), codecs.ScalarCodec(), False),
        field("blob", bytes, (), codecs.ScalarCodec(), False),
        field("price", Decimal, (), codecs.ScalarCodec(), False),
        field("stamp", np.dtype("datetime64[us]"), (), None, False),
        field("maybe", np.float64, (), None, True)])


def _adapter_row(i):
    return {"id": np.int64(i), "mat": np.full((2, 3), i + 0.5, dtype=np.float32),
            "counts": np.arange(4, dtype=np.uint16) + 60000,
            "big": np.uint32(4_000_000_000 + i), "huge": np.array([i, 2**63 - 1], np.uint64),
            "name": f"row_{i}", "blob": bytes([i, 255 - i]), "price": Decimal(f"{i}.5"),
            "stamp": np.datetime64("2026-10-18T08:00:00", "us") + np.timedelta64(i, "s"),
            "maybe": float(i)}


def _numpy(element):
    """A dataset element as ``(field, numpy value)`` pairs (or a dict of
    them for NGram windows)."""
    if isinstance(element, dict):
        return {offset: _numpy(step) for offset, step in sorted(element.items())}
    return tuple((name, np.asarray(value.numpy()))
                 for name, value in zip(element._fields, element))


def _assert_equal(port, jax):
    """Element lists equal field for field: names, dtypes, shapes, values."""
    assert len(port) == len(jax) > 0
    for got, want in zip(port, jax):
        if isinstance(want, dict):
            assert list(got) == list(want)
            _assert_equal([got[k] for k in got], [want[k] for k in want])
            continue
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _dataset(package, reader):
    return [_numpy(e) for e in _packages()[package][4].make_petastorm_dataset(reader)]


# ---------------------------------------------------------------------------
# ReaderMock cases
# ---------------------------------------------------------------------------

def test_dtype_promotions_equal_jax():
    dtypes = {}
    for package, (unischema, codecs, *_rest) in _packages().items():
        module = _packages()[package][4]
        dtypes[package] = module._schema_to_tf_dtypes(_adapter_schema(unischema, codecs))
    assert dtypes["port"] == dtypes["jax"]
    assert [dtypes["port"][n] for n in ("counts", "big", "huge", "price", "stamp", "blob")] == \
        [tf.int32, tf.int64, tf.int64, tf.string, tf.int64, tf.string]


@pytest.mark.parametrize("batched", [False, True], ids=["rows", "rebatched"])
def test_reader_mock_rows_equal_jax(batched):
    """Rows through the promotions, one element a row or batched by 3."""
    out = {}
    for package, (unischema, codecs, mock, *_rest) in _packages().items():
        dataset = _packages()[package][4].make_petastorm_dataset(
            mock(_adapter_schema(unischema, codecs), _adapter_row, num_rows=9))
        out[package] = [_numpy(e) for e in (dataset.batch(3) if batched else dataset)]
    _assert_equal(out["port"], out["jax"])
    first = dict(out["port"][0])
    assert first["stamp"].dtype == np.int64 and first["counts"].dtype == np.int32
    if not batched:
        assert first["price"] == b"0.5"
        assert first["stamp"] == np.datetime64("2026-10-18T08:00:00", "ns").astype(np.int64)


def test_a_none_value_raises_value_error_in_both():
    for package, (unischema, codecs, mock, *_rest) in _packages().items():
        module = _packages()[package][4]
        schema = _adapter_schema(unischema, codecs)
        with pytest.raises(ValueError, match="cannot carry nulls"):
            module._coerce_value(schema.fields["maybe"], None, tf.float64)
        reader = mock(schema, lambda i: dict(_adapter_row(i), maybe=None), num_rows=2)
        with pytest.raises(Exception, match="cannot carry nulls"):
            list(module.make_petastorm_dataset(reader))


def test_tf_tensors_shuffle_delivers_the_jax_multiset():
    ids = {}
    for package, (unischema, codecs, mock, *_rest) in _packages().items():
        it = _packages()[package][4].tf_tensors(
            mock(_adapter_schema(unischema, codecs), _adapter_row, num_rows=20),
            shuffling_queue_capacity=10, min_after_dequeue=4)
        ids[package] = sorted(int(row.id.numpy()) for row in it)
    assert ids["port"] == ids["jax"] == list(range(20))


# ---------------------------------------------------------------------------
# real readers over one store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A petastorm store of 40 rows in row groups of 10, written by the
    port, and a plain Parquet store of the same rows."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    root = tmp_path_factory.mktemp("tf")
    schema = Unischema("TfStore", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("ts", np.int64, (), ScalarCodec(), False),
        UnischemaField("mat", np.float32, (2, 3), NdarrayCodec(), False),
        UnischemaField("counts", np.uint16, (4,), NdarrayCodec(), False),
        UnischemaField("name", str, (), ScalarCodec(), False)])
    rng = np.random.RandomState(11)
    rows = [{"id": i, "ts": 10 * i, "mat": rng.rand(2, 3).astype(np.float32),
             "counts": rng.randint(0, 65535, 4).astype(np.uint16), "name": f"n{i}"}
            for i in range(ROWS)]
    materialize_rows(f"file://{root}/petastorm", schema, rows, rows_per_row_group=GROUP)
    plain = pa.table({"id": np.arange(ROWS, dtype=np.int64),
                      "value": rng.rand(ROWS).astype(np.float32),
                      "big": (rng.randint(0, 2**31, ROWS).astype(np.uint32) * 2),
                      "label": pa.array([f"l{i % 3}" for i in range(ROWS)])})
    os.makedirs(root / "plain")
    pq.write_table(plain, root / "plain" / "part-0.parquet", row_group_size=GROUP)
    return {"petastorm": f"file://{root}/petastorm", "plain": f"file://{root}/plain"}


READS = {
    "row": ("make_reader", "petastorm", dict(schema_fields=["id", "mat", "counts", "name"])),
    "batch": ("make_batch_reader", "plain", {}),
    "columnar": ("make_columnar_reader", "petastorm", dict(schema_fields=["id", "mat"])),
}


@pytest.mark.parametrize("case", list(READS))
def test_readers_give_the_jax_datasets(store, case):
    factory, which, kwargs = READS[case]
    out = {}
    for package in ("port", "jax"):
        reader = getattr(_packages()[package][5], factory)(
            store[which], reader_pool_type="dummy", shuffle_row_groups=True, shard_seed=2,
            **kwargs)
        with reader:
            dataset = _packages()[package][4].make_petastorm_dataset(reader)
            if case == "batch":
                dataset = dataset.unbatch().batch(4)
            out[package] = [_numpy(e) for e in dataset]
    _assert_equal(out["port"], out["jax"])
    assert len(out["port"]) == (ROWS // 4 if case == "batch" else
                                ROWS if case == "row" else ROWS // GROUP)


def test_ngram_windows_equal_jax(store):
    out = {}
    for package in ("port", "jax"):
        ngram = _packages()[package][3]({0: ["^id$", "^mat$"], 1: ["^id$", "^name$"]},
                                        delta_threshold=10, timestamp_field="ts")
        reader = _packages()[package][5].make_reader(
            store["petastorm"], schema_fields=ngram, reader_pool_type="dummy",
            shuffle_row_groups=False)
        with reader:
            out[package] = _dataset(package, reader)
    _assert_equal(out["port"], out["jax"])
    window = out["port"][0]
    assert list(window) == [0, 1] and dict(window[1])["id"] == dict(window[0])["id"] + 1


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

@pytest.fixture
def parents(tmp_path, monkeypatch):
    """A parent cache directory per package, and empty registries."""
    from petastorm_tpu.spark import dataset_converter as jax_dc
    from petastorm_tpu_torch.spark import dataset_converter as port_dc

    for dc in (jax_dc, port_dc):
        monkeypatch.setattr(dc, "_parent_cache_dir_url", None)
        monkeypatch.setattr(dc, "_cache_registry", {})
    jax_dc.set_parent_cache_dir_url(f"file://{tmp_path}/jax")
    port_dc.set_parent_cache_dir_url(f"file://{tmp_path}/port")
    yield {"jax": jax_dc, "port": port_dc}
    jax_dc.set_parent_cache_dir_url(None)
    port_dc.set_parent_cache_dir_url(None)


@pytest.mark.parametrize("batch_size", [None, 6])
def test_converter_make_tf_dataset_equals_jax(parents, batch_size):
    rng = np.random.RandomState(5)
    table = pa.table({"x": rng.rand(30), "k": rng.randint(0, 9, 30).astype(np.int64),
                      "s": pa.array([f"r{i}" for i in range(30)])})
    out = {}
    for package, dc in parents.items():
        converter = dc.make_spark_converter(table)
        with converter.make_tf_dataset(batch_size=batch_size, num_epochs=1,
                                       shuffle_row_groups=False,
                                       reader_pool_type="dummy") as dataset:
            out[package] = [_numpy(e) for e in dataset]
        converter.delete()
    _assert_equal(out["port"], out["jax"])
    assert sum(len(dict(e)["x"]) for e in out["port"]) == 30


def test_importing_the_port_loads_no_tensorflow():
    code = ("import sys, petastorm_tpu_torch, petastorm_tpu_torch.tf_utils, "
            "petastorm_tpu_torch.spark.dataset_converter; "
            "assert 'tensorflow' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
