"""The port's dataset converter (``petastorm_tpu_torch.spark``) on the CPU,
held against ``petastorm_tpu.spark`` on the same seeded tables:

- the cache key of a ``pa.Table``, of the pandas DataFrame it came from and
  of zero-copy slices equals the JAX converter's; the two packages write a
  byte-identical ``part-00000.parquet`` with the same rows per group (each
  package under its own parent directory: the registries and ref-counts
  are per package, so a shared directory would be deleted from under the
  other; one test shares a parent on purpose to show the key and the
  directory are the same);
- the float cast, dedup, ref-counting and ``delete()``;
- ``make_torch_dataloader`` (the reference's ``BatchedDataLoader``) yields
  the JAX converter's torch batches; ``make_torch_device_dataloader`` yields
  the JAX ``make_jax_dataloader``'s batches (compared as numpy), with and
  without ``autotune``;
- ``make_tf_dataset`` is held against the JAX converter's in
  ``tests/test_torch_tf_utils.py``;
- a ``pa.Table`` converts in a fresh interpreter where pandas cannot be
  imported, and no pandas module is loaded.

Tolerance: none; everything is compared exactly.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from petastorm_tpu.spark import dataset_converter as jax_dc
from petastorm_tpu_torch.spark import dataset_converter as port_dc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def parents(tmp_path, monkeypatch):
    """A parent cache directory per package, and empty registries."""
    for dc in (jax_dc, port_dc):
        monkeypatch.setattr(dc, "_parent_cache_dir_url", None)
        monkeypatch.setattr(dc, "_cache_registry", {})
    jax_parent, port_parent = tmp_path / "jax", tmp_path / "port"
    jax_dc.set_parent_cache_dir_url(f"file://{jax_parent}")
    port_dc.set_parent_cache_dir_url(f"file://{port_parent}")
    yield str(jax_parent), str(port_parent)
    jax_dc.set_parent_cache_dir_url(None)
    port_dc.set_parent_cache_dir_url(None)


def _table(rows=240, seed=0):
    """Criteo-like columns: float64 dense, int64 ids, int32 label, a list
    column, strings."""
    rng = np.random.RandomState(seed)
    return pa.table({
        "dense_0": rng.rand(rows),
        "dense_1": rng.randn(rows).astype(np.float32),
        "cat_0": rng.randint(0, 10_000, rows).astype(np.int64),
        "label": rng.randint(0, 2, rows).astype(np.int32),
        "vec": pa.array([rng.rand(3).tolist() for _ in range(rows)]),
        "name": pa.array([f"row-{i}" for i in range(rows)]),
    })


def _part_bytes(converter):
    path = port_dc._local_path(converter.cache_dir_url)
    with open(os.path.join(path, "part-00000.parquet"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", ["float32", None])
@pytest.mark.parametrize("size", [(1 << 20, "snappy"), (2000, "zstd")])
def test_key_and_part_file_equal_the_jax_converter(parents, dtype, size):
    import pyarrow.parquet as pq

    group_bytes, codec = size
    table = _table()
    port = port_dc.make_spark_converter(table, parquet_row_group_size_bytes=group_bytes,
                                        compression_codec=codec, dtype=dtype)
    ref = jax_dc.make_spark_converter(table, parquet_row_group_size_bytes=group_bytes,
                                      compression_codec=codec, dtype=dtype)
    assert os.path.basename(port.cache_dir_url) == os.path.basename(ref.cache_dir_url)
    assert port.cache_dir_url.startswith(f"file://{parents[1]}")
    assert _part_bytes(port) == _part_bytes(ref)
    meta = pq.ParquetFile(os.path.join(port_dc._local_path(port.cache_dir_url),
                                       "part-00000.parquet")).metadata
    groups = [meta.row_group(i).num_rows for i in range(meta.num_row_groups)]
    ref_meta = pq.ParquetFile(os.path.join(port_dc._local_path(ref.cache_dir_url),
                                           "part-00000.parquet")).metadata
    assert groups == [ref_meta.row_group(i).num_rows for i in range(ref_meta.num_row_groups)]
    assert sum(groups) == len(port) == len(ref) == 240
    if group_bytes == 2000:
        assert len(groups) > 1
    port.delete()
    ref.delete()


def test_key_for_table_dataframe_and_slices(parents):
    n = 40
    table = _table(n)
    df = table.drop(["vec"]).to_pandas()
    from_df = pa.Table.from_pandas(df, preserve_index=False)
    for args in ((from_df, 1 << 20, "snappy", "float32"), (table, 1 << 20, "snappy", None)):
        assert port_dc._content_hash(*args) == jax_dc._content_hash(*args)
    port = port_dc.make_spark_converter(df)
    ref = jax_dc.make_spark_converter(df)
    assert os.path.basename(port.cache_dir_url) == os.path.basename(ref.cache_dir_url)
    assert port_dc.make_spark_converter(from_df).cache_dir_url == port.cache_dir_url
    # Zero-copy slices: equal-sized slices of one table must not share a key.
    first, second = table.slice(0, n // 2), table.slice(n // 2)
    keys = [port_dc._content_hash(t, 1 << 20, "snappy", None) for t in (first, second)]
    assert keys[0] != keys[1]
    assert keys == [jax_dc._content_hash(t, 1 << 20, "snappy", None) for t in (first, second)]
    # A slice hashes as the same rows written out fresh.
    fresh = pa.Table.from_pylist(second.to_pylist(), schema=second.schema)
    assert port_dc._content_hash(fresh, 1 << 20, "snappy", None) == keys[1]


def test_one_parent_one_directory_across_packages(tmp_path, monkeypatch):
    """Under one parent the two packages publish the same directory (and
    the second finds it published: no write); each package's registry
    counts only its own converters."""
    for dc in (jax_dc, port_dc):
        monkeypatch.setattr(dc, "_cache_registry", {})
    parent = f"file://{tmp_path}/shared"
    table = _table(60)
    ref = jax_dc.make_spark_converter(table, parent_cache_dir_url=parent)
    stamp = os.stat(os.path.join(port_dc._local_path(ref.cache_dir_url),
                                 "part-00000.parquet")).st_mtime_ns
    port = port_dc.make_spark_converter(table, parent_cache_dir_url=parent)
    assert port.cache_dir_url == ref.cache_dir_url
    assert os.stat(os.path.join(port_dc._local_path(port.cache_dir_url),
                                "part-00000.parquet")).st_mtime_ns == stamp
    assert list(port_dc._cache_registry) == list(jax_dc._cache_registry)
    port.delete()  # the port's last reference: the shared directory goes
    assert not os.path.exists(port_dc._local_path(ref.cache_dir_url))
    ref.delete()


def test_cast_dedup_refcount_and_delete(parents):
    _, port_parent = parents
    table = _table(50)
    c1 = port_dc.make_spark_converter(table)
    c2 = port_dc.make_spark_converter(table)  # same content: same directory
    c3 = port_dc.make_spark_converter(_table(60))
    c4 = port_dc.make_spark_converter(table, dtype=None)  # other options: other key
    assert c1.cache_dir_url == c2.cache_dir_url
    assert len({c1.cache_dir_url, c3.cache_dir_url, c4.cache_dir_url}) == 3
    assert len(os.listdir(port_parent)) == 3 and (len(c1), len(c3)) == (50, 60)
    import pyarrow.parquet as pq

    schema = pq.read_schema(os.path.join(port_dc._local_path(c1.cache_dir_url),
                                         "part-00000.parquet"))
    assert str(schema.field("dense_0").type) == "float"  # float64 cast
    assert str(schema.field("cat_0").type) == "int64"   # ints untouched
    assert schema.field("vec").type.value_type == pa.float64()  # nested: as is
    assert str(pq.read_schema(os.path.join(port_dc._local_path(c4.cache_dir_url),
                                           "part-00000.parquet")).field("dense_0").type) \
        == "double"
    c1.delete()
    assert len(os.listdir(port_parent)) == 3  # c2 still holds it
    c2.delete()
    assert len(os.listdir(port_parent)) == 2
    for c in (c3, c4):
        c.delete()
    assert os.listdir(port_parent) == []
    assert port_dc.SparkDatasetConverter is port_dc.DatasetConverter
    assert port_dc.SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF == \
        jax_dc.SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF


def test_requires_a_parent_directory(monkeypatch):
    monkeypatch.setattr(port_dc, "_parent_cache_dir_url", None)
    monkeypatch.delenv("PETASTORM_TPU_CACHE_DIR", raising=False)
    with pytest.raises(ValueError, match="No cache directory configured"):
        port_dc.make_spark_converter(_table(10))
    with pytest.raises(TypeError, match="Unsupported input"):
        port_dc.make_spark_converter([1, 2], parent_cache_dir_url="file:///nowhere")


def test_environment_parent(tmp_path, monkeypatch):
    monkeypatch.setattr(port_dc, "_parent_cache_dir_url", None)
    monkeypatch.setattr(port_dc, "_cache_registry", {})
    monkeypatch.setenv("PETASTORM_TPU_CACHE_DIR", f"file://{tmp_path}/env")
    conv = port_dc.make_spark_converter(_table(10))
    assert conv.cache_dir_url.startswith(f"file://{tmp_path}/env/cache-")
    conv.delete()


def _numeric(rows):
    return _table(rows).drop(["vec", "name"])


def test_make_torch_dataloader_equals_the_jax_converters(parents):
    table = _numeric(90)
    port = port_dc.make_spark_converter(table)
    ref = jax_dc.make_spark_converter(table)
    kw = dict(batch_size=16, num_epochs=1, shuffle_row_groups=False, workers_count=1)
    with port.make_torch_dataloader(device="cpu", **kw) as loader:
        got = list(loader)
    with ref.make_torch_dataloader(**kw) as loader:
        want = list(loader)
    assert len(got) == len(want) == 6  # 90 rows: five of 16 and one of 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            assert torch.is_tensor(g[name]) and g[name].dtype == w[name].dtype
            assert torch.equal(g[name], w[name]), name
    port.delete()
    ref.delete()


#: The autotuned case pins workers_count to 1 (its bounds): more decode
#: workers would publish row groups in either order.
@pytest.mark.parametrize("autotune", [None, {"interval_s": 0.01, "hysteresis": 1,
                                             "bounds": {"workers_count": (1, 1)}}])
def test_device_loader_equals_make_jax_dataloader(parents, autotune):
    table = _numeric(200)
    port = port_dc.make_spark_converter(table, parquet_row_group_size_bytes=2000)
    ref = jax_dc.make_spark_converter(table, parquet_row_group_size_bytes=2000)
    reader_kw = dict(num_epochs=2, shuffle_row_groups=True, shard_seed=3, workers_count=1)
    with port.make_torch_device_dataloader(
            batch_size=24, loader_kwargs=dict(device="cpu", last_batch="keep",
                                              autotune=autotune), **reader_kw) as loader:
        got = [{k: v.numpy() for k, v in b.items()} for b in loader]
        tuned = loader.autotune
    with ref.make_jax_dataloader(
            batch_size=24, loader_kwargs=dict(stage_to_device=False, last_batch="keep",
                                              autotune=autotune), **reader_kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    assert len(got) == len(want) == 17  # 400 rows: 16 of 24 and one of 16
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            assert g[name].dtype == w[name].dtype and np.array_equal(g[name], w[name]), name
    assert (tuned is None) == (autotune is None)
    if tuned is not None:
        assert not tuned.running and "workers_count" in tuned.knob_values()
    port.delete()
    ref.delete()


def test_arrow_table_conversion_imports_no_pandas(tmp_path):
    """Converting a ``pa.Table`` needs no pandas. pyarrow imports pandas on
    its own when pandas is installed (building a table from numpy arrays
    does), so the interpreter is made a host without pandas: any import of
    it fails. (Reading the store back is left out here: this host's pyarrow
    needs pandas for ``DataType.to_pandas_dtype``, which the batch reader's
    schema inference calls.)"""
    code = textwrap.dedent(f"""
        import os, sys

        class NoPandas:
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] == "pandas":
                    raise ImportError("no pandas on this host")

        sys.meta_path.insert(0, NoPandas())
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from petastorm_tpu_torch.spark import make_spark_converter
        table = pa.table({{"x": np.arange(40, dtype=np.float64),
                          "y": np.arange(40, dtype=np.int64)}})
        conv = make_spark_converter(table, parent_cache_dir_url="file://{tmp_path}/c")
        again = make_spark_converter(table, parent_cache_dir_url="file://{tmp_path}/c")
        back = pq.read_table(os.path.join(conv.cache_dir_url[7:], "part-00000.parquet"))
        assert again.cache_dir_url == conv.cache_dir_url and len(conv) == 40
        assert back.column("y").to_pylist() == list(range(40))
        assert str(back.schema.field("x").type) == "float"
        conv.delete()
        again.delete()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("pandas", "jax", "petastorm_tpu"))
        print("LOADED", bad, os.path.exists(conv.cache_dir_url[7:]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] False" in out.stdout, out.stdout
