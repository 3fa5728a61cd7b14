"""The port's row-group indexes, selectors and restricted unpicklers
against the JAX package's, on stores the port writes from seeded numpy
data:

- ``SingleFieldIndexer`` / ``FieldNotNullIndexer`` built by either package
  hold the same index, and each package reads the index the other built
  (the port through its restricted unpickler, as its own classes);
- ``SingleIndexSelector`` / ``IntersectIndexSelector`` /
  ``UnionIndexSelector`` select the same row groups and have the same
  ``repr`` in both packages;
- a fresh interpreter loads a JAX-built index and a reference-pickled
  schema through the port without importing ``petastorm_tpu`` or ``jax``;
- the unpicklers refuse classes outside their maps and numpy's gadgets;
- the JAX metadata tests' reference-pickle bytes decode to the same
  Unischema in both packages, and ``get_schema`` falls back to them.

Tolerance: none; everything is compared exactly.
"""

import io
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow.fs as pafs
import pytest

from petastorm_tpu import selectors as jax_selectors
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu_torch import selectors as port_selectors
from petastorm_tpu_torch.etl import rowgroup_indexers as port_indexers
from petastorm_tpu_torch.etl import rowgroup_indexing as port_indexing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, GROUP = 120, 20  # 6 row groups


def write_store(url, rows=ROWS, group=GROUP, seed=3):
    """A petastorm store written by the port: idx, digit, part (string),
    maybe (nullable int, null in whole row groups), image (png)."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("IndexSchema", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("digit", np.int64, (), ScalarCodec(), False),
        UnischemaField("part", str, (), ScalarCodec(), False),
        UnischemaField("maybe", np.int32, (), ScalarCodec(), True),
        UnischemaField("image", np.uint8, (8, 8), CompressedImageCodec("png"), False),
    ])
    rng = np.random.RandomState(seed)
    materialize_rows(url, schema, ({
        "idx": i, "digit": int(rng.randint(0, 10)), "part": f"p{i // 30}",
        "maybe": None if (i // group) % 3 == 1 else i % 7,
        "image": rng.randint(0, 256, (8, 8), dtype=np.uint8)} for i in range(rows)),
        rows_per_row_group=group)
    return url


def _indexers(m):
    return [m.SingleFieldIndexer("by_digit", "digit"), m.SingleFieldIndexer("by_part", "part"),
            m.FieldNotNullIndexer("maybe_not_null", "maybe")]


def _summary(index_dict):
    """Every indexer's class name, values and row-group sets."""
    out = {}
    for name, indexer in index_dict.items():
        if hasattr(indexer, "indexed_values"):
            out[name] = (type(indexer).__name__,
                         {str(v): indexer.get_row_group_indexes(v)
                          for v in indexer.indexed_values})
        else:
            out[name] = (type(indexer).__name__, indexer.get_row_group_indexes())
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Two identical stores: one indexed by the port, one by the JAX package."""
    base = tmp_path_factory.mktemp("rg_index")
    port_url = write_store(f"file://{base}/port")
    jax_url = write_store(f"file://{base}/jax")
    port_indexing.build_rowgroup_index(port_url, _indexers(port_indexers))
    jax_indexing.build_rowgroup_index(jax_url, _indexers(jax_indexers))
    return {"port": port_url, "jax": jax_url}


def _load(package, url):
    path = url[len("file://"):]
    if package == "port":
        return port_indexing.get_row_group_indexes(pafs.LocalFileSystem(), path)
    return jax_indexing.get_row_group_indexes(pafs.LocalFileSystem(), path)


def test_both_packages_build_the_same_index(stores):
    port, jax = _load("port", stores["port"]), _load("jax", stores["jax"])
    assert _summary(port) == _summary(jax)
    assert _summary(port)["maybe_not_null"][1] == {0, 2, 3, 5}
    assert _summary(port)["by_part"][1]["p1"] == {1, 2}


@pytest.mark.parametrize("reader,built_by", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_index_the_other_built(stores, reader, built_by):
    got = _load(reader, stores[built_by])
    assert _summary(got) == _summary(_load(built_by, stores[built_by]))
    if reader == "port":
        assert all(type(i).__module__ == "petastorm_tpu_torch.etl.rowgroup_indexers"
                   for i in got.values())


def _selector(name, m):
    single = m.SingleIndexSelector
    return {
        "single": lambda: single("by_digit", [3, 7]),
        "single_strings": lambda: single("by_part", ["p0", "p3"]),
        "intersect": lambda: m.IntersectIndexSelector(
            [single("by_part", ["p1", "p2"]), single("by_digit", [0])]),
        "union": lambda: m.UnionIndexSelector(
            [single("by_part", ["p0"]), single("maybe_not_null", [None])]),
        "empty_intersect": lambda: m.IntersectIndexSelector([]),
    }[name]()


@pytest.mark.parametrize("name", ["single", "single_strings", "intersect", "union",
                                  "empty_intersect"])
def test_selectors_select_like_jax(stores, name):
    port, jax = _selector(name, port_selectors), _selector(name, jax_selectors)
    assert repr(port) == repr(jax)
    index = _load("port", stores["port"])
    assert port.select_row_groups(index) == jax.select_row_groups(_load("jax", stores["jax"]))
    assert port.get_index_names() == jax.get_index_names()


def test_selector_missing_index_raises(stores):
    with pytest.raises(ValueError, match="no rowgroup index named 'nope'"):
        port_selectors.SingleIndexSelector("nope", [1]).select_row_groups(
            _load("port", stores["port"]))


def _reference_pickle():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from test_etl_metadata import _fabricate_reference_pickle
    finally:
        sys.path.remove(os.path.join(REPO, "tests"))
    return _fabricate_reference_pickle()


def _field_tuples(schema):
    return [(f.name, np.dtype(f.numpy_dtype).str, tuple(f.shape), type(f.codec).__name__,
             str(getattr(f.codec, "arrow_dtype", lambda: None)()), f.nullable)
            for f in schema.fields.values()]


def test_reference_pickle_decodes_to_the_jax_unischema():
    from petastorm_tpu.etl.metadata import unischema_from_reference_pickle as jax_unpickle
    from petastorm_tpu_torch.etl.metadata import unischema_from_reference_pickle

    payload = _reference_pickle()
    got = unischema_from_reference_pickle(payload)
    assert _field_tuples(got) == _field_tuples(jax_unpickle(payload))
    assert [f[:4] for f in _field_tuples(got)] == [
        ("id", "<i4", (), "ScalarCodec"), ("emb", "<f8", (3,), "NdarrayCodec")]
    assert got.fields["emb"].nullable and str(got.fields["id"].codec.arrow_dtype()) == "int32"


def test_get_schema_falls_back_to_the_reference_pickle(tmp_path):
    from petastorm_tpu_torch.etl.metadata import (
        UNISCHEMA_JSON_KEY,
        UNISCHEMA_KEY,
        add_to_dataset_metadata,
        get_schema,
        read_dataset_metadata,
    )
    import pyarrow.parquet as pq

    path = str(tmp_path / "refds")
    os.makedirs(path)
    pq.write_table(__import__("pyarrow").table({"id": [1, 2]}), f"{path}/part-0.parquet")
    fs = pafs.LocalFileSystem()
    add_to_dataset_metadata(fs, path, UNISCHEMA_KEY, _reference_pickle())
    assert UNISCHEMA_JSON_KEY not in read_dataset_metadata(fs, path)
    assert list(get_schema(fs, path).fields) == ["id", "emb"]


def test_port_loads_jax_index_and_reference_schema_without_the_jax_package(stores, tmp_path):
    payload_file = tmp_path / "ref.pickle"
    payload_file.write_bytes(_reference_pickle())
    code = textwrap.dedent(f"""
        import sys
        import pyarrow.fs as pafs
        from petastorm_tpu_torch.etl.metadata import unischema_from_reference_pickle
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
        from petastorm_tpu_torch.selectors import SingleIndexSelector
        index = get_row_group_indexes(pafs.LocalFileSystem(), {stores['jax'][7:]!r})
        schema = unischema_from_reference_pickle(open({str(payload_file)!r}, "rb").read())
        print("SELECTED", sorted(SingleIndexSelector("by_part", ["p0"]).select_row_groups(index)))
        print("FIELDS", list(schema.fields))
        print("LOADED", sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "petastorm_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "SELECTED [0, 1]" in out.stdout and "FIELDS ['id', 'emb']" in out.stdout
    assert "LOADED []" in out.stdout, out.stdout


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload", ["os_system", "bytesio", "numpy_save", "eval"])
def test_unpicklers_refuse_classes_outside_their_maps(payload):
    from petastorm_tpu_torch.etl.metadata import unischema_from_reference_pickle

    data = {
        "os_system": pickle.dumps(_Evil()),
        "bytesio": pickle.dumps(io.BytesIO()),
        "numpy_save": b"cnumpy\nsave\n.",
        "eval": b"cbuiltins\neval\n.",
    }[payload]
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        port_indexing.load_index_store(data)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        unischema_from_reference_pickle(data)


def test_numpy_gadgets_are_refused_and_machinery_allowed():
    from petastorm_tpu_torch.etl.metadata import _RestrictedUnpickler

    up = _RestrictedUnpickler(io.BytesIO(b""))
    for gadget in ("save", "savetxt", "load", "fromfile", "frombuffer"):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            up.find_class("numpy", gadget)
    assert up.find_class("numpy", "dtype") is np.dtype
    store = port_indexing.load_index_store(pickle.dumps({np.int64(3): {1}, "k": np.float32(2)}))
    assert store == {3: {1}, "k": 2.0}


def test_index_store_missing_raises(tmp_path):
    from petastorm_tpu_torch.errors import PetastormMetadataError

    url = write_store(f"file://{tmp_path}/plain", rows=40)
    with pytest.raises(PetastormMetadataError, match="no rowgroup index"):
        _load("port", url)
    with pytest.raises(ValueError, match="not in schema"):
        port_indexing.build_rowgroup_index(
            url, [port_indexers.SingleFieldIndexer("x", "no_such_field")])
