"""``hdfs://`` through the port's namenode failover against the JAX package's.

Neither package binds libhdfs itself: both look ``pyarrow.fs.HadoopFileSystem``
up at call time. Here a stand-in takes its place (``monkeypatch``). It
records each ``(host, port, user)`` it is asked for, fails for the
namenodes a test names, and otherwise returns a ``SubTreeFileSystem`` over a
directory under ``tmp_path``, where the store lives. The Hadoop
configuration comes from ``core-site.xml`` / ``hdfs-site.xml`` under
``$HADOOP_CONF_DIR`` (written under ``tmp_path``): ``fs.defaultFS`` is
``hdfs://ns1``, whose HA namenodes are ``host1:8020``, ``host2:8020`` and
``host3:8020``; ``ns2`` names none.

- Each URL form (a nameservice, ``fs.defaultFS``, a ``host:port``, a dotted
  host) reaches the same connection attempts in both packages, in the same
  order, and the same path.
- A failing first namenode fails over to the second; only
  ``MAX_NAMENODES`` (2) are tried; all failing raise ``MaxFailoversExceeded``
  with the same failure count; a failing single namenode raises
  ``HdfsConnectError``; an unknown nameservice raises before any attempt.
- The three reader factories over ``hdfs://ns1/...`` deliver the JAX
  readers' rows, and ``build_rowgroup_index``, ``global_step_count``,
  ``get_schema_from_dataset_url`` and ``copy_dataset`` work over it as in
  the JAX package.

Tolerance: none; rows, calls and errors are compared exactly.
"""

import numpy as np
import pyarrow.fs as pafs
import pytest

import petastorm_tpu.fs_utils as jax_fs_utils
import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.fs_utils as port_fs_utils
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu.hdfs import namenode as jax_namenode
from petastorm_tpu_torch.hdfs import namenode as port_namenode

FACTORIES = ["make_reader", "make_columnar_reader", "make_batch_reader"]
ROWS, GROUP = 40, 10
PACKAGES = {"port": (port_fs_utils, port_namenode), "jax": (jax_fs_utils, jax_namenode)}


def _site(path, props):
    body = "".join(f"<property><name>{k}</name><value>{v}</value></property>"
                   for k, v in props.items())
    path.write_text(f"<?xml version='1.0'?><configuration>{body}</configuration>")


class FakeHdfs:
    """Stands in for ``pyarrow.fs.HadoopFileSystem``: records each call,
    raises ``OSError`` for the hosts in ``failing``."""

    def __init__(self, root):
        self.root, self.calls, self.failing = str(root), [], set()

    def __call__(self, host, port=8020, user=None, **kwargs):
        self.calls.append((host, port, user))
        if host in self.failing:
            raise OSError(f"connection refused by {host}:{port}")
        return pafs.SubTreeFileSystem(self.root, pafs.LocalFileSystem())


@pytest.fixture
def hdfs(tmp_path, monkeypatch):
    conf = tmp_path / "conf"
    conf.mkdir()
    _site(conf / "core-site.xml", {"fs.defaultFS": "hdfs://ns1"})
    _site(conf / "hdfs-site.xml", {
        "dfs.nameservices": "ns1,ns2", "dfs.ha.namenodes.ns1": "nn1,nn2,nn3",
        "dfs.namenode.rpc-address.ns1.nn1": "host1:8020",
        "dfs.namenode.rpc-address.ns1.nn2": "host2:8020",
        "dfs.namenode.rpc-address.ns1.nn3": "host3:8020",
        "dfs.ha.namenodes.ns2": "nn1"})
    for env in ("HADOOP_HOME", "HADOOP_PREFIX", "HADOOP_INSTALL"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf))
    (tmp_path / "hdfs").mkdir()
    fake = FakeHdfs(tmp_path / "hdfs")
    monkeypatch.setattr(pafs, "HadoopFileSystem", fake)
    return fake


def _store(root):
    """A petastorm store of 40 rows in row groups of 10 at
    ``root/data/ds``, written by the port."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("HdfsSchema", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("vec", np.float32, (3,), NdarrayCodec(), False)])
    rng = np.random.RandomState(7)
    materialize_rows(f"file://{root}/data/ds", schema,
                     ({"idx": i, "vec": rng.rand(3).astype(np.float32)} for i in range(ROWS)),
                     rows_per_row_group=GROUP)


def _resolve(package, url, fake, **kwargs):
    """``(calls, path, filesystem type)`` of one package's resolver."""
    fake.calls.clear()
    resolver = PACKAGES[package][0].FilesystemResolver(url, **kwargs)
    return list(fake.calls), resolver.get_dataset_path(), type(resolver.filesystem())


@pytest.mark.parametrize("url,calls", [
    ("hdfs://ns1/data/ds", [("host1", 8020, None)]),
    ("hdfs:///data/ds", [("host1", 8020, None)]),
    ("hdfs://nn.example:9000/data/ds", [("nn.example", 9000, None)]),
    ("hdfs://nn.example/data/ds", [("nn.example", 8020, None)])])
def test_hdfs_urls_connect_as_the_jax_package_does(hdfs, url, calls):
    port = _resolve("port", url, hdfs, hdfs_driver="libhdfs3")
    jax = _resolve("jax", url, hdfs, hdfs_driver="libhdfs3")
    assert port == jax == (calls, "/data/ds", pafs.SubTreeFileSystem)
    assert _resolve("port", url, hdfs, user="etl")[0] == \
        _resolve("jax", url, hdfs, user="etl")[0] == [c[:2] + ("etl",) for c in calls]


@pytest.mark.parametrize("url,failing,calls,error,failures", [
    ("hdfs://ns1/d", {"host1"}, ["host1", "host2"], None, 0),
    ("hdfs:///d", {"host1"}, ["host1", "host2"], None, 0),
    ("hdfs://ns1/d", {"host1", "host2"}, ["host1", "host2"], "MaxFailoversExceeded", 2),
    ("hdfs://nn.example:9000/d", {"nn.example"}, ["nn.example"], "HdfsConnectError", 0),
    ("hdfs://ns9/d", set(), [], "HdfsConnectError", 0),
    ("hdfs://ns2/d", set(), [], "HdfsConnectError", 0)])
def test_failover_order_and_errors_equal_jax(hdfs, url, failing, calls, error, failures):
    """The same namenodes tried in the same order, the third never (the
    failover limit), and the same error type with the same failures."""
    hdfs.failing = failing
    outcomes = {}
    for package in PACKAGES:
        hdfs.calls.clear()
        try:
            PACKAGES[package][0].FilesystemResolver(url)
        except Exception as exc:  # noqa: BLE001 - the outcome compared
            outcomes[package] = (list(hdfs.calls), type(exc).__name__,
                                 len(getattr(exc, "failed_exceptions", ())))
            assert isinstance(exc, getattr(PACKAGES[package][1], type(exc).__name__))
        else:
            outcomes[package] = (list(hdfs.calls), None, 0)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"] == ([(host, 9000 if ":9000" in url else 8020, None)
                                 for host in calls], error, failures)
    assert port_namenode.HdfsConnector.MAX_NAMENODES == jax_namenode.HdfsConnector.MAX_NAMENODES


def test_connector_class_methods_equal_jax(hdfs):
    from urllib.parse import urlparse

    hdfs.failing = {"a"}
    for package in PACKAGES:
        connector = PACKAGES[package][1].HdfsConnector
        hdfs.calls.clear()
        assert isinstance(connector.connect_to_either_namenode(["a:1", "b", "c:3"], user="u"),
                          pafs.SubTreeFileSystem)
        assert hdfs.calls == [("a", 1, "u"), ("b", 8020, "u")]
        with pytest.raises(PACKAGES[package][1].HdfsConnectError, match="a:8020"):
            connector.hdfs_connect_namenode(urlparse("hdfs://a/x"), driver="libhdfs3")
        fs, path = PACKAGES[package][1].connect_hdfs(urlparse("hdfs://b:7/p/q"))
        assert path == "/p/q" and hdfs.calls[-1] == ("b", 7, None)


def _rows(reader):
    with reader:
        out = []
        for item in reader:
            item = item._asdict()
            if np.ndim(item["idx"]):  # a column batch: one dict a row
                out.extend({k: v[i] for k, v in item.items()} for i in range(len(item["idx"])))
            else:
                out.append(item)
    return out


@pytest.mark.parametrize("factory", FACTORIES)
def test_readers_over_hdfs_deliver_the_jax_rows(hdfs, tmp_path, factory):
    """``hdfs://ns1/data/ds`` with the first namenode down: each package
    fails over to the second and reads the JAX reader's rows in its
    order."""
    _store(tmp_path / "hdfs")
    hdfs.failing = {"host1"}
    rows = {}
    for package, module in (("port", port_reader_mod), ("jax", jax_reader_mod)):
        hdfs.calls.clear()
        rows[package] = _rows(getattr(module, factory)(
            "hdfs://ns1/data/ds", reader_pool_type="dummy", shuffle_row_groups=True,
            shard_seed=3, hdfs_driver="libhdfs3"))
        assert [c[0] for c in hdfs.calls][:2] == ["host1", "host2"]
    assert len(rows["port"]) == len(rows["jax"]) == ROWS
    for got, want in zip(rows["port"], rows["jax"]):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def test_etl_entry_points_over_hdfs_equal_jax(hdfs, tmp_path):
    """``get_schema_from_dataset_url``, ``global_step_count`` and
    ``build_rowgroup_index`` over ``hdfs://``, and ``copy_dataset`` from
    it, give the JAX results."""
    from petastorm_tpu.etl import metadata as jax_metadata
    from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
    from petastorm_tpu.etl.rowgroup_indexers import SingleFieldIndexer as JaxIndexer
    from petastorm_tpu.jax_utils.sharding import global_step_count as jax_steps
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jax_copy
    from petastorm_tpu_torch.etl import metadata
    from petastorm_tpu_torch.etl import rowgroup_indexing
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    from petastorm_tpu_torch.torch_utils.sharding import global_step_count

    _store(tmp_path / "hdfs")
    url = "hdfs://ns1/data/ds"
    port_schema = metadata.get_schema_from_dataset_url(url, hdfs_driver="libhdfs3")
    jax_schema = jax_metadata.get_schema_from_dataset_url(url, hdfs_driver="libhdfs3")
    assert list(port_schema.fields) == list(jax_schema.fields) == ["idx", "vec"]
    for shards in (1, 3):
        assert global_step_count(url, 7, shards, hdfs_driver="libhdfs3") == \
            jax_steps(url, 7, shards, hdfs_driver="libhdfs3")
    port_index = rowgroup_indexing.build_rowgroup_index(url, [SingleFieldIndexer("by_idx", "idx")])
    jax_index = jax_indexing.build_rowgroup_index(url, [JaxIndexer("by_idx", "idx")])
    assert port_index["by_idx"].get_row_group_indexes(5) == \
        jax_index["by_idx"].get_row_group_indexes(5) == {0}
    copy_dataset(None, url, f"file://{tmp_path}/port_copy", rows_per_row_group=5,
                 hdfs_driver="libhdfs3")
    jax_copy(None, url, f"file://{tmp_path}/jax_copy", rows_per_row_group=5,
             hdfs_driver="libhdfs3")
    for name in ("part-00000.parquet", "_common_metadata"):
        assert (tmp_path / "port_copy" / name).read_bytes() == \
            (tmp_path / "jax_copy" / name).read_bytes()
