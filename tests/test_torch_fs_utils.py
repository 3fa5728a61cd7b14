"""The port's remote-filesystem layer against the JAX package's.

- ``FilesystemResolver``: the filesystem type and path for local paths,
  ``file://``, fsspec's ``memory://`` with ``storage_options``, a caller's
  pyarrow or fsspec ``filesystem``, and the ``s3a`` / ``s3n`` / ``gcs``
  renames (through fake ``s3`` / ``gs`` protocols: nothing leaves the
  host); ``get_filesystem_and_path_or_paths`` and ``get_dataset_path``
  (``hdfs://`` connections are held in ``tests/test_torch_hdfs.py``).
- GCS fast listing against a fake ``gs`` protocol: one ``find`` sweep,
  the same directory cache and wrapper answers as the JAX helpers, a
  reader over ``gs://`` through one sweep, and the sweep's retries.
- ``HdfsNamenodeResolver`` on Hadoop XML files written under ``tmp_path``.
- ``retry_with_backoff`` / ``backoff_delays``: the same delays, deadline
  and budget behaviour under injected sleep, rng and clock.
- ``piece_indices`` on the three factories, row for row against JAX's.
- A ``memory://`` store written and read by both packages.

Tolerance: none; everything is compared exactly.
"""

import os
import random
import uuid

import numpy as np
import pyarrow.fs as pafs
import pytest

import petastorm_tpu.fs_utils as jax_fs_utils
import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.fs_utils as port_fs_utils
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu import utils as jax_utils
from petastorm_tpu.gcsfs_helpers import gcsfs_fast_list as jax_fast
from petastorm_tpu.hdfs import namenode as jax_namenode
from petastorm_tpu_torch import utils as port_utils
from petastorm_tpu_torch.gcsfs_helpers import gcsfs_fast_list as port_fast
from petastorm_tpu_torch.hdfs import namenode as port_namenode

FACTORIES = ["make_reader", "make_columnar_reader", "make_batch_reader"]
ROWS, GROUP = 60, 10  # 6 row groups


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A petastorm store of 60 rows in row groups of 10 (written by the
    port); its local path."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    path = str(tmp_path_factory.mktemp("fs") / "store")
    schema = Unischema("FsSchema", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False)])
    rng = np.random.RandomState(3)
    materialize_rows(f"file://{path}", schema,
                     ({"idx": i, "vec": rng.rand(4).astype(np.float32)} for i in range(ROWS)),
                     rows_per_row_group=GROUP)
    return path


class _LocalBacked:
    """An object store over a local directory, for the fake protocols: keys
    are ``bucket/ds/<relative path>``; every API call is counted."""

    local_root = None
    instances = []

    def __init__(self, *args, **kwargs):
        self.dircache = {}
        self.find_calls = 0
        self.ls_calls = 0
        self._objects = {}
        for dirpath, _, files in os.walk(self.local_root):
            for name in files:
                full = os.path.join(dirpath, name)
                key = "bucket/ds/" + os.path.relpath(full, self.local_root).replace(os.sep, "/")
                self._objects[key] = {"name": key, "size": os.path.getsize(full),
                                      "type": "file"}
        type(self).instances.append(self)

    @classmethod
    def _get_kwargs_from_urls(cls, url):
        return {}

    @classmethod
    def _strip_protocol(cls, path):
        return path.split("://", 1)[-1]

    def _local(self, path):
        return os.path.join(self.local_root, path.rstrip("/")[len("bucket/ds/"):])

    def find(self, path, detail=False, **kwargs):
        self.find_calls += 1
        listing = {k: dict(v) for k, v in sorted(self._objects.items())
                   if k.startswith(path.rstrip("/") + "/")}
        return listing if detail else sorted(listing)

    def ls(self, path, detail=False):
        self.ls_calls += 1
        path = path.rstrip("/")
        infos = [v for k, v in self._objects.items() if k.rsplit("/", 1)[0] == path]
        return infos if detail else [i["name"] for i in infos]

    def info(self, path):
        path = path.rstrip("/")
        if path in self._objects:
            return self._objects[path]
        if any(k.startswith(path + "/") for k in self._objects):
            return {"name": path, "size": 0, "type": "directory"}
        raise FileNotFoundError(path)

    def open(self, path, mode="rb", **kwargs):
        return open(self._local(path), mode)

    def size(self, path):
        return os.path.getsize(self._local(path))


class FakeGS(_LocalBacked):
    protocol = "gs"
    instances = []


class FakeS3(_LocalBacked):
    protocol = "s3"
    instances = []


@pytest.fixture
def fake_protocols(store):
    """``gs`` and ``s3`` served from ``store`` (registered for the test)."""
    import fsspec

    for cls in (FakeGS, FakeS3):
        cls.local_root = store
        cls.instances.clear()
        fsspec.register_implementation(cls.protocol, cls, clobber=True)
    yield
    for cls in (FakeGS, FakeS3):
        fsspec.register_implementation(cls.protocol, None, clobber=True)


def _describe(resolver):
    fs = resolver.filesystem()
    handler = getattr(fs, "handler", None)
    inner = getattr(handler, "fs", None)
    return (type(fs).__name__, type(inner).__name__ if inner is not None else None,
            resolver.get_dataset_path())


def _resolver_cases(store):
    import fsspec

    memory = fsspec.filesystem("memory")
    return {
        "local_path": (store, {}),
        "file_url": (f"file://{store}", {}),
        "memory_storage_options": ("memory:///fs-utils/ds", {
            "storage_options": {"skip_instance_cache": False}}),
        "pyarrow_filesystem": (f"file://{store}", {"filesystem": pafs.LocalFileSystem()}),
        "fsspec_filesystem": ("memory:///fs-utils/ds", {"filesystem": memory}),
        "s3_storage_options": ("s3://bucket/ds", {"storage_options": {"anon": True}}),
        "s3a_rename": ("s3a://bucket/ds", {"storage_options": {"anon": True}}),
        "s3n_rename": ("s3n://bucket/ds", {"storage_options": {"anon": True}}),
        "gcs_rename": ("gcs://bucket/ds", {"storage_options": {"token": "anon"},
                                           "fast_gcs_listing": False}),
        "gs_fast_listing": ("gs://bucket/ds", {"fast_gcs_listing": True}),
    }


@pytest.mark.parametrize("case", sorted(_resolver_cases("/x")))
def test_resolver_filesystem_and_path_equal_jax(store, fake_protocols, case):
    url, kwargs = _resolver_cases(store)[case]
    port = port_fs_utils.FilesystemResolver(url, **kwargs)
    jax = jax_fs_utils.FilesystemResolver(url, **kwargs)
    assert _describe(port) == _describe(jax)
    assert port.parsed_dataset_url == jax.parsed_dataset_url
    if case.startswith(("s3", "gcs")):
        assert port.get_dataset_path() == "bucket/ds"
        assert _describe(port)[1] in ("FakeS3", "FakeGS")


def test_resolver_argument_errors_equal_jax():
    for module in (port_fs_utils, jax_fs_utils):
        with pytest.raises(ValueError, match="must be a string"):
            module.FilesystemResolver(b"file:///x")
        with pytest.raises(ValueError, match="Empty dataset URL list"):
            module.get_filesystem_and_path_or_paths([])
        with pytest.raises(ValueError, match="share one scheme"):
            module.get_filesystem_and_path_or_paths(["file:///a", "memory:///b"])


def test_get_filesystem_and_path_or_paths_equals_jax(store):
    files = sorted(os.path.join(store, f) for f in os.listdir(store) if f.endswith(".parquet"))
    for arg in ([f"file://{f}" for f in files], f"file://{store}", store):
        port_fs, port_paths = port_fs_utils.get_filesystem_and_path_or_paths(arg)
        jax_fs, jax_paths = jax_fs_utils.get_filesystem_and_path_or_paths(arg)
        assert type(port_fs) is type(jax_fs) and port_paths == jax_paths


@pytest.mark.parametrize("url", ["file:///a/b", "s3://bucket/k/x", "s3a://bkt/y", "gs://b/c",
                                 "gcs://b/d", "hdfs://nn:8020/p", "memory:///m/n"])
def test_get_dataset_path_equals_jax(url):
    from urllib.parse import urlparse

    assert port_fs_utils.get_dataset_path(urlparse(url)) == \
        jax_fs_utils.get_dataset_path(urlparse(url))


# ---------------------------------------------------------------------------
# GCS fast listing
# ---------------------------------------------------------------------------

KEYS = ["bucket/ds/_common_metadata", "bucket/ds/part-00000.parquet",
        "bucket/ds/year=2024/month=1/part-00001.parquet",
        "bucket/ds/year=2024/month=2/part-00002.parquet",
        "bucket/ds/year=2025/month=1/part-00003.parquet", "bucket/ds/year=2025/"]


class _FlatStore:
    """A flat key store with gcsfs's listing surface; ``fail`` holds the
    exceptions the next ``find`` calls raise."""

    def __init__(self, keys, fail=()):
        self._objects = {k: {"name": k, "size": 11, "type": "file"} for k in keys}
        self.dircache = {}
        self.find_calls = 0
        self.fail = list(fail)

    def find(self, path, detail=False, **kwargs):
        self.find_calls += 1
        if self.fail:
            raise self.fail.pop(0)
        listing = {k: dict(v) for k, v in sorted(self._objects.items())
                   if k == path or k.startswith(path.rstrip("/") + "/")}
        return listing if detail else sorted(listing)

    def open(self, path, mode="rb"):
        return ("opened", path)


def test_fast_list_and_dircache_equal_jax():
    for detail in (False, True):
        port = port_fast.fast_list("gs://bucket/ds", filesystem=_FlatStore(KEYS), detail=detail)
        assert port == jax_fast.fast_list("gcs://bucket/ds", filesystem=_FlatStore(KEYS),
                                          detail=detail)
    listing = port_fast.fast_list("gs://bucket/ds", filesystem=_FlatStore(KEYS), detail=True)
    cache = port_fast.build_dircache("gs://bucket/ds", listing)
    assert cache == jax_fast.build_dircache("gs://bucket/ds", listing)
    assert "bucket/ds/year=2024/month=2" in cache  # pseudo-directories synthesized
    with pytest.raises(ValueError, match="not under the root"):
        port_fast.build_dircache("bucket/other", listing)
    port_fs, jax_fs = _FlatStore(KEYS), _FlatStore(KEYS)
    assert port_fast.warm_gcs_listing(port_fs, "gs://bucket/ds") == \
        jax_fast.warm_gcs_listing(jax_fs, "gs://bucket/ds")
    assert port_fs.dircache == jax_fs.dircache
    assert port_fast.seed_listing_cache(_FlatStore(KEYS), "bucket/ds", listing).dircache == cache


def test_fast_listing_filesystem_answers_equal_jax():
    port_store, jax_store = _FlatStore(KEYS), _FlatStore(KEYS)
    port = port_fast.FastListingFilesystem(port_store, "gs://bucket/ds")
    jax = jax_fast.FastListingFilesystem(jax_store, "gs://bucket/ds")
    assert port_store.find_calls == jax_store.find_calls == 1
    for path in ("bucket/ds", "gs://bucket/ds/year=2024", "bucket/ds/part-00000.parquet",
                 "bucket/ds/year=2025/month=1", "bucket/ds/missing"):
        for method in ("isdir", "isfile", "exists"):
            assert getattr(port, method)(path) == getattr(jax, method)(path), (method, path)
        for method, kwargs in (("ls", {}), ("ls", {"detail": True}), ("info", {})):
            try:
                want = getattr(jax, method)(path, **kwargs)
            except FileNotFoundError:
                with pytest.raises(FileNotFoundError):
                    getattr(port, method)(path, **kwargs)
                continue
            assert getattr(port, method)(path, **kwargs) == want, (method, path)
    for kwargs in ({}, {"maxdepth": 1}, {"withdirs": True}, {"detail": True},
                   {"maxdepth": 2, "withdirs": True, "detail": True}):
        assert port.find("bucket/ds", **kwargs) == jax.find("bucket/ds", **kwargs)
    assert list(port.walk()) == list(jax.walk())
    assert list(port.walk("bucket/ds/year=2024")) == list(jax.walk("bucket/ds/year=2024"))
    assert port.open("bucket/ds/x") == ("opened", "bucket/ds/x")  # passed through
    assert port_store.find_calls == 1


def test_fast_list_retries_transient_failures_only():
    store = _FlatStore(KEYS, fail=[OSError("page 2 timed out"), ConnectionError("reset")])
    assert port_fast.fast_list("gs://bucket/ds", filesystem=store, retry_base_delay=0.0) == \
        sorted(KEYS)
    assert store.find_calls == 3
    for error in (FileNotFoundError("gone"), PermissionError("denied")):
        store = _FlatStore(KEYS, fail=[error])
        with pytest.raises(type(error)):
            port_fast.fast_list("gs://bucket/ds", filesystem=store, retry_base_delay=0.0)
        assert store.find_calls == 1
    store = _FlatStore(KEYS, fail=[OSError("a"), OSError("b")])
    with pytest.raises(OSError, match="b"):
        port_fast.fast_list("gs://bucket/ds", filesystem=store, retries=1,
                            retry_base_delay=0.0)


@pytest.mark.parametrize("factory", FACTORIES)
def test_reader_over_gs_lists_once_and_reads_jax_rows(fake_protocols, factory):
    rows = {}
    for name, module in (("port", port_reader_mod), ("jax", jax_reader_mod)):
        with getattr(module, factory)("gs://bucket/ds", reader_pool_type="dummy",
                                      shuffle_row_groups=False) as reader:
            rows[name] = _flat_rows(reader)
        fake = FakeGS.instances[-1]
        assert fake.find_calls == 1 and fake.ls_calls == 0, name
    assert len(rows["port"]) == ROWS
    _assert_rows_equal(rows["port"], rows["jax"])


# ---------------------------------------------------------------------------
# HDFS namenode resolution
# ---------------------------------------------------------------------------

def _site(path, props):
    body = "".join(f"<property><name>{k}</name><value> {v} </value></property>"
                   for k, v in props.items())
    with open(path, "w") as f:
        f.write(f"<?xml version='1.0'?><configuration>{body}</configuration>")


@pytest.fixture
def hadoop_conf(tmp_path, monkeypatch):
    conf = tmp_path / "conf"
    conf.mkdir()
    _site(conf / "core-site.xml", {"fs.defaultFS": "hdfs://ns1"})
    _site(conf / "hdfs-site.xml", {
        "dfs.nameservices": "ns1,ns2", "dfs.ha.namenodes.ns1": "nn1, nn2",
        "dfs.namenode.rpc-address.ns1.nn1": "host1:8020",
        "dfs.namenode.rpc-address.ns1.nn2": "host2:8020",
        "dfs.ha.namenodes.ns2": "nn1"})
    for env in ("HADOOP_HOME", "HADOOP_PREFIX", "HADOOP_INSTALL"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf))
    return conf


def test_namenode_resolver_equals_jax(hadoop_conf):
    port, jax = port_namenode.HdfsNamenodeResolver(), jax_namenode.HdfsNamenodeResolver()
    assert port.hadoop_configuration == jax.hadoop_configuration
    assert port.resolve_default_hdfs_service() == jax.resolve_default_hdfs_service() == \
        ("ns1", ["host1:8020", "host2:8020"])
    assert port.resolve_hdfs_name_service("h:9000") == ["h:9000"]
    for name, error in (("ns9", "Unknown HDFS nameservice"),
                        ("ns2", "no resolvable namenode")):
        with pytest.raises(port_namenode.HdfsConnectError, match=error):
            port.resolve_hdfs_name_service(name)
        with pytest.raises(jax_namenode.HdfsConnectError, match=error):
            jax.resolve_hdfs_name_service(name)
    for name in ("core-site.xml", "hdfs-site.xml"):
        assert port_namenode._parse_hadoop_xml(str(hadoop_conf / name)) == \
            jax_namenode._parse_hadoop_xml(str(hadoop_conf / name))
    given = port_namenode.HdfsNamenodeResolver({"fs.defaultFS": "file:///"})
    with pytest.raises(port_namenode.HdfsConnectError, match="fs.defaultFS"):
        given.resolve_default_hdfs_service()
    assert port_namenode.HdfsNamenodeResolver({}).resolve_hdfs_name_service("dns") == ["dns"]
    error = port_namenode.MaxFailoversExceeded([OSError("x")], 2, "connect")
    assert str(error) == str(jax_namenode.MaxFailoversExceeded([OSError("x")], 2, "connect"))


# ---------------------------------------------------------------------------
# retry_with_backoff
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class _Budget:
    def __init__(self, tokens):
        self.tokens, self.successes = tokens, 0

    def try_spend(self):
        if self.tokens <= 0:
            return False
        self.tokens -= 1
        return True

    def record_success(self):
        self.successes += 1


def _flaky(failures, error=OSError):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise error(f"attempt {len(calls)}")
        return "done"
    return fn, calls


@pytest.mark.parametrize("failures,kwargs", [
    (3, dict(retries=3, base_delay=0.1, max_delay=0.25, jitter=0.5)),
    (2, dict(retries=5, base_delay=1.0, max_delay=5.0, jitter=0.0)),
    (4, dict(retries=6, base_delay=0.5, max_delay=2.0, deadline_s=2.0)),
    (9, dict(retries=2, base_delay=0.2)),
    (2, dict(retries=4, base_delay=0.3, budget="one token")),
])
def test_retry_with_backoff_delays_and_deadline_equal_jax(failures, kwargs):
    outcomes = {}
    for name, module in (("port", port_utils), ("jax", jax_utils)):
        clock, sleeps = _Clock(), []

        def sleep(seconds, clock=clock, sleeps=sleeps):
            sleeps.append(seconds)
            clock.now += seconds

        args = dict(kwargs)
        budget = _Budget(1) if args.pop("budget", None) else None
        fn, calls = _flaky(failures)
        try:
            result = module.retry_with_backoff(fn, sleep=sleep, rng=random.Random(4),
                                               clock=clock, budget=budget, **args)
        except OSError as exc:
            result = f"raised {exc}"
        outcomes[name] = (result, sleeps, len(calls),
                          None if budget is None else (budget.tokens, budget.successes))
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][2] >= 1


def test_retry_no_retry_on_and_backoff_delays_equal_jax():
    fn, calls = _flaky(1, FileNotFoundError)
    with pytest.raises(FileNotFoundError):
        port_utils.retry_with_backoff(fn, no_retry_on=(FileNotFoundError,), sleep=lambda s: None)
    assert len(calls) == 1
    fn, calls = _flaky(1, KeyError)
    with pytest.raises(KeyError):
        port_utils.retry_with_backoff(fn, retry_on=(OSError,), sleep=lambda s: None)
    for args in ((5, 0.05, 2.0), (3, 1.0, 1.5), (0, 1.0, 1.0)):
        assert list(port_utils.backoff_delays(*args, jitter=0.3, rng=random.Random(9))) == \
            list(jax_utils.backoff_delays(*args, jitter=0.3, rng=random.Random(9)))


# ---------------------------------------------------------------------------
# piece_indices and a memory:// store
# ---------------------------------------------------------------------------

def _flat_rows(reader):
    out = []
    for item in reader:
        d = item._asdict()
        if reader.batched_output:
            n = len(next(iter(d.values())))
            out.extend({k: v[i] for k, v in d.items()} for i in range(n))
        else:
            out.append(d)
    return out


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            np.testing.assert_array_equal(np.asarray(g[name]), np.asarray(w[name]))


def _both(factory, url, **kwargs):
    out = []
    for module in (port_reader_mod, jax_reader_mod):
        with getattr(module, factory)(url, **kwargs) as reader:
            out.append(_flat_rows(reader))
    return out


@pytest.mark.parametrize("kwargs", [
    dict(piece_indices=[4, 0, 4, 2]),
    dict(piece_indices=[5, 1, 3, 0], cur_shard=1, shard_count=2, shard_seed=2),
    dict(piece_indices=[0, 1, 2], filters=[("idx", ">=", 20)]),
    dict(piece_indices=[3, 2, 1], shuffle_row_drop_partitions=2, num_epochs=2),
], ids=["dedup_sorted", "then_sharded", "after_filters", "drop_partitions_epochs"])
@pytest.mark.parametrize("factory", FACTORIES)
def test_piece_indices_rows_equal_jax(store, factory, kwargs):
    port, jax = _both(factory, f"file://{store}", reader_pool_type="dummy",
                      shuffle_row_groups=True, **dict({"shard_seed": 7}, **kwargs))
    assert 0 < len(port)
    _assert_rows_equal(port, jax)


@pytest.mark.parametrize("factory", FACTORIES)
def test_piece_indices_range_check_and_resume_across_packages(store, factory):
    for module in (port_reader_mod, jax_reader_mod):
        with pytest.raises(ValueError, match=r"piece_indices \[6, 9\] out of range"):
            getattr(module, factory)(f"file://{store}", piece_indices=[9, 6, 1])
    kwargs = dict(piece_indices=[1, 3, 5], reader_pool_type="dummy", shuffle_row_groups=False)
    with getattr(jax_reader_mod, factory)(f"file://{store}", **kwargs) as reader:
        first = _flat_rows(reader)  # the whole plan: its state delivers nothing more
        state = reader.state_dict()
    with getattr(port_reader_mod, factory)(f"file://{store}", resume_state=state,
                                           **kwargs) as reader:
        assert _flat_rows(reader) == []
    assert sorted(int(r["idx"]) // GROUP for r in first) == [1] * 10 + [3] * 10 + [5] * 10
    with pytest.raises(ValueError):  # another plan is another fingerprint
        getattr(port_reader_mod, factory)(f"file://{store}", resume_state=state,
                                          **dict(kwargs, piece_indices=[1, 3]))


def test_memory_store_written_and_read_by_both_packages(store):
    """The port writes into fsspec's ``memory://``; both packages read it
    back through ``storage_options`` and through a caller's filesystem, and
    the JAX writer's files there are byte-equal to the port's."""
    import fsspec

    from petastorm_tpu.etl import metadata as jax_metadata
    from petastorm_tpu_torch.etl import metadata as port_metadata

    memory = fsspec.filesystem("memory")
    base = f"/fs-utils-{uuid.uuid4().hex[:8]}"
    opts = {"skip_instance_cache": False}
    with port_reader_mod.make_reader(f"file://{store}", reader_pool_type="dummy",
                                     shuffle_row_groups=False) as reader:
        rows = [r._asdict() for r in reader]
    schema = port_metadata.get_schema_from_dataset_url(f"file://{store}")
    jax_schema = jax_metadata.get_schema_from_dataset_url(f"file://{store}")
    try:
        port_metadata.materialize_rows(f"memory://{base}/port", schema, rows,
                                       rows_per_row_group=GROUP, storage_options=opts)
        jax_metadata.materialize_rows(f"memory://{base}/jax", jax_schema, rows,
                                      rows_per_row_group=GROUP, filesystem=memory)
        names = sorted(p.rsplit("/", 1)[1] for p in memory.ls(f"{base}/port", detail=False))
        assert names == sorted(p.rsplit("/", 1)[1] for p in memory.ls(f"{base}/jax",
                                                                        detail=False))
        for name in names:
            assert memory.cat(f"{base}/port/{name}") == memory.cat(f"{base}/jax/{name}"), name
        assert port_metadata.get_schema_from_dataset_url(
            f"memory://{base}/jax", storage_options=opts).fields.keys() == schema.fields.keys()
        for kwargs in ({"storage_options": opts}, {"filesystem": memory}):
            port, jax = _both("make_reader", f"memory://{base}/port", reader_pool_type="dummy",
                              shuffle_row_groups=False, **kwargs)
            assert len(port) == ROWS
            _assert_rows_equal(port, jax)
            _assert_rows_equal(port, rows)
            port, jax = _both("make_batch_reader", f"memory://{base}/jax",
                              reader_pool_type="thread", workers_count=2,
                              shuffle_row_groups=False, **kwargs)
            assert sorted(int(r["idx"]) for r in port) == list(range(ROWS))
            assert sorted(int(r["idx"]) for r in jax) == list(range(ROWS))
    finally:
        memory.rm(base, recursive=True)
