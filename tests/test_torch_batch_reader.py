"""The port's plain-Parquet batch reader against the JAX package's, on the
same stores: the Criteo-shaped store both packages write
(``make_tabular_dataset``, which must be byte-equal), read through
``make_batch_reader`` in both.

- dummy pool, seeded shuffle, with and without ``shard_count`` /
  ``shard_seed``: the same column batches in the same order, bit for bit
  (values and dtypes);
- thread pool: the same multiset of ``sample_index``;
- ``filters`` (DNF lists and ``pyarrow.dataset`` expressions) plan the same
  pieces in both packages, and DNF and expression forms agree;
- ``Unischema.from_arrow_schema`` infers the same fields;
- ``storage_options``, ``hdfs_driver``, ``filesystem``,
  ``fast_gcs_listing``, ``piece_indices`` and ``dynamic_ventilation`` give
  the JAX reader's batches;
  ``zmq_copy_buffers=False`` through both packages' process pools gives
  the same batches.

Tolerance: none; everything here is compared exactly.
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

ROWS, DAYS = 480, 8  # 8 row groups of 60 rows


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The tabular store, written by the port; its URL."""
    from petastorm_tpu_torch.models.tabular_dlrm import make_tabular_dataset

    url = f"file://{tmp_path_factory.mktemp('tabular')}/criteo"
    assert make_tabular_dataset(url, rows=ROWS, days=DAYS) == ROWS
    return url


def _batches(reader):
    with reader:
        return [b._asdict() for b in reader]


def _readers(url, **kwargs):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    return (_batches(make_batch_reader(url, **kwargs)),
            _batches(jax_make_batch_reader(url, **kwargs)))


def test_make_tabular_dataset_is_byte_equal_to_jax(tmp_path):
    from petastorm_tpu.benchmark.scenarios import make_tabular_dataset as jax_make
    from petastorm_tpu_torch.models.tabular_dlrm import make_tabular_dataset

    args = dict(rows=1000, dense_cols=3, sparse_cols=4, days=3)
    assert make_tabular_dataset(f"file://{tmp_path}/port", **args) == \
        jax_make(f"file://{tmp_path}/jax", **args) == 999
    port = (tmp_path / "port" / "part-00000.parquet").read_bytes()
    assert port == (tmp_path / "jax" / "part-00000.parquet").read_bytes()
    meta = pq.ParquetFile(tmp_path / "port" / "part-00000.parquet").metadata
    assert meta.num_row_groups == 3 and meta.num_columns == 3 + 3 + 4


@pytest.mark.parametrize("kwargs", [
    dict(shuffle_row_groups=False),
    dict(shuffle_row_groups=True, shard_seed=3),
    dict(shuffle_row_groups=True, shard_seed=5, cur_shard=1, shard_count=3),
    dict(shuffle_row_groups=False, cur_shard=0, shard_count=2),
    dict(shuffle_row_groups=True, shard_seed=9, schema_fields=["dense_.*", "label"]),
], ids=["canonical", "shuffled", "sharded_seeded", "sharded", "schema_fields"])
def test_same_batches_in_the_same_order_as_jax(store, kwargs):
    port, jax = _readers(store, reader_pool_type="dummy", num_epochs=2, **kwargs)
    assert len(port) == len(jax) > 0
    for got, want in zip(port, jax):
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_thread_pool_gives_the_same_rows_as_jax(store):
    port, jax = _readers(store, reader_pool_type="thread", workers_count=3, num_epochs=2,
                         shuffle_row_groups=True, shard_seed=1)
    rows = [np.sort(np.concatenate([b["sample_index"] for b in batches]))
            for batches in (port, jax)]
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(rows[0], np.repeat(np.arange(ROWS), 2))


FILTERS = {
    "eq": [("day", "=", 3)],
    "in": [("day", "in", [1, 5])],
    "range": [("day", ">", 2), ("day", "<=", 4)],
    "or": [[("day", "<", 2)], [("day", ">=", 6)]],
    "expression": pc.field("day") == 3,
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters_plan_the_same_pieces_as_jax(store, name):
    import pyarrow.fs as pafs

    from petastorm_tpu.reader.reader import enumerate_row_group_pieces as jax_enumerate
    from petastorm_tpu_torch.reader.reader import enumerate_row_group_pieces

    fs, path = pafs.LocalFileSystem(), store[len("file://"):]
    got = enumerate_row_group_pieces(fs, path, FILTERS[name])
    want = jax_enumerate(fs, path, FILTERS[name])
    assert [(p.path, p.row_group, p.num_rows) for p in got] == \
        [(p.path, p.row_group, p.num_rows) for p in want]
    assert 0 < len(got) < DAYS


def test_dnf_and_expression_filters_agree(store):
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.reader.reader import enumerate_row_group_pieces

    fs, path = pafs.LocalFileSystem(), store[len("file://"):]
    pairs = [([("day", "=", 3)], pc.field("day") == 3),
             ([[("day", "<", 2)], [("day", ">=", 6)]],
              (pc.field("day") < 2) | (pc.field("day") >= 6))]
    for dnf, expression in pairs:
        assert enumerate_row_group_pieces(fs, path, dnf) == \
            enumerate_row_group_pieces(fs, path, expression)


def test_filtered_scan_reads_one_row_group(store):
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    port, jax = _readers(store, reader_pool_type="dummy", filters=[("day", "=", 3)])
    assert len(port) == len(jax) == 1
    np.testing.assert_array_equal(port[0]["sample_index"], jax[0]["sample_index"])
    assert set(port[0]["day"].tolist()) == {3}
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader

    kwargs = dict(reader_pool_type="dummy", filters=[("day", "=", 3)])
    with make_batch_reader(store, **kwargs) as r, jax_make_batch_reader(store, **kwargs) as j:
        list(r), list(j)
        assert set(r.diagnostics) == set(j.diagnostics)
        assert r.diagnostics == j.diagnostics
        assert {k: r.diagnostics[k] for k in ("rowgroups_total", "items_per_epoch",
                                              "workers_count")} == \
            {"rowgroups_total": 1, "items_per_epoch": 1, "workers_count": 1}


def test_list_columns_stack_like_jax(tmp_path):
    """Codec-less list columns: fixed-length rows stack into [N, k]."""
    path = tmp_path / "lists"
    path.mkdir()
    rng = np.random.RandomState(2)
    table = pa.table({"id": np.arange(20, dtype=np.int64),
                      "vec": pa.array([rng.rand(3).astype(np.float32).tolist()
                                       for _ in range(20)], pa.list_(pa.float32()))})
    pq.write_table(table, path / "part-0.parquet", row_group_size=10)
    port, jax = _readers(f"file://{path}", reader_pool_type="dummy", shuffle_row_groups=False)
    assert len(port) == len(jax) == 2
    for got, want in zip(port, jax):
        assert got["vec"].shape == want["vec"].shape == (10, 3)
        np.testing.assert_array_equal(got["vec"], want["vec"])


ARROW_FIELDS = [
    pa.field("i8", pa.int8()), pa.field("u32", pa.uint32(), nullable=False),
    pa.field("f16", pa.float16()), pa.field("f64", pa.float64()),
    pa.field("flag", pa.bool_()), pa.field("s", pa.string()),
    pa.field("ls", pa.large_string()), pa.field("b", pa.binary()),
    pa.field("dec", pa.decimal128(10, 2)), pa.field("ts", pa.timestamp("us")),
    pa.field("d32", pa.date32()), pa.field("d64", pa.date64()),
    pa.field("vec", pa.list_(pa.float32())),
    pa.field("mat", pa.list_(pa.list_(pa.int32()))),
    pa.field("nested", pa.struct([("a", pa.int32())])),
]


def _field_tuples(schema):
    return [(f.name, f.numpy_dtype, f.shape, f.codec, f.nullable)
            for f in schema.fields.values()]


def test_from_arrow_schema_gives_the_same_fields_as_jax():
    from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
    from petastorm_tpu_torch.schema.unischema import Unischema

    schema = pa.schema(ARROW_FIELDS)
    got = Unischema.from_arrow_schema(schema, omit_unsupported_fields=True)
    want = JaxUnischema.from_arrow_schema(schema, omit_unsupported_fields=True)
    assert _field_tuples(got) == _field_tuples(want)
    assert "nested" not in got.fields and len(got.fields) == len(ARROW_FIELDS) - 1
    assert got.fields["dec"].numpy_dtype is decimal.Decimal
    assert got.fields["mat"].shape == (None, None)
    with pytest.raises(ValueError, match="Unsupported arrow type"):
        Unischema.from_arrow_schema(schema)
    with pytest.raises(ValueError, match="Unsupported arrow type"):
        JaxUnischema.from_arrow_schema(schema)
    assert got.fields["ts"].numpy_dtype == np.dtype("datetime64[us]")


def test_from_arrow_schema_of_the_store_matches_jax(store):
    import pyarrow.dataset as pads

    from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
    from petastorm_tpu_torch.schema.unischema import Unischema

    dataset = pads.dataset(store[len("file://"):], format="parquet")
    got = Unischema.from_arrow_schema(dataset)
    assert _field_tuples(got) == _field_tuples(JaxUnischema.from_arrow_schema(dataset))
    assert len(got.fields) == 3 + 13 + 26


@pytest.mark.parametrize("name,value", [
    ("storage_options", {"anon": True}), ("hdfs_driver", "libhdfs3"),
    ("fast_gcs_listing", False),
    ("filesystem", "local"), ("piece_indices", [5, 0, 2]), ("dynamic_ventilation", True),
])
def test_unported_arguments_raise_by_name(store, name, value):
    """Each argument gives the JAX reader's batches, bit for bit
    (``hdfs_driver`` is taken and unused by both on a local store), and
    ``dynamic_ventilation`` the JAX reader's ``(batch, piece)`` pairs for
    the same submitted pieces."""
    import pyarrow.fs as pafs

    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    if name == "dynamic_ventilation":
        pairs = {}
        for package, make in (("port", make_batch_reader), ("jax", jax_make_batch_reader)):
            reader = make(store, dynamic_ventilation=value, shuffle_row_groups=False,
                          reader_pool_type="dummy")
            for piece in (5, 0, 2):
                reader.submit_piece(piece)
            reader.finish_pieces()
            with reader:
                pairs[package] = [reader.read_next_tagged(timeout=30) for _ in range(3)]
        assert [p for _, p in pairs["port"]] == [p for _, p in pairs["jax"]] == [5, 0, 2]
        for (got, _), (want, _) in zip(pairs["port"], pairs["jax"]):
            for key in want._fields:
                assert getattr(got, key).dtype == getattr(want, key).dtype
                np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
        return
    if name == "filesystem":
        value = pafs.LocalFileSystem()
    port, jax = _readers(store, reader_pool_type="dummy", shuffle_row_groups=True,
                         shard_seed=3, **{name: value})
    assert len(port) == (3 if name == "piece_indices" else DAYS) == len(jax)
    for got, want in zip(port, jax):
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_zmq_copy_buffers_false_delivers_the_jax_batches(store):
    """``zmq_copy_buffers=False`` (one IPC buffer a table instead of its
    frames) through the process pool, at one worker: the JAX process
    pool's batches in the same order, bit for bit."""
    port, jax = _readers(store, reader_pool_type="process", workers_count=1,
                         zmq_copy_buffers=False, shuffle_row_groups=True, shard_seed=3)
    assert len(port) == len(jax) == DAYS
    for p, j in zip(port, jax):
        assert p.keys() == j.keys()
        for name in p:
            assert p[name].dtype == j[name].dtype and np.array_equal(p[name], j[name])


def test_unported_arguments_at_their_default_are_accepted(store):
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    with make_batch_reader(store, reader_pool_type="dummy", predicate=None,
                           shuffle_row_drop_partitions=1, results_queue_size=50) as r:
        assert sum(len(b.sample_index) for b in r) == ROWS
    with pytest.raises(TypeError, match="unexpected keyword"):
        make_batch_reader(store, no_such_argument=1)
    part = f"{store}/part-00000.parquet"
    with make_batch_reader([part, part], reader_pool_type="dummy") as r:
        assert sum(len(b.sample_index) for b in r) == 2 * ROWS
