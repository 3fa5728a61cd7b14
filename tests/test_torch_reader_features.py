"""The reader arguments the port gained, against the JAX reader on the same
stores (written by the port from seeded numpy data; each test reads its
own): ``predicate``, ``rowgroup_selector`` (alone and with ``filters``,
matched by (file, row group)), ``shuffle_row_drop_partitions``,
``filters``, the local-disk cache, ``results_queue_size``,
``reader_engine``, several URLs and the pandas ``transform_spec`` of the
batch reader, on all three factories:

- with the dummy pool and a seeded shuffle, the same rows (all fields) in
  the same order as the JAX reader; with the thread pool, the same
  multiset;
- a predicate over an integer column with nulls gives the batch reader the
  JAX reader's rows (its mask is taken on Arrow/numpy columns, the JAX
  worker's on pandas);
- the local-disk cache: the second epoch reads no row group, its size
  limit and LRU eviction hold, ``cleanup`` removes the directory;
- a ``resume_state`` crosses the packages both ways with a predicate, a
  selector and drop partitions, and the planning fingerprints are equal;
- ``storage_options``, ``hdfs_driver``, ``filesystem``,
  ``fast_gcs_listing``, ``piece_indices`` and ``dynamic_ventilation`` give
  the JAX reader's rows.

Tolerance: none; everything is compared exactly.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu import selectors as jax_selectors
from petastorm_tpu_torch import predicates as port_predicates
from petastorm_tpu_torch import selectors as port_selectors

ROWS, GROUP = 240, 20  # 12 row groups
FACTORIES = ["make_reader", "make_columnar_reader", "make_batch_reader"]


def write_store(url):
    """A petastorm store written by the port: idx, digit, part (string),
    maybe (nullable int), image (png), vec (ndarray); 12 row groups."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.schema.codecs import (
        CompressedImageCodec,
        NdarrayCodec,
        ScalarCodec,
    )
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("FeatureSchema", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("digit", np.int64, (), ScalarCodec(), False),
        UnischemaField("part", str, (), ScalarCodec(), False),
        UnischemaField("maybe", np.int32, (), ScalarCodec(), True),
        UnischemaField("image", np.uint8, (8, 8), CompressedImageCodec("png"), False),
        UnischemaField("vec", np.float32, (3,), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(11)
    materialize_rows(url, schema, ({
        "idx": i, "digit": int(rng.randint(0, 10)), "part": f"p{i // 40}",
        "maybe": None if i % 5 == 2 else int(rng.randint(0, 9)),
        "image": rng.randint(0, 256, (8, 8), dtype=np.uint8),
        "vec": rng.rand(3).astype(np.float32)} for i in range(ROWS)),
        rows_per_row_group=GROUP)
    build_rowgroup_index(url, [SingleFieldIndexer("by_part", "part"),
                               SingleFieldIndexer("by_idx", "idx")])
    return url


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(f"file://{tmp_path_factory.mktemp('features')}/store")


def _split(m):
    return m.in_pseudorandom_split([0.6, 0.4], 0, "idx")


#: name -> (kwargs built with predicates/selectors modules (p, s)), the
#: arguments every factory is held to against the JAX reader.
CASES = {
    "predicate_in_set": lambda p, s: dict(predicate=p.in_set({1, 4, 7}, "digit")),
    "predicate_lambda_outside_fields": lambda p, s: dict(
        predicate=p.in_lambda(["digit"], lambda v: v["digit"] % 3 == 0),
        schema_fields=["idx", "image"]),
    "predicate_split": lambda p, s: dict(predicate=_split(p)),
    "predicate_string": lambda p, s: dict(predicate=p.in_set(["p1", "p4"], "part")),
    "predicate_nulls": lambda p, s: dict(predicate=p.in_set({4, 5, 6}, "maybe")),
    "predicate_column": lambda p, s: dict(predicate=p.ColumnPredicate("digit", "ge", 6)),
    "selector": lambda p, s: dict(rowgroup_selector=s.SingleIndexSelector("by_part",
                                                                          ["p1", "p3"])),
    "selector_with_filters": lambda p, s: dict(
        rowgroup_selector=s.SingleIndexSelector("by_part", ["p0", "p1"]),
        filters=[("idx", ">=", 40)]),
    "selector_union": lambda p, s: dict(rowgroup_selector=s.UnionIndexSelector(
        [s.SingleIndexSelector("by_idx", [5, 201]), s.SingleIndexSelector("by_part", ["p2"])])),
    "drop_partitions": lambda p, s: dict(shuffle_row_drop_partitions=3),
    "filters": lambda p, s: dict(filters=[[("idx", "<", 60)], [("idx", ">=", 200)]]),
    "all_together": lambda p, s: dict(
        predicate=p.in_set({0, 2, 4, 6, 8}, "digit"), shuffle_row_drop_partitions=2,
        rowgroup_selector=s.SingleIndexSelector("by_part", ["p0", "p2", "p5"]),
        filters=[("idx", "<", 220)], results_queue_size=3),
}


def _rows(reader):
    """Every row the reader yields, as a dict of numpy values (batches are
    split into rows), in delivery order."""
    out = []
    with reader:
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
            a, b = g[name], w[name]
            if isinstance(b, float) and np.isnan(b):
                assert np.isnan(a), name
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def _read_both(factory, url, **kwargs):
    port_kwargs = kwargs.pop("port_kwargs")
    jax_kwargs = kwargs.pop("jax_kwargs")
    port = _rows(getattr(port_reader_mod, factory)(url, **port_kwargs, **kwargs))
    jax = _rows(getattr(jax_reader_mod, factory)(url, **jax_kwargs, **kwargs))
    return port, jax


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("factory", FACTORIES)
def test_same_rows_in_the_same_order_as_jax(store, factory, case):
    port, jax = _read_both(
        factory, store, port_kwargs=CASES[case](port_predicates, port_selectors),
        jax_kwargs=CASES[case](jax_predicates, jax_selectors),
        reader_pool_type="dummy", shuffle_row_groups=True, shard_seed=5, num_epochs=2)
    assert 0 < len(port) < 2 * ROWS or case == "drop_partitions"
    _assert_rows_equal(port, jax)


@pytest.mark.parametrize("factory", FACTORIES)
def test_thread_pool_gives_the_jax_multiset(store, factory):
    kwargs = CASES["all_together"]
    port, jax = _read_both(factory, store, port_kwargs=kwargs(port_predicates, port_selectors),
                           jax_kwargs=kwargs(jax_predicates, jax_selectors),
                           workers_count=3, num_epochs=1)
    assert sorted(int(r["idx"]) for r in port) == sorted(int(r["idx"]) for r in jax)
    assert len(port) > 0


@pytest.mark.parametrize("factory", FACTORIES)
def test_drop_partitions_split_each_row_group(store, factory):
    with getattr(port_reader_mod, factory)(store, reader_pool_type="dummy",
                                          shuffle_row_groups=False,
                                          shuffle_row_drop_partitions=4) as reader:
        rows = _rows(reader)
        assert reader.diagnostics["items_per_epoch"] == 4 * ROWS // GROUP
    assert sorted(int(r["idx"]) for r in rows) == list(range(ROWS))
    # Item (piece 0, partition 0) holds rows 0, 4, 8, ... of row group 0.
    assert [int(r["idx"]) for r in rows[:5]] == [0, 4, 8, 12, 16]


@pytest.fixture
def null_store(tmp_path):
    """A plain Parquet store whose int column holds nulls (two files)."""
    rng = np.random.RandomState(5)
    os.makedirs(tmp_path / "nulls")
    urls = []
    for f in range(2):
        n = 50
        v = [None if i % 6 == 1 else int(x) for i, x in enumerate(rng.randint(0, 10, n))]
        table = pa.table({"k": np.arange(f * n, (f + 1) * n), "v": pa.array(v, pa.int64()),
                          "w": rng.rand(n)})
        path = tmp_path / "nulls" / f"part-{f}.parquet"
        pq.write_table(table, path, row_group_size=20)
        urls.append(f"file://{path}")
    return f"file://{tmp_path}/nulls", urls


@pytest.mark.parametrize("predicate", ["in_set", "lambda_nan", "column_ge", "negate"])
def test_batch_reader_predicate_on_nulls_matches_jax(null_store, predicate):
    def build(m):
        return {"in_set": lambda: m.in_set({1, 3}, "v"),
                "lambda_nan": lambda: m.in_lambda(["v"], lambda r: not r["v"] == r["v"]),
                "column_ge": lambda: m.ColumnPredicate("v", "ge", 5),
                "negate": lambda: m.in_negate(m.in_set({2}, "v"))}[predicate]()

    url, _ = null_store
    port, jax = _read_both("make_batch_reader", url, port_kwargs=dict(predicate=build(
        port_predicates)), jax_kwargs=dict(predicate=build(jax_predicates)),
        reader_pool_type="dummy", shuffle_row_groups=False)
    assert [int(r["k"]) for r in port] == [int(r["k"]) for r in jax]
    assert len(port) > 0
    for g, w in zip(port, jax):
        assert (np.isnan(g["v"]) and np.isnan(w["v"])) or g["v"] == w["v"]
        assert g["w"] == w["w"]


def test_batch_reader_over_several_urls_matches_jax(null_store):
    _, urls = null_store
    port, jax = _read_both("make_batch_reader", list(urls), port_kwargs={}, jax_kwargs={},
                           reader_pool_type="dummy", shard_seed=2, num_epochs=2)
    _assert_rows_equal(port, jax)
    with port_reader_mod.make_batch_reader(list(urls), num_epochs=1) as reader:
        state = reader.state_dict()
        assert state["dataset_path"] == sorted(u[len("file://"):] for u in urls)
    with pytest.raises(ValueError, match="multiple dataset URLs"):
        port_reader_mod.make_batch_reader(list(urls), rowgroup_selector=(
            port_selectors.SingleIndexSelector("x", [1])))


def _frame_transform(frame):
    frame = frame[frame["v"].notna()].copy()
    frame["v2"] = frame["v"].astype("float64") * 2
    return frame.drop(columns=["w"])


def test_batch_reader_pandas_transform_spec_matches_jax(null_store):
    from petastorm_tpu.schema.transform import TransformSpec as JaxSpec
    from petastorm_tpu_torch.schema.transform import TransformSpec

    spec = dict(edit_fields=[("v2", np.float64, (), False)], removed_fields=["w"])
    url, _ = null_store
    port, jax = _read_both("make_batch_reader", url,
                           port_kwargs=dict(transform_spec=TransformSpec(_frame_transform, **spec)),
                           jax_kwargs=dict(transform_spec=JaxSpec(_frame_transform, **spec)),
                           reader_pool_type="dummy", shuffle_row_groups=False,
                           shuffle_row_drop_partitions=2)
    _assert_rows_equal(port, jax)
    assert sorted(port[0]) == ["k", "v", "v2"] and len(port) > 0
    assert repr(TransformSpec(_frame_transform, **spec)) == repr(JaxSpec(_frame_transform,
                                                                         **spec))


def test_columnar_reader_transform_spec_matches_jax(store):
    from petastorm_tpu.schema.transform import TransformSpec as JaxSpec
    from petastorm_tpu_torch.schema.transform import TransformSpec

    def double(batch):
        batch["vec"] = batch["vec"] * 2
        return batch

    spec = dict(removed_fields=["image"])
    port, jax = _read_both("make_columnar_reader", store,
                           port_kwargs=dict(transform_spec=TransformSpec(double, **spec)),
                           jax_kwargs=dict(transform_spec=JaxSpec(double, **spec)),
                           reader_pool_type="dummy", shard_seed=1)
    _assert_rows_equal(port, jax)
    assert "image" not in port[0]


class _CountReads:
    """Counts ``RowGroupPiece.read`` calls of the port."""

    def __init__(self, monkeypatch):
        from petastorm_tpu_torch.etl.metadata import RowGroupPiece

        self.calls = 0
        real = RowGroupPiece.read

        def read(piece, *args, **kwargs):
            self.calls += 1
            return real(piece, *args, **kwargs)

        monkeypatch.setattr(RowGroupPiece, "read", read)


@pytest.mark.parametrize("factory", FACTORIES)
def test_local_disk_cache_serves_the_second_epoch(store, tmp_path, monkeypatch, factory):
    counter = _CountReads(monkeypatch)
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False,
                  predicate=port_predicates.in_set({0, 1, 2, 3, 4}, "digit"),
                  shuffle_row_drop_partitions=2, cache_type="local-disk",
                  cache_location=str(tmp_path / "cache"), cache_size_limit=10**8)
    epochs = []
    for _ in range(2):
        before = counter.calls
        reader = getattr(port_reader_mod, factory)(store, **kwargs)
        epochs.append(_rows(reader))
        epochs.append(counter.calls - before)
        size = reader.cache.size_on_disk()
    first, first_reads, second, second_reads = epochs
    assert first_reads > 0 and second_reads == 0
    assert len(os.listdir(tmp_path / "cache")) == 2 * ROWS // GROUP and size > 0
    _assert_rows_equal(second, first)


def test_local_disk_cache_size_limit_lru_and_cleanup(tmp_path):
    from petastorm_tpu_torch.local_disk_cache import LocalDiskCache

    path = str(tmp_path / "lru")
    cache = LocalDiskCache(path, size_limit=3 * 1100, cleanup=True)
    blob = lambda i: bytes([i]) * 1000  # noqa: E731 - a tiny fill function
    fills = []

    def get(i):
        return cache.get(("k", i), lambda: fills.append(i) or blob(i))

    for i in range(3):
        assert get(i) == blob(i)
    old = os.stat(path).st_mtime - 100  # entries made older, in name order
    for i, f in enumerate(sorted(os.listdir(path))):
        os.utime(os.path.join(path, f), (old + i, old + i))
    assert get(0) == blob(0) and fills == [0, 1, 2]  # a hit, which touches key 0
    get(3)  # over the limit: the least recently used entry (1 or 2) goes
    assert cache.size_on_disk() <= 3 * 1100
    assert len(os.listdir(path)) == 3
    get(0)
    assert fills == [0, 1, 2, 3]  # key 0 survived the eviction
    cache.cleanup()
    assert not os.path.exists(path)


def test_local_disk_cache_settings_and_refusals(store, tmp_path):
    with pytest.raises(ValueError, match="requires cache_location and cache_size_limit"):
        port_reader_mod.make_reader(store, cache_type="local-disk")
    with pytest.raises(ValueError, match="Unknown cache_type"):
        port_reader_mod.make_reader(store, cache_type="memory")
    loc = tmp_path / "c"
    with port_reader_mod.make_batch_reader(
            store, reader_pool_type="dummy", cache_type="local-disk", cache_location=str(loc),
            cache_size_limit=10**7, cache_row_size_estimate=100,
            cache_extra_settings={"cleanup": True}) as reader:
        assert sum(len(b.idx) for b in reader) == ROWS
        assert type(reader.cache).__name__ == "LocalDiskArrowTableCache"
        assert reader.cache.size_on_disk() > 0
    assert not loc.exists()  # cleanup=True: stop() removed it


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("factory", ["make_reader", "make_batch_reader"])
def test_resume_state_crosses_the_packages(store, factory, direction):
    kwargs = CASES["all_together"]
    common = dict(reader_pool_type="dummy", shard_seed=4, num_epochs=2)
    first_mod, second_mod = ((port_reader_mod, jax_reader_mod) if direction == "port_to_jax"
                             else (jax_reader_mod, port_reader_mod))
    mods = {port_reader_mod: (port_predicates, port_selectors),
            jax_reader_mod: (jax_predicates, jax_selectors)}
    first = getattr(first_mod, factory)(store, **kwargs(*mods[first_mod]), **common)
    with first:
        seen = []
        while len(seen) < 40:
            seen.extend(np.atleast_1d(next(first).idx).tolist())
        state = first.state_dict()
    other = getattr(second_mod, factory)(store, resume_state=state,
                                         **kwargs(*mods[second_mod]), **common)
    assert other.state_dict()["planning"] == state["planning"]
    assert state["drop_partitions"] == 2
    rest = [int(r["idx"]) for r in _rows(other)]
    full = [int(r["idx"]) for r in _rows(getattr(port_reader_mod, factory)(
        store, **kwargs(port_predicates, port_selectors), **common))]
    # At least once: every row of the full run is seen over both runs.
    counts = np.bincount(seen + rest, minlength=ROWS)
    assert (counts >= np.bincount(full, minlength=ROWS)).all()
    assert len(rest) < len(full)


def test_planning_fingerprint_and_predicate_check(store):
    with port_reader_mod.make_reader(
            store, reader_pool_type="dummy",
            rowgroup_selector=port_selectors.SingleIndexSelector("by_part", ["p0"]),
            filters=[("idx", "<", 30)]) as reader:
        assert reader.state_dict()["planning"] == repr(
            ([("idx", "<", 30)], jax_selectors.SingleIndexSelector("by_part", ["p0"])))
        # Row-group pruning by statistics: row group 1 (idx 20-39) may hold idx < 30.
        assert sorted(int(r.idx) for r in reader) == list(range(40))
    with pytest.raises(ValueError, match="instance of PredicateBase"):
        port_reader_mod.make_reader(store, predicate=lambda row: True)
    from petastorm_tpu_torch.errors import NoDataAvailableError

    with pytest.raises(NoDataAvailableError, match="filters/selector"):
        port_reader_mod.make_reader(store, rowgroup_selector=port_selectors.SingleIndexSelector(
            "by_part", ["no-such-part"]))


def test_ngram_drop_partition_rule(store):
    from petastorm_tpu_torch.ngram import NGram

    ngram = NGram({0: ["idx"], 1: ["idx"]}, delta_threshold=5, timestamp_field="idx",
                  timestamp_overlap=False)
    with pytest.raises(NotImplementedError, match="non-overlapping NGram"):
        port_reader_mod.make_reader(store, schema_fields=ngram, shuffle_row_drop_partitions=2)


def test_reader_engine_and_results_queue_size(store):
    with pytest.warns(DeprecationWarning, match="reader_engine"):
        reader = port_reader_mod.make_reader(store, reader_engine="reader_v1",
                                             results_queue_size=2, workers_count=2)
    with reader:
        assert sorted(int(r.idx) for r in reader) == list(range(ROWS))
    with pytest.raises(ValueError, match="reader_engine 'reader_v2'"):
        port_reader_mod.make_reader(store, reader_engine="reader_v2")


#: The factories' filesystem and planning arguments, each held against the
#: JAX reader (``hdfs_driver`` is taken and unused by both on a local store).
UNPORTED = [("storage_options", {"anon": True}), ("hdfs_driver", "libhdfs3"),
            ("fast_gcs_listing", False), ("filesystem", "local"),
            ("piece_indices", [6, 1, 3, 1]), ("dynamic_ventilation", True)]


def _tagged_outputs(reader, pieces):
    """A dynamic reader's ``(output as a dict, piece)`` pairs for the
    pieces submitted in this order."""
    from petastorm_tpu_torch.workers_pool import EmptyResultError as PortEmpty
    from petastorm_tpu.workers_pool import EmptyResultError as JaxEmpty

    assert reader.dynamic
    for piece in pieces:
        reader.submit_piece(piece)
    reader.finish_pieces()
    out = []
    with reader:
        while True:
            try:
                output, piece = reader.read_next_tagged(timeout=30)
            except (PortEmpty, JaxEmpty):
                return out
            out.append((output._asdict(), piece))


@pytest.mark.parametrize("name,value", UNPORTED, ids=[n for n, _ in UNPORTED])
@pytest.mark.parametrize("factory", FACTORIES)
def test_unported_arguments_raise_by_name(store, factory, name, value):
    if name == "dynamic_ventilation":
        # The dynamic piece feed: the same (output, piece) pairs as the JAX
        # reader's for the same submissions.
        kwargs = dict(dynamic_ventilation=value, shuffle_row_groups=False,
                      reader_pool_type="dummy")
        port = _tagged_outputs(getattr(port_reader_mod, factory)(store, **kwargs), [6, 1, 3])
        jax = _tagged_outputs(getattr(jax_reader_mod, factory)(store, **kwargs), [6, 1, 3])
        assert [p for _, p in port] == [p for _, p in jax]
        assert {p for _, p in port} == {6, 1, 3}
        _assert_rows_equal([o for o, _ in port], [o for o, _ in jax])
        with pytest.raises(ValueError, match="shuffle_row_groups"):
            getattr(port_reader_mod, factory)(store, dynamic_ventilation=True)
        return
    import pyarrow.fs as pafs

    if name == "filesystem":
        value = pafs.LocalFileSystem()
    port, jax = _read_both(factory, store, port_kwargs={name: value}, jax_kwargs={name: value},
                           reader_pool_type="dummy", shuffle_row_groups=True, shard_seed=5)
    assert len(port) == (3 * GROUP if name == "piece_indices" else ROWS)
    _assert_rows_equal(port, jax)
    with pytest.raises(TypeError, match="unexpected keyword"):
        getattr(port_reader_mod, factory)(store, no_such_argument=1)


#: The process pool and its copy mode, once unported: each delivers every
#: row of one epoch, the rows the dummy pool delivers.
PROCESS_POOL_ARGS = [("zmq_copy_buffers", False), ("reader_pool_type", "process")]


@pytest.mark.parametrize("name,value", PROCESS_POOL_ARGS, ids=[n for n, _ in PROCESS_POOL_ARGS])
@pytest.mark.parametrize("factory", FACTORIES)
def test_process_pool_arguments_deliver_every_row(store, factory, name, value):
    kwargs = dict(dict(reader_pool_type="process", workers_count=2, shuffle_row_groups=False),
                  **{name: value})
    got = _rows(getattr(port_reader_mod, factory)(store, **kwargs))
    want = _rows(getattr(port_reader_mod, factory)(store, reader_pool_type="dummy",
                                                   shuffle_row_groups=False))
    assert sorted(int(r["idx"]) for r in got) == list(range(ROWS))
    key = lambda r: int(r["idx"])  # noqa: E731
    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert g.keys() == w.keys()
        for k in g:  # NaN (a null float) equals NaN here
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
    with pytest.raises(ValueError, match="reader_pool_type"):
        getattr(port_reader_mod, factory)(store, reader_pool_type="processes")
