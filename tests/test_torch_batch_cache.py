"""The port's decoded-batch cache modules against the JAX package's, on the
same numpy inputs made from seeds:

- the seed tree (``fold_in``, ``permutation``, ``piece_order``,
  ``batch_permutation``) gives the JAX integers;
- ``batch_fingerprint`` gives the JAX key and refuses order-dependent
  ingredients;
- the payload codec's frames equal the JAX frames byte for byte (pickle,
  columnar, Arrow), so cache entries are the same bytes;
- ``BatchCache``: the memory round trip, the memory LRU, the disk tier
  across cache instances, its budget, a corrupt entry as a miss, an old
  format's entry as a version eviction, ``CacheConfig``, ``cleanup``, the
  ``stats()`` keys, and disk entries written by either package served by
  the other's.

Tolerance: none; everything is compared exactly.
"""

import datetime
import os

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.cache_impl import BatchCache as JaxBatchCache
from petastorm_tpu.cache_impl import batch_fingerprint as jax_batch_fingerprint
from petastorm_tpu.reader_impl import framed_socket as jax_framed
from petastorm_tpu.service import seedtree as jax_seedtree
from petastorm_tpu_torch import cache_impl as port_cache_impl
from petastorm_tpu_torch.cache_impl import BatchCache, CacheConfig, batch_fingerprint
from petastorm_tpu_torch.cache_impl import batch_cache as port_batch_cache
from petastorm_tpu_torch.reader_impl import framed_socket as port_framed
from petastorm_tpu_torch.service import seedtree


@pytest.fixture(autouse=True)
def no_leaked_cache_dirs():
    """Fails a test that leaves a directory in the port's cache registry
    (the suite's own guard watches the JAX package's)."""
    before = port_cache_impl.live_cache_dirs()
    yield
    leaked = port_cache_impl.live_cache_dirs() - before
    assert not leaked, f"cache dirs left registered: {sorted(leaked)}"


def column_batch(seed, kib=8):
    """A batch the codec sends columnar: plain numeric columns."""
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(4, kib * 32).astype(np.float64),
            "image": rng.randint(0, 256, (4, 6, 6, 3), dtype=np.uint8),
            "i": np.arange(4, dtype=np.int64)}


def row_batch(seed):
    """A batch the codec pickles: an object column (strings) and a ragged
    one beside numeric columns."""
    rng = np.random.RandomState(seed)
    names = np.empty(3, dtype=object)
    names[:] = [f"r{seed}-{i}" for i in range(3)]
    ragged = np.empty(3, dtype=object)
    for i in range(3):
        ragged[i] = rng.rand(i + 1).astype(np.float32)
    return {"name": names, "ragged": ragged, "label": rng.randint(0, 9, 3).astype(np.int32),
            "vec": rng.rand(3, 5).astype(np.float32)}


BATCHES = {"column": column_batch, "row": row_batch}


def assert_batch_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, name
        if w.dtype == object:
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(g, w)


# -- seed tree ----------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 9, 64])
@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 70 + 5])
def test_seedtree_equals_jax(seed, n):
    for data in (("cache-epoch", 3), "x", 12, ("epoch", 0, ("piece", 2))):
        assert seedtree.fold_in(seed, data) == jax_seedtree.fold_in(seed, data)
    key = seedtree.fold_in(seed, ("cache-epoch", n))
    assert seedtree.permutation(key, n) == jax_seedtree.permutation(key, n)
    assert sorted(seedtree.permutation(key, n)) == list(range(n))
    for epoch, piece in ((0, 0), (2, 5)):
        assert seedtree.batch_permutation(seed, epoch, piece, n) == \
            jax_seedtree.batch_permutation(seed, epoch, piece, n)
        assert seedtree.piece_key(seed, epoch, piece) == \
            jax_seedtree.piece_key(seed, epoch, piece)
    pieces = list(range(n))[::-1]
    for s in (seed, None):
        assert seedtree.piece_order(s, 1, pieces) == jax_seedtree.piece_order(s, 1, pieces)
    assert seedtree.batch_permutation(None, 0, 0, n) == list(range(n))


# -- fingerprint ----------------------------------------------------------------

_BASE = dict(dataset_url="file:///ds", pieces=[("file:///ds/p0.parquet", 3)], batch_size=64,
             fields=["a", "b"], transform=None, factory="Reader/PyDictResultsQueueReader",
             extra={"last_batch": "drop", "max_batches": None, "num_epochs": 1,
                    "predicate": "None", "resume": "None"})
FINGERPRINT_CASES = {
    "base": {},
    "url": dict(dataset_url="file:///other"),
    "pieces": dict(pieces=[4, 5]),
    "batch_size": dict(batch_size=65),
    "fields": dict(fields=["a"]),
    "transform": dict(transform="TransformSpec(f)"),
    "factory": dict(factory="Reader/ColumnarResultsQueueReader"),
    "extra": dict(extra={"filters": [("day", "=", 1)], "num_epochs": 2}),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINT_CASES))
def test_fingerprint_equals_jax(case):
    kwargs = dict(_BASE, **FINGERPRINT_CASES[case])
    key = batch_fingerprint(**kwargs)
    assert key == jax_batch_fingerprint(**kwargs)
    assert (key == batch_fingerprint(**_BASE)) == (case == "base")


@pytest.mark.parametrize("extra", [{"seed": 1}, {"shuffle_seed": 7}, {"Epoch": 2},
                                   {"nested": [{"piece_order": [1, 0]}]}])
def test_fingerprint_refuses_order_dependent_keys(extra):
    for fingerprint in (batch_fingerprint, jax_batch_fingerprint):
        with pytest.raises(ValueError, match="order-dependent"):
            fingerprint(**dict(_BASE, extra=extra))


@pytest.mark.parametrize("kind", ["none", "in_set", "column", "column_in"])
def test_predicate_ingredient_equals_jax(kind):
    from petastorm_tpu import predicates as jax_predicates
    from petastorm_tpu.cache_impl import predicate_ingredient as jax_predicate_ingredient
    from petastorm_tpu_torch import predicates as port_predicates
    from petastorm_tpu_torch.cache_impl import predicate_ingredient

    def make(module):
        return {"none": lambda: None,
                "in_set": lambda: module.in_set({3, 1}, "label"),
                "column": lambda: module.ColumnPredicate("digit", "ge", 6),
                "column_in": lambda: module.ColumnPredicate("part", "in", ["p1", "p4"])}[kind]()

    got = predicate_ingredient(make(port_predicates))
    assert got == jax_predicate_ingredient(make(jax_predicates))
    assert batch_fingerprint(**dict(_BASE, extra={"predicate": got})) == \
        jax_batch_fingerprint(**dict(_BASE, extra={"predicate": got}))


# -- payload codec ----------------------------------------------------------------

def _datetime_batch(seed):
    return {"when": np.array(["2024-01-0%d" % (seed + 1), "2024-02-01"], dtype="M8[D]"),
            "text": np.array(["ab", "c"])}


PAYLOADS = {
    "column": lambda: column_batch(0),
    "row": lambda: row_batch(1),
    "datetime_and_fixed_strings": lambda: _datetime_batch(2),
    "bfloat16_like_void": lambda: {"v": np.zeros(3, dtype="V2")},
    "arrow_table": lambda: pa.table({"a": [1, 2, 3], "b": ["x", "y", None]}),
    "list_of_rows": lambda: [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}],
    "none": lambda: None,
}


@pytest.mark.parametrize("kind", sorted(PAYLOADS))
def test_payload_frames_equal_jax(kind):
    payload = PAYLOADS[kind]()
    fmt, frames = port_framed.encode_payload(payload)
    jax_fmt, jax_frames = jax_framed.encode_payload(payload)
    assert fmt == jax_fmt
    assert [bytes(memoryview(f)) for f in frames] == [bytes(memoryview(f)) for f in jax_frames]
    decoded = port_framed.decode_payload(fmt, [bytes(memoryview(f)) for f in frames])
    if isinstance(payload, dict):
        assert_batch_equal(decoded, payload)
    elif isinstance(payload, pa.Table):
        assert decoded.equals(payload)
    else:
        assert decoded == payload
    want_fmt = {"column": port_framed.PAYLOAD_COLUMNAR, "row": port_framed.PAYLOAD_PICKLE,
                "arrow_table": port_framed.PAYLOAD_ARROW, "none": port_framed.PAYLOAD_NONE}
    assert fmt == want_fmt.get(kind, fmt)


# -- BatchCache -------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_mem_roundtrip_is_byte_identical(kind):
    batches = [BATCHES[kind](0), BATCHES[kind](1)]
    cache = BatchCache(mem_budget_bytes=8 << 20)
    cache.put_batches("k", batches)
    entry = cache.get("k")
    fresh = b"".join(bytes(memoryview(frame)) for batch in batches
                     for frame in jax_framed.encode_payload(batch)[1])
    assert bytes(entry.buf) == fresh
    for got, want in zip(cache.get_batches("k"), batches):
        assert_batch_equal(got, want)
    assert cache.stats()["hits_mem"] == 2
    cache.cleanup()


def test_served_batches_cannot_write_into_the_cache():
    """Columnar batches come back as read-only views over the entry;
    pickled ones are copies. Either way the entry's bytes stay as cached."""
    cache = BatchCache(mem_budget_bytes=8 << 20)
    cache.put_batches("c", [column_batch(0)])
    cache.put_batches("r", [row_batch(0)])
    column = cache.get("c").batch_at(0).to_dict()
    with pytest.raises(ValueError, match="read-only"):
        column["x"][0] = -1.0
    row = cache.get("r").batch_at(0).to_dict()
    row["vec"][...] = -1.0
    assert_batch_equal(cache.get("r").batch_at(0).to_dict(), row_batch(0))
    cache.cleanup()


def test_mem_budget_lru_eviction():
    cache = BatchCache(mem_budget_bytes=64 << 10)
    for i in range(12):  # ~9 KiB entries: 12 exceed the budget
        cache.put_batches(f"k{i}", [column_batch(i)])
    stats = cache.stats()
    assert stats["bytes_mem"] <= 64 << 10
    assert stats["evictions_mem"] > 0
    assert cache.get("k0") is None  # least recently used went first
    assert cache.get("k11") is not None
    cache.cleanup()


def test_disk_tier_survives_a_new_cache(tmp_path):
    first = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    batches = [column_batch(3), column_batch(4)]
    first.put_batches("epoch", batches)
    first.cleanup()
    assert os.listdir(tmp_path)  # a caller's directory persists
    second = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    entry, tier = second.get_tiered("epoch")
    assert tier == "disk"
    for got, want in zip(entry.to_dicts(), batches):
        assert_batch_equal(got, want)
    assert second.get_tiered("epoch")[1] == "mem"  # promoted
    stats = second.stats()
    assert (stats["hits_disk"], stats["hits_mem"], stats["misses"]) == (1, 1, 0)
    second.cleanup()


def test_disk_budget_evicts_least_recently_used(tmp_path):
    cache = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True,
                       disk_budget_bytes=40 << 10)
    for i in range(8):
        cache.put_batches(f"k{i}", [column_batch(i)])
        os.utime(cache._entry_path(f"k{i}"), (1000 + i, 1000 + i))
    files = [n for n in os.listdir(tmp_path) if n.endswith(".ptbc")]
    assert sum(os.path.getsize(tmp_path / n) for n in files) <= 40 << 10
    assert cache.stats()["evictions_disk"] == 8 - len(files)
    assert os.path.exists(cache._entry_path("k7"))
    assert not os.path.exists(cache._entry_path("k0"))
    cache.cleanup()


def _corrupt(path, how):
    blob = bytearray(open(path, "rb").read())
    if how == "truncated":
        blob = blob[:len(blob) - 100]
    elif how == "bit_flip":
        blob[-10] ^= 0xFF
    elif how == "garbage":
        blob = bytearray(b"not a cache entry at all")
    elif how == "header_length":
        blob[len(port_batch_cache._MAGIC):len(port_batch_cache._MAGIC) + 8] = b"\xff" * 8
    open(path, "wb").write(bytes(blob))


@pytest.mark.parametrize("how", ["truncated", "bit_flip", "garbage", "header_length"])
def test_corrupt_disk_entry_is_a_miss(tmp_path, how):
    writer = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    writer.put_batches("k", [column_batch(0)])
    path = writer._entry_path("k")
    writer.cleanup()
    _corrupt(path, how)
    reader = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    assert reader.get("k") is None
    stats = reader.stats()
    assert (stats["corrupt_entries"], stats["misses"], stats["version_evicted"]) == (1, 1, 0)
    assert not os.path.exists(path)
    reader.cleanup()


@pytest.mark.parametrize("magic", [b"PTBCACHE1\n", b"PTBCACHE2\n"])
def test_old_format_entry_is_version_evicted(tmp_path, magic):
    writer = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    writer.put_batches("k", [column_batch(0)])
    path = writer._entry_path("k")
    writer.cleanup()
    blob = open(path, "rb").read()
    open(path, "wb").write(magic + blob[len(port_batch_cache._MAGIC):])
    reader = BatchCache(mem_budget_bytes=1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    assert reader.get("k") is None
    stats = reader.stats()
    assert (stats["version_evicted"], stats["corrupt_entries"], stats["misses"]) == (1, 0, 1)
    assert not os.path.exists(path)
    reader.cleanup()


@pytest.mark.parametrize("mode", ["off", "mem", "mem+disk"])
def test_cache_config_modes(tmp_path, mode):
    kwargs = dict(cache_dir=str(tmp_path / "c"), disk_mb=4) if mode == "mem+disk" else {}
    cache = CacheConfig(mode, mem_mb=2, **kwargs).build()
    if mode == "off":
        assert cache is None
        return
    stats = cache.stats()
    assert stats["mode"] == mode and stats["mem_budget_bytes"] == 2 << 20
    assert stats["cache_dir"] == kwargs.get("cache_dir")
    if mode == "mem+disk":
        assert cache._disk_budget == 4 << 20 and os.path.isdir(stats["cache_dir"])
    cache.cleanup()


@pytest.mark.parametrize("kwargs", [dict(mode="bogus"), dict(mode="mem", cache_dir="/x"),
                                    dict(mode="off", disk_mb=4)])
def test_cache_config_refusals(kwargs):
    with pytest.raises(ValueError):
        CacheConfig(**kwargs)
    with pytest.raises(ValueError, match="positive"):
        BatchCache(mem_budget_bytes=0)


def test_cleanup_removes_a_private_dir_and_keeps_a_callers(tmp_path):
    private = BatchCache(spill_to_disk=True)
    private.put_batches("k", [column_batch(0)])
    assert private.cache_dir in port_cache_impl.live_cache_dirs()
    private.cleanup()
    assert not os.path.exists(private.cache_dir)
    made = tmp_path / "made"
    callers = BatchCache(cache_dir=made, spill_to_disk=True)
    callers.put_batches("k", [column_batch(0)])
    assert str(made) in port_cache_impl.live_cache_dirs()  # this cache created it
    callers.cleanup()
    assert os.listdir(made) and str(made) not in port_cache_impl.live_cache_dirs()
    assert callers.stats()["entries_mem"] == 0


def test_stats_keys_equal_jax(tmp_path):
    for disk in (False, True):
        def kwargs(name):
            return dict(cache_dir=tmp_path / name, spill_to_disk=True) if disk else {}

        port, jax = BatchCache(1 << 20, **kwargs("port")), JaxBatchCache(1 << 20, **kwargs("jax"))
        for cache in (port, jax):
            cache.put_batches("k", [row_batch(0)])
            cache.get("k")
            cache.get("missing")
            cache.note_permuted_serve("mem")
        got, want = port.stats(), jax.stats()
        got.pop("cache_dir")
        want.pop("cache_dir")
        assert got == want  # the same counts and bytes, key for key
        port.cleanup()
        jax.cleanup()


@pytest.mark.parametrize("kind", sorted(BATCHES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_entry_served_by_the_other_package(tmp_path, writer, kind):
    caches = {"jax": JaxBatchCache, "port": BatchCache}
    reader_name = "port" if writer == "jax" else "jax"
    batches = [BATCHES[kind](5), BATCHES[kind](6), BATCHES[kind](7)]
    filled = caches[writer](1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    filled.put_batches("epoch-key", batches)
    filled.cleanup()
    serving = caches[reader_name](1 << 20, cache_dir=tmp_path, spill_to_disk=True)
    entry = serving.get("epoch-key")
    assert entry is not None and serving.stats()["hits_disk"] == 1
    assert [entry.batch_at(i).rows for i in range(3)] == \
        [port_batch_cache.batch_rows(b) for b in batches]
    for got, want in zip(entry.to_dicts(), batches):
        assert_batch_equal(got, want)
    serving.cleanup()


def test_entry_index_seeks_each_batch():
    batches = [column_batch(i, kib=i + 1) for i in range(4)]
    cache = BatchCache(mem_budget_bytes=8 << 20)
    entry = cache.put_batches("k", batches)
    assert (entry.num_batches, entry.rows) == (4, 16)
    for index in (3, 0, 2, 1):
        assert_batch_equal(entry.batch_at(index).to_dict(), batches[index])
    cache.cleanup()


def test_datetime_columns_survive_the_cache():
    batch = {"when": np.array([datetime.date(2024, 1, 1), datetime.date(2024, 3, 2)],
                              dtype="M8[D]"), "n": np.arange(2)}
    cache = BatchCache(mem_budget_bytes=1 << 20)
    cache.put_batches("k", [batch])
    assert_batch_equal(cache.get_batches("k")[0], batch)
    cache.cleanup()
