"""The loader's decoded-batch cache, against ``JaxDataLoader`` on the same
store (written by the port from seeded numpy data; each test writes its
own), on all three reader factories with the dummy pool: the JAX loader
runs with ``stage_to_device=False``, the port's with ``device="cpu"``.

- unseeded: three passes, the JAX batches in value, dtype and order, the
  second and third a byte-exact replay of the first;
- seeded: three passes in the JAX order, pass ``k`` the canonical entry
  permuted by ``permutation(fold_in(seed, ("cache-epoch", k)), n)``, the
  same multiset as an unshuffled run;
- the cache key equals the JAX key and ignores every shuffle ingredient;
  a ``shuffle_row_groups`` reader with ``shard_seed``;
- ``cache_resume`` mid-pass and at a pass boundary, the seed-mismatch
  error, a ``cache_replay`` state crossing the packages both ways, and a
  disk tier one package fills and the other serves;
- the refusals, and an abandoned pass that never commits.

Tolerance: none; everything is compared exactly.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu.cache_impl import BatchCache as JaxBatchCache
from petastorm_tpu.jax_utils.loader import JaxDataLoader
from petastorm_tpu_torch import cache_impl as port_cache_impl
from petastorm_tpu_torch.cache_impl import BatchCache
from petastorm_tpu_torch.service.seedtree import fold_in, permutation
from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader, make_torch_dataloader

ROWS, GROUP, BATCH = 120, 20, 16  # 6 row groups, 8 batches (the last of 8 rows)
FACTORIES = ["make_reader", "make_columnar_reader", "make_batch_reader"]


@pytest.fixture(autouse=True)
def no_leaked_cache_dirs():
    """Fails a test that leaves a directory in the port's cache registry
    (the suite's own guard watches the JAX package's)."""
    before = port_cache_impl.live_cache_dirs()
    yield
    leaked = port_cache_impl.live_cache_dirs() - before
    assert not leaked, f"cache dirs left registered: {sorted(leaked)}"


def write_store(tmp_path):
    """id, label, name (string), image (png 8x8x3), vec (ndarray f32 (4,));
    6 row groups of 20."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("CacheSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
        UnischemaField("name", str, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, (8, 8, 3), CompressedImageCodec("png"), False),
        UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(3)
    url = f"file://{tmp_path}/store"
    materialize_rows(url, schema, ({
        "id": i, "label": i % 10, "name": f"row{i}",
        "image": rng.randint(0, 256, (8, 8, 3), dtype=np.uint8),
        "vec": rng.rand(4).astype(np.float32)} for i in range(ROWS)),
        rows_per_row_group=GROUP)
    return url


def _reader(module, factory, url, **kwargs):
    kwargs = {"reader_pool_type": "dummy", "num_epochs": 1, "shuffle_row_groups": False,
              **kwargs}
    return getattr(module, factory)(url, **kwargs)


def port_loader(factory, url, cache, reader_kwargs=None, **kwargs):
    reader = _reader(port_reader_mod, factory, url, **(reader_kwargs or {}))
    return make_torch_dataloader(reader, BATCH, last_batch="keep", device="cpu",
                                 batch_cache=cache, **kwargs)


def jax_loader(factory, url, cache, reader_kwargs=None, **kwargs):
    reader = _reader(jax_reader_mod, factory, url, **(reader_kwargs or {}))
    return JaxDataLoader(reader, BATCH, last_batch="keep", stage_to_device=False,
                         batch_cache=cache, **kwargs)


def _numpy(batch):
    return {name: col.numpy() if torch.is_tensor(col) else np.asarray(col)
            for name, col in batch.items()}


def assert_batches_equal(got, want):
    """Two batch sequences equal in field names, value, dtype and order."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _numpy(g), _numpy(w)
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            if w[name].dtype == object:
                assert len(g[name]) == len(w[name])
                for x, y in zip(g[name], w[name]):
                    if isinstance(y, np.ndarray):
                        np.testing.assert_array_equal(x, y)
                    else:
                        assert x == y, name
            else:
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def digests(batches):
    """Order-sensitive per-batch content digests."""
    out = []
    for batch in batches:
        batch = _numpy(batch)
        h = hashlib.blake2b(digest_size=16)
        for name in sorted(batch):
            h.update(name.encode())
            col = batch[name]
            if col.dtype == object:
                for item in col:
                    h.update(item if isinstance(item, bytes) else repr(
                        np.asarray(item).tolist()).encode())
            else:
                h.update(np.ascontiguousarray(col).tobytes())
        out.append(h.hexdigest())
    return out


def run_passes(loader, passes):
    with loader:
        return [list(loader) for _ in range(passes)]


@pytest.mark.parametrize("factory", FACTORIES)
def test_plain_replay_equals_jax(tmp_path, factory):
    url = write_store(tmp_path)
    cache, jax_cache = BatchCache(1 << 26), JaxBatchCache(1 << 26)
    got = run_passes(port_loader(factory, url, cache), 3)
    want = run_passes(jax_loader(factory, url, jax_cache), 3)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    assert_batches_equal(got[1], got[0])
    assert_batches_equal(got[2], got[0])
    assert sum(len(b["id"]) for b in got[0]) == ROWS
    stats = cache.stats()
    assert (stats["misses"], stats["hits"], stats["permuted_serves"]) == (1, 2, 0)
    assert {k: v for k, v in stats.items() if k != "cache_dir"} == \
        {k: v for k, v in jax_cache.stats().items() if k != "cache_dir"}
    cache.cleanup()
    jax_cache.cleanup()


@pytest.mark.parametrize("factory", FACTORIES)
def test_seeded_replay_permutes_per_pass_in_jax_order(tmp_path, factory):
    url = write_store(tmp_path)
    cache, jax_cache = BatchCache(1 << 26), JaxBatchCache(1 << 26)
    got = run_passes(port_loader(factory, url, cache, shuffle_seed=7), 3)
    want = run_passes(jax_loader(factory, url, jax_cache, shuffle_seed=7), 3)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    canonical = digests(run_passes(port_loader(factory, url, BatchCache(1 << 26)), 1)[0])
    n = len(canonical)
    for k, batches in enumerate(got):
        order = permutation(fold_in(7, ("cache-epoch", k)), n)
        assert digests(batches) == [canonical[i] for i in order]
    assert len({tuple(digests(p)) for p in got}) == 3
    stats = cache.stats()
    assert (stats["misses"], stats["hits"], stats["permuted_serves"]) == (1, 2, 3)
    cache.cleanup()
    jax_cache.cleanup()


@pytest.mark.parametrize("factory", FACTORIES)
def test_seeded_multiset_equals_unshuffled(tmp_path, factory):
    url = write_store(tmp_path)
    plain_cache, seeded_cache = BatchCache(1 << 26), BatchCache(1 << 26)
    plain = digests(run_passes(port_loader(factory, url, plain_cache), 1)[0])
    seeded = digests(run_passes(port_loader(factory, url, seeded_cache, shuffle_seed=7), 1)[0])
    assert seeded != plain
    assert sorted(seeded) == sorted(plain)
    plain_cache.cleanup()
    seeded_cache.cleanup()


@pytest.mark.parametrize("factory", FACTORIES)
def test_key_equals_jax_and_ignores_shuffle_config(tmp_path, factory):
    url = write_store(tmp_path)

    def key(make, **kwargs):
        with make(factory, url, None, **kwargs) as loader:
                return loader._reader_cache_key()

    base = key(port_loader)
    assert key(jax_loader) == base
    assert key(port_loader, shuffle_seed=7) == base
    assert key(port_loader, shuffle_seed=8) == base
    assert key(port_loader, reader_kwargs=dict(shuffle_row_groups=True, shard_seed=2)) == base
    if factory == "make_reader":
        assert key(port_loader, shuffle_buffer_size=16, shuffle_seed=3) == base
    assert key(port_loader, max_batches=3) != base


@pytest.mark.parametrize("factory", FACTORIES)
def test_shuffled_reader_with_shard_seed(tmp_path, factory):
    """A seeded ``shuffle_row_groups`` reader: the fill is its first pass's
    order, replays permute by ``shard_seed``, both as the JAX loader does,
    and every pass holds every row once."""
    url = write_store(tmp_path)
    reader_kwargs = dict(shuffle_row_groups=True, shard_seed=3)
    cache, jax_cache = BatchCache(1 << 26), JaxBatchCache(1 << 26)
    got = run_passes(port_loader(factory, url, cache, reader_kwargs), 2)
    want = run_passes(jax_loader(factory, url, jax_cache, reader_kwargs), 2)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
        assert sorted(int(i) for b in g for i in b["id"]) == list(range(ROWS))
    assert digests(got[0]) != digests(got[1])
    assert cache.stats()["hits"] == 1
    cache.cleanup()
    jax_cache.cleanup()


@pytest.mark.parametrize("stop_after", [3, "pass"])
def test_cache_resume_mid_pass_and_at_boundary(tmp_path, stop_after):
    """A state_dict() after 3 batches resumes the permuted pass at batch 3;
    one after a whole pass rolls forward to the next pass's start. The
    resumed loader has a fresh reader and a fresh (cold) cache."""
    url = write_store(tmp_path)
    full_cache = BatchCache(1 << 26)
    full = [digests(p) for p in
            run_passes(port_loader("make_reader", url, full_cache, shuffle_seed=7), 3)]
    cache = BatchCache(1 << 26)
    with port_loader("make_reader", url, cache, shuffle_seed=7) as loader:
        first = digests(list(loader))  # pass 0
        if stop_after == "pass":
            state = loader.state_dict()
            want_tail, want_next = full[1], full[2]
            assert (state["cache_epoch"], state["batches_yielded"]) == (1, 0)
        else:
            iterator = iter(loader)
            head = digests([next(iterator) for _ in range(stop_after)])
            state = loader.state_dict()
            iterator.close()
            assert head == full[1][:stop_after]
            want_tail, want_next = full[1][stop_after:], full[2]
            assert (state["cache_epoch"], state["batches_yielded"]) == (1, stop_after)
    assert first == full[0]
    assert state == {"version": 1, "kind": "cache_replay", "cache_epoch": 1,
                     "batches_yielded": state["batches_yielded"], "shuffle_seed": 7}
    resumed_cache = BatchCache(1 << 26)
    with port_loader("make_reader", url, resumed_cache, shuffle_seed=7,
                     cache_resume=state) as loader:
        assert digests(list(loader)) == want_tail
        assert digests(list(loader)) == want_next
    for c in (full_cache, cache, resumed_cache):
        c.cleanup()


def test_cache_resume_under_another_seed_raises(tmp_path):
    url = write_store(tmp_path)
    state = {"version": 1, "kind": "cache_replay", "cache_epoch": 1, "batches_yielded": 2,
             "shuffle_seed": 7}
    cache = BatchCache(1 << 26)
    with port_loader("make_reader", url, cache, shuffle_seed=8, cache_resume=state) as loader:
        with pytest.raises(ValueError, match="shuffle_seed"):
            list(loader)
    cache.cleanup()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cache_replay_state_crosses_packages(tmp_path, direction):
    """A ``cache_replay`` state dict taken by one package's loader resumes
    the pass in the other's, at the same permuted position."""
    url = write_store(tmp_path)
    first, second = ((jax_loader, port_loader) if direction == "jax_to_port"
                     else (port_loader, jax_loader))
    full_cache = BatchCache(1 << 26)
    full = [digests(p) for p in
            run_passes(port_loader("make_reader", url, full_cache, shuffle_seed=5), 2)]
    caches = [JaxBatchCache(1 << 26) if make is jax_loader else BatchCache(1 << 26)
              for make in (first, second)]
    with first("make_reader", url, caches[0], shuffle_seed=5) as loader:
        list(loader)
        iterator = iter(loader)
        head = [next(iterator) for _ in range(3)]
        state = loader.state_dict()
        iterator.close()
    assert digests(head) == full[1][:3]
    assert state["kind"] == "cache_replay" and state["batches_yielded"] == 3
    with second("make_reader", url, caches[1], shuffle_seed=5, cache_resume=state) as loader:
        assert digests(list(loader)) == full[1][3:]
    for c in caches + [full_cache]:
        c.cleanup()


@pytest.mark.parametrize("direction", ["jax_fills", "port_fills"])
def test_disk_tier_shared_between_packages(tmp_path, direction):
    """One package's loader fills a disk tier; the other's, on a fresh
    cache over the same directory and a fresh reader, replays the epoch
    from it (a disk hit, no fill) with the same batches."""
    url = write_store(tmp_path)
    cache_dir = tmp_path / "tier"
    cache_dir.mkdir()
    fill_cache = (JaxBatchCache if direction == "jax_fills" else BatchCache)(
        1 << 26, cache_dir=cache_dir, spill_to_disk=True)
    serve_cache = (BatchCache if direction == "jax_fills" else JaxBatchCache)(
        1 << 26, cache_dir=cache_dir, spill_to_disk=True)
    fill, serve = ((jax_loader, port_loader) if direction == "jax_fills"
                   else (port_loader, jax_loader))
    want = run_passes(fill("make_columnar_reader", url, fill_cache), 1)[0]
    got = run_passes(serve("make_columnar_reader", url, serve_cache), 1)[0]
    assert_batches_equal(got, want)
    stats = serve_cache.stats()
    assert (stats["hits_disk"], stats["misses"]) == (1, 0)
    fill_cache.cleanup()
    serve_cache.cleanup()


def test_refusals(tmp_path):
    url = write_store(tmp_path)
    cache = BatchCache(1 << 20)
    with pytest.raises(ValueError, match="decode bypass"):
        TorchDataLoader(None, lambda: iter(()), device="cpu", batch_cache=cache)
    state = {"kind": "cache_replay", "cache_epoch": 0}
    reader = _reader(port_reader_mod, "make_reader", url)
    with reader:
        with pytest.raises(ValueError, match="needs batch_cache"):
            make_torch_dataloader(reader, BATCH, device="cpu", cache_resume=state)
        with pytest.raises(ValueError, match="kind 'cache_replay'"):
            make_torch_dataloader(reader, BATCH, device="cpu", batch_cache=cache,
                                  cache_resume={"kind": "reader"})
    shuffled = _reader(port_reader_mod, "make_reader", url, shuffle_row_groups=True)
    with shuffled:
        with pytest.raises(ValueError, match="shard_seed"):
            make_torch_dataloader(shuffled, BATCH, device="cpu", batch_cache=cache,
                                  cache_resume=state)
    cache.cleanup()


def test_unretained_entry_warns(tmp_path):
    """An epoch larger than a memory-only budget is kept nowhere: the fill
    pass says so, and the next pass over the exhausted reader is empty
    and says so too."""
    url = write_store(tmp_path)
    cache = BatchCache(mem_budget_bytes=1024)
    with port_loader("make_columnar_reader", url, cache) as loader:
        with pytest.warns(RuntimeWarning, match="could not retain"):
            assert len(list(loader)) == 8
        with pytest.warns(RuntimeWarning, match="no longer retained"):
            assert list(loader) == []
    cache.cleanup()


def test_partial_iteration_never_commits(tmp_path):
    """An abandoned pass publishes nothing; re-iterating serves the
    reader's tail uncached, and then nothing. Asserts only what holds
    however far the producer read ahead, after stopping and joining it."""
    url = write_store(tmp_path)
    cache = BatchCache(mem_budget_bytes=1 << 26)
    with port_loader("make_reader", url, cache) as loader:
        for _ in loader:
            break
        loader.stop()
        assert cache.stats()["entries_mem"] == 0
        tail = list(loader)
        loader.stop()
        assert len(tail) < 8
        assert cache.stats()["entries_mem"] == 0
        with pytest.warns(RuntimeWarning, match="no longer retained"):
            assert list(loader) == []
        loader.stop()
        assert cache.stats()["entries_mem"] == 0
    assert not [t for t in threading.enumerate() if t.name.startswith("torch-loader")]
    cache.cleanup()
