"""``Reader.reset()`` and the live ``Reader.diagnostics`` of the port against
the JAX reader, for all three factories and both pools.

- ``reset()`` after the last row replays the same ids (in the same order
  with the dummy pool and a seeded shuffle, as the same set with the
  thread pool); it refuses mid-epoch and on a resumed reader, in both
  packages; a ``state_dict()`` after it describes the new pass, and a
  loader re-iterated after it checkpoints from the new pass's rows.
- ``diagnostics`` has the JAX reader's key set mid-epoch and at the end,
  merged in its order (planning facts, then the pool's counters, then the
  ventilator's, which win on ``items_in_flight``), and at the end of an
  epoch the JAX reader's values.

Stores: each test writes its own under ``tmp_path`` through the port's
``test_util`` factories (40 token documents in 4 row groups; a 40-row
plain Parquet store in 4 row groups). Everything is compared exactly.
"""

import types

import pytest

import petastorm_tpu as jax_pkg
from petastorm_tpu_torch.reader import reader as port_reader
from petastorm_tpu_torch.test_util.dataset_factory import (
    create_test_scalar_dataset,
    create_test_token_dataset,
)

FACTORIES = ["make_reader", "make_columnar_reader", "make_batch_reader"]
POOLS = ["dummy", "thread"]


@pytest.fixture
def urls(tmp_path):
    token, scalar = f"file://{tmp_path}/tokens", f"file://{tmp_path}/scalar"
    create_test_token_dataset(token, rows_count=40, rows_per_row_group=10)
    create_test_scalar_dataset(scalar, rows_count=40, rows_per_row_group=10)
    return {"make_reader": token, "make_columnar_reader": token, "make_batch_reader": scalar}


def _open(package, factory, url, pool, **kwargs):
    module = port_reader if package == "port" else jax_pkg
    kwargs.setdefault("shard_seed", 3)
    return getattr(module, factory)(url, reader_pool_type=pool, workers_count=2,
                                    schema_fields=["id"], **kwargs)


def _ids(items):
    out = []
    for item in items:
        ids = item.id
        out.extend([int(ids)] if getattr(ids, "ndim", 0) == 0 else ids.tolist())
    return out


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("factory", FACTORIES)
def test_reset_replays_like_jax(urls, factory, pool):
    passes = {}
    for package in ("port", "jax"):
        with _open(package, factory, urls[factory], pool) as reader:
            first = _ids(reader)
            reader.reset()
            second = _ids(reader)
            reader.reset()
            third = _ids(reader)
        passes[package] = (first, second, third)
    port, jax = passes["port"], passes["jax"]
    for got in port:
        assert sorted(got) == list(range(40))
    if pool == "dummy":  # one decode order: the seeded shuffle, continued
        assert port == jax
    else:
        assert [sorted(p) for p in port] == [sorted(j) for j in jax]


@pytest.mark.parametrize("factory", FACTORIES)
def test_reset_refusals_match_jax(urls, factory):
    for package in ("port", "jax"):
        with _open(package, factory, urls[factory], "dummy") as reader:
            next(reader)
            with pytest.raises(NotImplementedError, match="after all rows were consumed"):
                reader.reset()
            state = reader.state_dict()
        with _open(package, factory, urls[factory], "dummy", resume_state=state) as resumed:
            _ids(resumed)
            with pytest.raises(NotImplementedError, match="resumed reader"):
                resumed.reset()


@pytest.mark.parametrize("factory", FACTORIES)
def test_state_dict_after_reset_describes_the_new_pass(urls, factory):
    states = {}
    for package in ("port", "jax"):
        with _open(package, factory, urls[factory], "dummy") as reader:
            _ids(reader)
            full = reader.state_dict()
            reader.reset()
            fresh = reader.state_dict()
            # Two row groups' worth of items: rows one by one, or batches.
            for _ in range(20 if factory == "make_reader" else 2):
                next(reader)
            states[package] = (full, fresh, reader.state_dict())
    assert states["port"] == states["jax"]
    full, fresh, partial = states["port"]
    assert sum(full["delivered"].values()) == 4 and fresh["delivered"] == {}
    delivered = sum(partial["delivered"].values())
    assert 1 <= delivered <= 2
    # The partial state resumes the rest of the new pass.
    with _open("port", factory, urls[factory], "dummy", resume_state=partial) as resumed:
        assert len(_ids(resumed)) == 40 - 10 * delivered


def test_loader_checkpoints_the_new_pass_after_reset(urls):
    """A loader re-iterated after ``reader.reset()`` rolls back to the rows
    it yielded in the new pass, as a fresh reader and loader would."""
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    def mid_pass_state(reader, loader):
        it = iter(loader)
        for _ in range(3):
            next(it)
        return loader.state_dict()

    url = urls["make_reader"]
    with _open("port", "make_reader", url, "dummy", shuffle_row_groups=False) as reader:
        loader = make_torch_dataloader(reader, 4, device="cpu", host_prefetch=4)
        with loader:
            assert sum(len(b["id"]) for b in loader) == 40
            reader.reset()
            after_reset = mid_pass_state(reader, loader)
    with _open("port", "make_reader", url, "dummy", shuffle_row_groups=False) as first_reader:
        with make_torch_dataloader(first_reader, 4, device="cpu", host_prefetch=4) as loader:
            fresh = mid_pass_state(first_reader, loader)
    assert after_reset["delivered"] == fresh["delivered"]
    assert sum(after_reset["delivered"].values()) <= 1  # 12 rows yielded: one group at most


def _diagnostics_pair(urls, factory, pool, consume):
    out = {}
    for package in ("port", "jax"):
        with _open(package, factory, urls[factory], pool) as reader:
            if consume is None:
                _ids(reader)
            else:
                for _ in range(consume):
                    next(reader)
            out[package] = reader.diagnostics
    return out["port"], out["jax"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("factory", FACTORIES)
def test_diagnostics_keys_and_end_values_match_jax(urls, factory, pool):
    mid_port, mid_jax = _diagnostics_pair(urls, factory, pool, consume=1)
    assert list(mid_port) == list(mid_jax) and len(mid_port) == 9
    assert mid_port["items_ventilated"] > 0 and mid_port["epochs_completed"] in (0, 1)
    if pool == "dummy":  # processed inline as ventilated
        assert mid_port["items_processed"] > 0
    end_port, end_jax = _diagnostics_pair(urls, factory, pool, consume=None)
    assert end_port == end_jax
    assert end_port == {"rowgroups_total": 4, "items_per_epoch": 4, "workers_count": 2 if
                        pool == "thread" else 1, "items_ventilated": 4, "items_processed": 4,
                        "items_in_flight": 0, "results_queue_size": 0,
                        "epochs_completed": 1, "ventilation_completed": True}


def test_diagnostics_merge_order_matches_jax(urls):
    """Planning facts, then the pool's counters, then the ventilator's: the
    ventilator's ``items_in_flight`` and ``items_ventilated`` win."""
    merged = {}
    for package in ("port", "jax"):
        with _open(package, "make_reader", urls["make_reader"], "dummy") as reader:
            _ids(reader)
            real_pool, real_ventilator = reader._workers_pool, reader._ventilator
            reader._workers_pool = types.SimpleNamespace(diagnostics={
                "items_in_flight": "pool", "items_ventilated": "pool", "workers_count": "pool",
                "items_processed": "pool"})
            reader._ventilator = types.SimpleNamespace(diagnostics={
                "items_in_flight": "ventilator", "items_ventilated": "ventilator"})
            merged[package] = reader.diagnostics
            reader._workers_pool, reader._ventilator = real_pool, real_ventilator
    assert merged["port"] == merged["jax"]
    assert merged["port"]["items_in_flight"] == "ventilator"
    assert merged["port"]["workers_count"] == merged["port"]["items_processed"] == "pool"


def test_pool_counters_hold_under_thread_switching(tmp_path):
    """16 decode threads (more than the cores) and a 1 µs switch interval:
    a lost counter update would leave ``items_processed`` short of the
    items ventilated, or a payload counted in ``results_queue_size``."""
    import sys

    url = f"file://{tmp_path}/many"
    create_test_scalar_dataset(url, rows_count=240, rows_per_row_group=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            with port_reader.make_batch_reader(url, workers_count=16, num_epochs=2,
                                               results_queue_size=4) as reader:
                assert sorted(_ids(reader)) == sorted(list(range(240)) * 2)
                end = reader.diagnostics
            assert end["items_ventilated"] == end["items_processed"] == 240
            assert end["items_in_flight"] == end["results_queue_size"] == 0
            assert end["epochs_completed"] == 2 and end["ventilation_completed"]
    finally:
        sys.setswitchinterval(interval)
