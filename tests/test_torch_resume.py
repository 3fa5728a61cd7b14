"""Resumable iteration in the port, mirroring ``tests/test_resume.py``, and
across packages: ``state_dict()`` / ``resume_state=`` of the row, columnar
and batch readers and of ``TorchDataLoader``.

Contract: at-least-once at row-group granularity. After an interrupt and a
resume every row is seen at least ``num_epochs`` times over both runs,
fully delivered row groups are never re-read, and the over-delivery is at
most the row group being consumed. The state dict is the JAX package's key
for key and value for value, so a state taken from either package's reader
resumes the other's, with the same remaining rows.

Datasets: the suite's petastorm dataset (30 rows, 3 row groups of 10,
written by the JAX package; read as ``id`` only) and a Criteo-shaped plain
Parquet store (160 rows, 8 row groups of 20). Everything is compared
exactly.
"""

import collections
import time

import numpy as np
import pytest

from petastorm_tpu_torch.reader.reader import (
    make_batch_reader,
    make_columnar_reader,
    make_reader,
)
from petastorm_tpu_torch.reader_impl.delivery_tracker import (
    DeliveryTracker,
    item_key,
    read_table_tag,
    tag_table,
)
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

TABULAR_ROWS = 160


@pytest.fixture(scope="module")
def tabular(tmp_path_factory):
    from petastorm_tpu_torch.models.tabular_dlrm import make_tabular_dataset

    url = f"file://{tmp_path_factory.mktemp('tabular')}/criteo"
    make_tabular_dataset(url, rows=TABULAR_ROWS, dense_cols=2, sparse_cols=2)
    return url


# --- the tracker, tagging and the ventilator -----------------------------

def test_delivery_tracker_counts_and_preload():
    tracker = DeliveryTracker(preload={"0:0": 2})
    tracker.record("0:0")
    tracker.record("1:0")
    assert tracker.counts() == {"0:0": 3, "1:0": 1}


def test_tracker_rollback_uncounts_recent_deliveries():
    tracker = DeliveryTracker(preload={"9:0": 1})
    for key in ("0:0", "1:0", "2:0"):
        tracker.record(key, num_rows=10)
    # 15 of the 30 recorded rows surfaced: the two newest deliveries roll
    # back entirely (whole deliveries only).
    assert tracker.counts_rolled_back_to(15) == {"9:0": 1, "0:0": 1}
    assert tracker.counts_rolled_back_to(30) == {"9:0": 1, "0:0": 1, "1:0": 1, "2:0": 1}
    assert tracker.counts_rolled_back_to(0) == {"9:0": 1}
    assert tracker.total_rows_recorded() == 30


def test_tracker_rollback_past_a_truncated_log_raises(monkeypatch):
    monkeypatch.setattr(DeliveryTracker, "MAX_LOG_ENTRIES", 4)
    tracker = DeliveryTracker()
    for i in range(5):
        tracker.record(f"{i}:0", num_rows=1)
    assert tracker.counts_rolled_back_to(3) == {f"{i}:0": 1 for i in range(3)}
    with pytest.raises(RuntimeError, match="delivery log exhausted"):
        tracker.counts_rolled_back_to(0)


def test_table_tagging_roundtrip():
    import pyarrow as pa

    from petastorm_tpu.reader_impl.delivery_tracker import read_table_tag as jax_read_tag

    table = pa.table({"x": [1, 2]})
    tagged = tag_table(table, item_key(7, 0))
    assert read_table_tag(tagged) == "7:0" == jax_read_tag(tagged)
    assert read_table_tag(table) is None


def _ventilation_order(cls, per_item_iterations, seed):
    order = []
    items = [{"value": i} for i in range(len(per_item_iterations))]

    def ventilate(value):
        order.append(value)
        vent.processed_item()

    vent = cls(ventilate, items, iterations=max(per_item_iterations),
               randomize_item_order=True, random_seed=seed,
               per_item_iterations=per_item_iterations)
    vent.start()
    deadline = time.monotonic() + 10
    while not vent.completed() and time.monotonic() < deadline:
        time.sleep(0.001)
    vent.stop()
    return order


def test_ventilator_per_item_iterations():
    seen = collections.Counter(_ventilation_order(ConcurrentVentilator, [3, 1, 0], seed=0))
    assert dict(seen) == {0: 3, 1: 1}


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_ventilator_per_item_order_equals_jax(seed):
    from petastorm_tpu.workers_pool.ventilator import ConcurrentVentilator as JaxVentilator

    per_item = [2, 1, 0, 3, 2, 1, 3, 0, 2]
    got = _ventilation_order(ConcurrentVentilator, per_item, seed)
    assert got == _ventilation_order(JaxVentilator, per_item, seed)
    assert collections.Counter(got) == {i: n for i, n in enumerate(per_item) if n}


def test_ventilator_per_item_iterations_validation():
    items = [{"value": 0}]
    with pytest.raises(ValueError, match="max"):
        ConcurrentVentilator(lambda **kw: None, items, iterations=2, per_item_iterations=[1])
    with pytest.raises(ValueError, match="parallel"):
        ConcurrentVentilator(lambda **kw: None, items, iterations=1,
                             per_item_iterations=[1, 1])
    with pytest.raises(ValueError, match="finite"):
        ConcurrentVentilator(lambda **kw: None, items, iterations=None,
                             per_item_iterations=[1])


# --- interrupt and resume ----------------------------------------------------

def _read_ids_with_interrupt(url, stop_after, **kwargs):
    """Row ids until ``stop_after``, then the reader's state."""
    ids = []
    with make_reader(url, schema_fields=["id"], shuffle_row_groups=True, **kwargs) as reader:
        for row in reader:
            ids.append(int(row.id))
            if len(ids) >= stop_after:
                break
        state = reader.state_dict()
    return ids, state


def _resume_ids(url, state, **kwargs):
    with make_reader(url, schema_fields=["id"], shuffle_row_groups=True,
                     resume_state=state, **kwargs) as reader:
        return [int(row.id) for row in reader]


def test_resume_row_reader_at_least_once(petastorm_dataset):
    all_ids = {int(r["id"]) for r in petastorm_dataset.rows}
    first, state = _read_ids_with_interrupt(petastorm_dataset.url, 10, num_epochs=1,
                                            reader_pool_type="dummy")
    assert state["version"] == 1
    second = _resume_ids(petastorm_dataset.url, state, num_epochs=1, reader_pool_type="dummy")
    assert set(first) | set(second) == all_ids
    assert len(second) < len(all_ids)  # fully delivered row groups are not re-read


def test_resume_after_full_epoch_yields_nothing(petastorm_dataset):
    with make_reader(petastorm_dataset.url, schema_fields=["id"], num_epochs=1,
                     reader_pool_type="dummy") as reader:
        assert sum(1 for _ in reader) == 30
        state = reader.state_dict()
    with make_reader(petastorm_dataset.url, schema_fields=["id"], num_epochs=1,
                     reader_pool_type="dummy", resume_state=state) as reader:
        assert list(reader) == [] and reader.diagnostics["items_per_epoch"] == 0


def test_resume_multi_epoch_exact_totals(petastorm_dataset):
    epochs = 3
    first, state = _read_ids_with_interrupt(petastorm_dataset.url, 45, num_epochs=epochs,
                                            reader_pool_type="dummy")
    second = _resume_ids(petastorm_dataset.url, state, num_epochs=epochs,
                         reader_pool_type="dummy")
    counts = collections.Counter(first + second)
    assert all(c >= epochs for c in counts.values()) and len(counts) == 30
    over = [k for k, c in counts.items() if c > epochs]
    assert len(over) <= 10 and all(counts[k] == epochs + 1 for k in over)
    assert len(first) + len(second) == 30 * epochs + len(over)


def test_resume_state_mismatch_raises(petastorm_dataset):
    _, state = _read_ids_with_interrupt(petastorm_dataset.url, 3, num_epochs=2,
                                        reader_pool_type="dummy")
    with pytest.raises(ValueError, match="num_epochs"):
        make_reader(petastorm_dataset.url, num_epochs=5, reader_pool_type="dummy",
                    resume_state=state)
    with pytest.raises(ValueError, match="shard"):
        make_reader(petastorm_dataset.url, num_epochs=2, reader_pool_type="dummy",
                    cur_shard=0, shard_count=1, resume_state=state)
    with pytest.raises(ValueError, match="version"):
        make_reader(petastorm_dataset.url, num_epochs=2, reader_pool_type="dummy",
                    resume_state={**state, "version": 2})


def test_resume_rejects_different_dataset(petastorm_dataset, tabular):
    _, state = _read_ids_with_interrupt(petastorm_dataset.url, 3, num_epochs=1,
                                        reader_pool_type="dummy")
    with pytest.raises(ValueError, match="dataset_path"):
        make_batch_reader(tabular, num_epochs=1, reader_pool_type="dummy",
                          resume_state=state)


def test_resume_requires_finite_epochs(petastorm_dataset):
    _, state = _read_ids_with_interrupt(petastorm_dataset.url, 3, num_epochs=1,
                                        reader_pool_type="dummy")
    with pytest.raises(ValueError, match="finite num_epochs"):
        make_reader(petastorm_dataset.url, num_epochs=None, reader_pool_type="dummy",
                    resume_state=state)


def test_resume_columnar_reader(petastorm_dataset):
    kw = dict(schema_fields=["id"], num_epochs=1, reader_pool_type="dummy")
    with make_columnar_reader(petastorm_dataset.url, **kw) as r:
        first_ids = {int(i) for i in next(iter(r)).id}
        state = r.state_dict()
    assert sum(state["delivered"].values()) == 1
    with make_columnar_reader(petastorm_dataset.url, resume_state=state, **kw) as r:
        second_ids = [int(i) for b in r for i in b.id]
    assert first_ids | set(second_ids) == set(range(30)) and len(second_ids) == 20


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_resume_batch_reader(tabular, pool):
    kw = dict(num_epochs=2, reader_pool_type=pool, workers_count=2, shard_seed=4)
    with make_batch_reader(tabular, **kw) as r:
        it = iter(r)
        first = [next(it).sample_index for _ in range(3)]
        state = r.state_dict()
    assert sum(state["delivered"].values()) == 3
    with make_batch_reader(tabular, resume_state=state, **kw) as r:
        second = [b.sample_index for b in r]
    counts = collections.Counter(np.concatenate(first + second).tolist())
    assert len(second) == 13 and counts == {i: 2 for i in range(TABULAR_ROWS)}


def test_resume_rejects_different_filters(tabular):
    with make_batch_reader(tabular, num_epochs=1, reader_pool_type="dummy",
                           filters=[("day", "<", 4)]) as reader:
        next(iter(reader))
        state = reader.state_dict()
    with pytest.raises(ValueError, match="planning"):
        make_batch_reader(tabular, num_epochs=1, reader_pool_type="dummy",
                          filters=[("day", ">=", 4)], resume_state=state)


# --- the loader ----------------------------------------------------------------

def test_loader_state_dict_rejects_shuffle_buffer(petastorm_dataset):
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    reader = make_reader(petastorm_dataset.url, schema_fields=["id"], num_epochs=1,
                         reader_pool_type="dummy")
    with make_torch_dataloader(reader, 4, device="cpu", shuffle_buffer_size=16) as loader:
        next(iter(loader))
        with pytest.raises(ValueError, match="shuffle_buffer_size"):
            loader.state_dict()


def test_loader_state_dict_rejects_a_source_without_one(petastorm_dataset):
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    reader = make_reader(petastorm_dataset.url, schema_fields=["id"], num_epochs=1,
                         reader_pool_type="dummy")
    with TorchDataLoader(reader, lambda: iter([{"id": np.zeros(2)}]), device="cpu") as loader:
        list(loader)
        with pytest.raises(ValueError, match="custom batch_source"):
            loader.state_dict()


def test_loader_state_dict_excludes_buffered_rows(petastorm_dataset):
    """Rows sitting in the batcher, the host queue and the prefetch at a
    checkpoint are re-read on resume."""
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    reader = make_reader(petastorm_dataset.url, schema_fields=["id"], num_epochs=1,
                         reader_pool_type="dummy", shuffle_row_groups=False)
    with make_torch_dataloader(reader, 4, device="cpu", host_prefetch=8) as loader:
        it = iter(loader)
        first = next(it)
        time.sleep(0.3)  # the producer runs ahead into its buffers
        state = loader.state_dict()
    first_ids = {int(i) for i in first["id"]}
    assert state["delivered"] == {}  # 4 rows yielded: no row group complete
    reader2 = make_reader(petastorm_dataset.url, schema_fields=["id"], num_epochs=1,
                          reader_pool_type="dummy", shuffle_row_groups=False,
                          resume_state=state)
    with make_torch_dataloader(reader2, 4, device="cpu", last_batch="keep") as loader2:
        resumed_ids = {int(i) for b in loader2 for i in b["id"]}
    assert first_ids | resumed_ids == set(range(30))


def test_loader_counts_rows_handed_out_not_rows_pulled(tabular):
    """Re-batched column batches: a checkpoint after 3 batches of 24 rows
    (72 rows, 3.6 row groups of 20) keeps the 3 complete row groups."""
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    reader = make_batch_reader(tabular, num_epochs=1, reader_pool_type="dummy",
                               shuffle_row_groups=False)
    with make_torch_dataloader(reader, 24, device="cpu", host_prefetch=8) as loader:
        it = iter(loader)
        seen = [next(it)["sample_index"].numpy() for _ in range(3)]
        time.sleep(0.3)
        state = loader.state_dict()
    assert state["delivered"] == {"0:0": 1, "1:0": 1, "2:0": 1}
    reader2 = make_batch_reader(tabular, num_epochs=1, reader_pool_type="dummy",
                                shuffle_row_groups=False, resume_state=state)
    with make_torch_dataloader(reader2, 24, device="cpu", last_batch="keep") as loader2:
        rest = [b["sample_index"].numpy() for b in loader2]
    np.testing.assert_array_equal(np.concatenate(rest), np.arange(60, TABULAR_ROWS))
    assert set(np.concatenate(seen).tolist()) == set(range(72))


# --- across packages -----------------------------------------------------------

def _jax_factories():
    from petastorm_tpu import make_batch_reader as jax_batch
    from petastorm_tpu import make_reader as jax_row

    return {"row": jax_row, "batch": jax_batch}


_PORT = {"row": make_reader, "batch": make_batch_reader}


def _rows_of(kind, item):
    return [int(item.id)] if kind == "row" else item.sample_index.tolist()


def _interrupted(factory, kind, url, k, **kw):
    """The rows of the first ``k`` items and the state after them."""
    with factory(url, **kw) as reader:
        it = iter(reader)
        rows = [r for _ in range(k) for r in _rows_of(kind, next(it))]
        return rows, reader.state_dict()


def _remaining(factory, kind, url, state, **kw):
    with factory(url, resume_state=state, **kw) as reader:
        return collections.Counter(r for item in reader for r in _rows_of(kind, item))


@pytest.mark.parametrize("kind,k", [("row", 13), ("batch", 5)])
def test_state_dicts_resume_across_packages(petastorm_dataset, tabular, kind, k):
    url = petastorm_dataset.url if kind == "row" else tabular
    kw = dict(num_epochs=2, reader_pool_type="dummy", shuffle_row_groups=True, shard_seed=3)
    if kind == "row":
        kw["schema_fields"] = ["id"]
    jax = _jax_factories()[kind]
    port = _PORT[kind]
    port_rows, port_state = _interrupted(port, kind, url, k, **kw)
    jax_rows, jax_state = _interrupted(jax, kind, url, k, **kw)
    assert port_rows == jax_rows and port_state == jax_state
    assert sum(port_state["delivered"].values()) >= 1
    want = _remaining(jax, kind, url, jax_state, **kw)
    assert _remaining(port, kind, url, jax_state, **kw) == want   # JAX state → port
    assert _remaining(jax, kind, url, port_state, **kw) == want   # port state → JAX
    total = collections.Counter(port_rows) + want
    assert min(total.values()) >= 2
