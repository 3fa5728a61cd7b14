"""Equal-step coordination in the port against the JAX package's, on the
same stores and arguments: ``global_step_count``,
``derive_equal_step_max_batches`` (with its five refusals and their
warnings) and ``count_deliverable_batches`` must give the JAX values
exactly; ``agree_max_batches`` over two gloo processes (a ``FileStore``
under ``tmp_path``, one spawn for the file) must give the minimum and the
first rank's count. Counts are integers: compared exactly.
"""

import json
from types import SimpleNamespace

import pytest

from petastorm_tpu_torch.torch_utils import sharding
from petastorm_tpu_torch.torch_utils.mesh import run_ranks

ROWS = 230  # 8 row groups of 28 rows (rows cut to a multiple of the days)


@pytest.fixture(scope="module")
def tabular(tmp_path_factory):
    from petastorm_tpu_torch.models.tabular_dlrm import make_tabular_dataset

    url = f"file://{tmp_path_factory.mktemp('tabular')}/criteo"
    make_tabular_dataset(url, rows=ROWS, dense_cols=2, sparse_cols=2)
    return url


COUNT_CASES = {
    "one_shard": dict(batch_size=16, shard_count=1),
    "three_shards_drop": dict(batch_size=10, shard_count=3),
    "three_shards_pad_seeded": dict(batch_size=10, shard_count=3, last_batch="pad",
                                    shard_seed=4),
    "keep_two_epochs": dict(batch_size=7, shard_count=2, last_batch="keep", num_epochs=2),
    "filtered": dict(batch_size=8, shard_count=2, filters=[("day", "in", [1, 2, 6])]),
    "more_shards_than_groups": dict(batch_size=4, shard_count=9),
}


@pytest.mark.parametrize("name", sorted(COUNT_CASES))
def test_global_step_count_equals_jax(tabular, name):
    from petastorm_tpu.jax_utils.sharding import global_step_count as jax_count

    got = sharding.global_step_count(tabular, **COUNT_CASES[name])
    assert got == jax_count(tabular, **COUNT_CASES[name])
    if name == "more_shards_than_groups":
        assert got == 0


def test_global_step_count_on_a_petastorm_dataset_equals_jax(petastorm_dataset):
    from petastorm_tpu.jax_utils.sharding import global_step_count as jax_count

    for kw in (dict(batch_size=4, shard_count=2), dict(batch_size=3, shard_count=3,
                                                       num_epochs=3, shard_seed=1)):
        assert sharding.global_step_count(petastorm_dataset.url, **kw) == \
            jax_count(petastorm_dataset.url, **kw)


def test_global_step_count_refusals(tabular):
    with pytest.raises(ValueError, match="finite num_epochs"):
        sharding.global_step_count(tabular, 8, 2, num_epochs=None)
    with pytest.raises(ValueError, match="positive"):
        sharding.global_step_count(tabular, 8, 0)


@pytest.mark.parametrize("kwargs", [
    dict(cur_shard=0, shard_count=3, batch_size=10),
    dict(cur_shard=2, shard_count=3, shard_seed=6, batch_size=10, last_batch="pad"),
    dict(cur_shard=1, shard_count=2, num_epochs=3, batch_size=32),
    dict(cur_shard=0, shard_count=2, filters=[("day", "<", 5)], batch_size=9),
], ids=["drop", "pad_seeded", "epochs", "filtered"])
def test_derive_equal_step_max_batches_equals_jax(tabular, kwargs):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.jax_utils.sharding import derive_equal_step_max_batches as jax_derive
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    kwargs = dict(kwargs)
    batch, last = kwargs.pop("batch_size"), kwargs.pop("last_batch", "drop")
    kwargs.setdefault("num_epochs", 1)
    with make_batch_reader(tabular, reader_pool_type="dummy", **kwargs) as port, \
            jax_make_batch_reader(tabular, reader_pool_type="dummy", **kwargs) as jax:
        assert port.shard_row_counts == jax.shard_row_counts
        got = sharding.derive_equal_step_max_batches(port, batch, last)
        assert got == jax_derive(jax, batch, last) is not None
    assert got == sharding.global_step_count(
        tabular, batch, kwargs["shard_count"], last_batch=last, num_epochs=kwargs["num_epochs"],
        shard_seed=kwargs.get("shard_seed"), filters=kwargs.get("filters"))


REFUSALS = {
    "infinite": (SimpleNamespace(num_epochs=None), "infinite stream"),
    "ngram": (SimpleNamespace(num_epochs=1, ngram=object()), "NGram"),
    "resumed": (SimpleNamespace(num_epochs=1, _resume_state={}), "resumed reader"),
    "predicate": (SimpleNamespace(num_epochs=1, _predicate=object()), "predicate"),
    "transform": (SimpleNamespace(num_epochs=1, _transform_spec=SimpleNamespace(func=len)),
                  "TransformSpec"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_derive_refuses_what_jax_refuses(name):
    from petastorm_tpu.jax_utils.sharding import derive_equal_step_max_batches as jax_derive

    reader, match = REFUSALS[name]
    with pytest.warns(UserWarning, match=match):
        assert sharding.derive_equal_step_max_batches(reader, 4) is None
    with pytest.warns(UserWarning, match=match):
        assert jax_derive(reader, 4) is None


def test_derive_refuses_a_resumed_port_reader(tabular):
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    kw = dict(num_epochs=1, cur_shard=0, shard_count=1, reader_pool_type="dummy")
    with make_batch_reader(tabular, **kw) as reader:
        next(iter(reader))
        state = reader.state_dict()
    with make_batch_reader(tabular, resume_state=state, **kw) as reader:
        with pytest.warns(UserWarning, match="resumed reader"):
            assert sharding.derive_equal_step_max_batches(reader, 4) is None


@pytest.mark.parametrize("batch_size,last_batch", [(16, "drop"), (16, "pad"), (50, "keep")])
def test_count_deliverable_batches_equals_jax(tabular, batch_size, last_batch):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.jax_utils.sharding import count_deliverable_batches as jax_count_batches
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    kw = dict(num_epochs=2, cur_shard=1, shard_count=3, reader_pool_type="dummy")
    got = sharding.count_deliverable_batches(make_batch_reader(tabular, **kw), batch_size,
                                             last_batch)
    want = jax_count_batches(jax_make_batch_reader(tabular, **kw), batch_size, last_batch)
    assert got == want > 0


def test_count_deliverable_batches_refuses_an_infinite_reader():
    with pytest.raises(ValueError, match="never terminate"):
        sharding.count_deliverable_batches(SimpleNamespace(num_epochs=None), 4)


def test_make_torch_dataloader_derives_max_batches_under_a_group(tabular, monkeypatch):
    """With a group and no max_batches the loader takes the derived count
    (the derivation needs no collective, so a stand-in group will do)."""
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    kw = dict(num_epochs=1, cur_shard=1, shard_count=3, reader_pool_type="dummy")
    want = sharding.global_step_count(tabular, 10, 3)
    with make_torch_dataloader(make_batch_reader(tabular, **kw), 10, device="cpu",
                               group=object()) as loader:
        assert sum(1 for _ in loader) == want == loader.diagnostics["max_batches"]
    with make_torch_dataloader(make_batch_reader(tabular, **kw), 10, device="cpu") as loader:
        assert sum(1 for _ in loader) > want and loader.diagnostics["max_batches"] is None


def test_agree_max_batches_without_a_group_is_the_local_count():
    assert sharding.agree_max_batches(7) == 7
    assert sharding.agree_max_batches(7, reduce="host0") == 7
    with pytest.raises(ValueError, match="reduce"):
        sharding.agree_max_batches(7, reduce="max")


LOCAL_COUNTS = [7, 3]


def _rank_main(rank, out_dir):
    import torch.distributed as dist

    local = LOCAL_COUNTS[rank]
    results = {
        "min_group": sharding.agree_max_batches(local, group=dist.group.WORLD),
        "min_default": sharding.agree_max_batches(local),
        "host0": sharding.agree_max_batches(local, reduce="host0", group=dist.group.WORLD),
    }
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(results, f)


@pytest.fixture(scope="module")
def agreed(tmp_path_factory):
    """Both ranks' agreed counts from one spawned gloo run."""
    tmp = tmp_path_factory.mktemp("agree")
    try:
        run_ranks(_rank_main, len(LOCAL_COUNTS), str(tmp), args=(str(tmp),), timeout_s=120)
    except RuntimeError as exc:
        pytest.fail(str(exc))
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(len(LOCAL_COUNTS))]


@pytest.mark.parametrize("key,want", [("min_group", 3), ("min_default", 3), ("host0", 7)])
def test_agree_max_batches_over_two_processes(agreed, key, want):
    assert [r[key] for r in agreed] == [want, want]
