"""The port's DLRM and tabular trainer against the JAX package's
``models/tabular_dlrm.py`` and ``examples/criteo_dlrm/train_dlrm.py`` on the
same seeded numpy inputs.

Tolerances:
- f32 logits after ``params_from_jax``: 1e-5 absolute (observed ~4e-8);
- bf16 logits: within 4x the JAX package's own bf16-vs-f32 logit gap on the
  same inputs (observed 0.7x at the default widths; both sides round to
  bf16 at different points: the JAX package casts the parameters and XLA
  accumulates the products, PyTorch's CPU kernels accumulate theirs);
- one SGD step at f32 compute (the JAX step run with ``apply_dlrm`` at
  f32): loss and parameters 1e-5 relative to the largest;
- the two-rank data-parallel step: gradients 1e-6 relative to the largest
  against the mean of the one-process gradients of the two batches;
- the sparse step (no group) against the dense step: equal bit for bit
  (each named row's contributions summed in the same order, then the same
  two roundings).
"""

import collections
import functools
import json

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.models import tabular_dlrm as td
from petastorm_tpu_torch.torch_utils.mesh import run_ranks

SMALL = dict(num_dense=5, num_sparse=4, vocab_size=32, embed_dim=8, bottom_hidden=16,
             top_hidden=16)


def _jax_params(cfg, seed=0):
    import jax

    from petastorm_tpu.models.tabular_dlrm import init_dlrm_params

    params = init_dlrm_params(jax.random.PRNGKey(seed), **cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(cfg, batch=32, seed=1):
    rng = np.random.RandomState(seed)
    return {"dense": rng.rand(batch, cfg["num_dense"]).astype(np.float32),
            "ids": rng.randint(0, 10_000, (batch, cfg["num_sparse"])).astype(np.int64),
            "labels": rng.randint(0, 2, batch).astype(np.int32),
            "mask": np.ones(batch, bool)}


def _port_model(params, compute_dtype=torch.float32):
    return td.params_from_jax(params, compute_dtype=compute_dtype, device="cpu")


def test_params_from_jax_carries_the_weights():
    params = _jax_params(SMALL)
    state = _port_model(params).state_dict()
    assert torch.equal(state["embeddings"], torch.tensor(params["embeddings"]))
    for name in ("bottom1", "bottom2", "top1", "top2"):
        for part in ("kernel", "bias"):
            assert torch.equal(state[f"{name}_{part}"], torch.tensor(params[name][part]))


def test_init_dlrm_has_the_reference_shapes_and_scales():
    model = td.init_dlrm(device="cpu")
    want = {k: v.shape for k, v in _jax_params({"num_dense": 13, "num_sparse": 26}).items()
            if k == "embeddings"}
    assert tuple(model.embeddings.shape) == want["embeddings"] == (26, 1024, 16)
    assert tuple(model.top1_kernel.shape) == (27 * 26 // 2 + 16, 64)
    assert abs(float(model.embeddings.detach().std()) - 0.05) < 1e-3
    assert float(model.top2_bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("cfg", [SMALL, dict(num_dense=13, num_sparse=26)],
                         ids=["small", "default"])
def test_logits_equal_apply_dlrm(cfg):
    import jax.numpy as jnp

    from petastorm_tpu.models.tabular_dlrm import apply_dlrm

    params, x = _jax_params(cfg), _inputs(cfg, batch=64)
    dense, ids = torch.from_numpy(x["dense"]), torch.from_numpy(x["ids"])
    want_f32 = np.asarray(apply_dlrm(params, x["dense"], x["ids"], compute_dtype=jnp.float32))
    with torch.no_grad():
        got_f32 = _port_model(params)(dense, ids).numpy()
        got_bf16 = _port_model(params, torch.bfloat16)(dense, ids).numpy()
    assert got_f32.dtype == got_bf16.dtype == np.float32 and got_f32.shape == (64,)
    np.testing.assert_allclose(got_f32, want_f32, rtol=0, atol=1e-5)
    want_bf16 = np.asarray(apply_dlrm(params, x["dense"], x["ids"]))
    jax_gap = np.abs(want_bf16 - want_f32).max()
    assert 0 < jax_gap and np.abs(got_bf16 - want_bf16).max() <= 4 * jax_gap


def _jax_step_f32(monkeypatch):
    """The JAX package's own train step with ``apply_dlrm`` at f32."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models import tabular_dlrm as jd

    monkeypatch.setattr(jd, "apply_dlrm",
                        functools.partial(jd.apply_dlrm, compute_dtype=jnp.float32))
    return jax.jit(jd.make_dlrm_train_step(0.05))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def test_one_sgd_step_equals_jax(monkeypatch):
    params, x = _jax_params(SMALL), _inputs(SMALL)
    x["mask"][-5:] = False
    new_params, want_loss = _jax_step_f32(monkeypatch)(
        params, x["dense"], x["ids"], x["labels"], x["mask"])
    model = _port_model(params)
    loss = td.make_dlrm_train_step(model, 0.05)(
        *(torch.from_numpy(x[k]) for k in ("dense", "ids", "labels", "mask")))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    state = model.state_dict()
    assert _rel(state["embeddings"].numpy(), np.asarray(new_params["embeddings"])) <= 1e-5
    for name in ("bottom1", "bottom2", "top1", "top2"):
        for part in ("kernel", "bias"):
            assert _rel(state[f"{name}_{part}"].numpy(),
                        np.asarray(new_params[name][part])) <= 1e-5, (name, part)


def test_pad_mask_zeroes_the_gradient():
    """Masked rows add nothing: changing them leaves the gradients as they
    were, bit for bit, and the loss is the real rows' mean."""
    params, x = _jax_params(SMALL), _inputs(SMALL, batch=16)
    x["mask"][10:] = False
    model = _port_model(params)

    def grads(arrays):
        loss, g = td.dlrm_gradients(model, *(torch.from_numpy(arrays[k]) for k in
                                             ("dense", "ids", "labels", "mask")))
        return loss, {k: v.clone() for k, v in g.items()}

    loss, base = grads(x)
    changed = {k: v.copy() for k, v in x.items()}
    changed["dense"][10:] = 5.0
    changed["ids"][10:] = 7
    changed["labels"][10:] = 1 - changed["labels"][10:]
    loss2, other = grads(changed)
    assert float(loss) == float(loss2)
    assert all(torch.equal(base[k], other[k]) for k in base)
    real = {k: v[:10] for k, v in x.items()}
    loss3, _ = grads(real)
    assert abs(float(loss3) - float(loss)) <= 1e-6


def _repeated_inputs(cfg, batch=48, seed=3):
    """Inputs whose ids repeat heavily: 6 distinct raw ids a table, so each
    named row is named ~8 times a batch, with some rows of each table left
    unnamed."""
    x = _inputs(cfg, batch=batch, seed=seed)
    x["ids"] = np.random.RandomState(seed).randint(0, 6, x["ids"].shape).astype(np.int64) * 5
    x["mask"][-3:] = False
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _dense_sgd_step(model, x, lr):
    """The dense path: :func:`dlrm_gradients`, then ``p -= lr * grad`` on every leaf."""
    loss, grads = td.dlrm_gradients(model, x["dense"], x["ids"], x["labels"], x["mask"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p -= lr * grads[name]
    return loss


def test_sparse_step_equals_the_dense_step():
    """Without a group the step updates only the named table rows, to the
    dense update's values bit for bit, and leaves the other rows as they
    were; the MLPs and the losses are the dense path's too."""
    params, lr = _jax_params(SMALL), 0.05
    sparse, dense = _port_model(params), _port_model(params)
    before = sparse.embeddings.detach().clone()
    step = td.make_dlrm_train_step(sparse, lr)
    named = set()
    for seed in range(3):
        x = _repeated_inputs(SMALL, seed=seed)
        loss = step(x["dense"], x["ids"], x["labels"], x["mask"])
        assert torch.equal(loss, _dense_sgd_step(dense, x, lr)), seed
        index, _ = sparse.lookup(x["ids"])
        assert int(step.last_touched_rows) == torch.unique(index).numel()
        named.update(index.tolist())
    for name, p in sparse.named_parameters():
        assert torch.equal(p, dict(dense.named_parameters())[name]), name
    flat, was = sparse.embeddings.detach().view(-1, SMALL["embed_dim"]), before.view(
        -1, SMALL["embed_dim"])
    unnamed = sorted(set(range(flat.shape[0])) - named)
    assert unnamed and torch.equal(flat[unnamed], was[unnamed])
    assert not torch.equal(flat[sorted(named)], was[sorted(named)])


def test_lookup_rows_are_the_forward_s_rows():
    """``DLRM.lookup``'s flat index names ``table × vocab + id % vocab``, its
    rows are a leaf, and the forward from them gives the same logits."""
    model = _port_model(_jax_params(SMALL))
    x = _inputs(SMALL, batch=16)
    dense, ids = torch.from_numpy(x["dense"]), torch.from_numpy(x["ids"])
    index, rows = model.lookup(ids)
    vocab, dim = SMALL["vocab_size"], SMALL["embed_dim"]
    want = (torch.remainder(ids, vocab) + torch.arange(SMALL["num_sparse"]) * vocab).reshape(-1)
    assert torch.equal(index, want)
    assert rows.is_leaf and rows.requires_grad and rows.shape == (16, SMALL["num_sparse"], dim)
    assert torch.equal(rows.detach().reshape(-1, dim),
                       model.embeddings.detach().reshape(-1, dim)[want])
    with torch.no_grad():
        assert torch.equal(model(dense, ids, rows=rows), model(dense, ids))


def _spans(collector, name):
    """``(begin ts, end ts, args)`` of each span ``name`` the collector holds."""
    begins = [e for e in collector.events() if e["name"] == name and e["ph"] == "B"]
    ends = [e for e in collector.events() if e["name"] == name and e["ph"] == "E"]
    return [(b["ts"], e["ts"], b["args"]) for b, e in zip(begins, ends)]


def test_sparse_update_is_one_span_a_step_inside_the_update():
    from petastorm_tpu_torch.telemetry import COLLECTOR

    model = _port_model(_jax_params(SMALL))
    step = td.make_dlrm_train_step(model, 0.05)
    x = _repeated_inputs(SMALL, batch=24)
    COLLECTOR.acquire()
    try:
        for _ in range(3):
            step(x["dense"], x["ids"], x["labels"], x["mask"])
        sparse, update = (_spans(COLLECTOR, name) for name in ("dlrm.sparse_update",
                                                               "step.update"))
    finally:
        COLLECTOR.release()
        COLLECTOR.clear()
    assert len(sparse) == len(update) == 3
    for (t0, t1, args), (u0, u1, _) in zip(sparse, update):
        assert args == {"lookups": 24 * SMALL["num_sparse"]}
        assert u0 <= t0 <= t1 <= u1


@pytest.fixture(scope="module")
def store_512(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('criteo')}/criteo"
    assert td.make_tabular_dataset(url, rows=512) == 512  # 8 row groups of 64
    return url


def test_train_dlrm_trains_and_resumes(store_512, tmp_path):
    """As ``tests/test_examples.py`` does for the JAX example: interrupt,
    checkpoint, restore, resume; every row trained at least twice (two
    epochs) bar the final partial batch ``"drop"`` discards."""
    from petastorm_tpu_torch.torch_utils.checkpoint import restore_training_state

    kw = dict(batch_size=48, epochs=2, device="cpu", collect_field="sample_index")
    first = td.train_dlrm(store_512, interrupt_after=5, checkpoint_dir=str(tmp_path / "ck"),
                          **kw)
    assert first["steps"] == 5 and first["input_state"]["version"] == 1
    assert first["checkpoint_save_ms"] > 0 and first["batch_devices"] == ["cpu"]
    arrays, state = restore_training_state(tmp_path / "ck")
    assert state == first["input_state"]
    model = td.init_dlrm(seed=1, device="cpu")
    model.load_state_dict(arrays["model"])
    for name, p in first["model"].state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name
    second = td.train_dlrm(store_512, resume_state=state, model=model, **kw)
    assert second["input_state"] is None
    # 1024 rows / 48 = 21 steps; the 240 rows of the interrupt cover 3.75
    # row groups, so the 4th (64 rows) is re-read: 22 steps in all.
    assert first["steps"] + second["steps"] == 22
    counts = collections.Counter(np.concatenate([first["collected"],
                                                 second["collected"]]).tolist())
    deficit = sum(max(0, 2 - counts[i]) for i in range(512))
    assert len(counts) == 512 and deficit < 48
    assert all(np.isfinite(first["losses"] + second["losses"]))


def test_train_dlrm_with_filters_reads_one_day(store_512):
    result = td.train_dlrm(store_512, batch_size=32, epochs=1, device="cpu",
                           filters=[("day", "=", 2)], collect_field="sample_index")
    assert result["reader_diagnostics"]["rowgroups_total"] == 1 and result["steps"] == 2
    assert set(result["collected"].tolist()) == set(range(128, 192))


# --- data parallel at two ranks ----------------------------------------------

WORLD = 2


def _rank_main(rank, out_dir, url, params):
    import torch.distributed as dist

    group = dist.group.WORLD
    x = _inputs(SMALL, batch=16, seed=10 + rank)
    model = _port_model(params)
    _, grads = td.dlrm_gradients(model, *(torch.from_numpy(x[k]) for k in
                                          ("dense", "ids", "labels", "mask")), group=group)
    torch.save({k: v.clone() for k, v in grads.items()}, f"{out_dir}/grads{rank}.pt")
    from petastorm_tpu_torch.telemetry import COLLECTOR

    COLLECTOR.acquire()
    try:
        trained = td.train_dlrm(url, batch_size=32, epochs=1, device="cpu", group=group,
                                collect_field="sample_index")
        spans = collections.Counter(e["name"] for e in COLLECTOR.events() if e["ph"] == "B")
    finally:
        COLLECTOR.release()
    torch.save(trained["model"].state_dict(), f"{out_dir}/params{rank}.pt")
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump({"steps": trained["steps"],
                   "max_batches": trained["diagnostics"]["max_batches"],
                   "rows": sorted(trained["collected"].tolist()),
                   "spans": {name: spans[name] for name in ("step.update",
                                                            "dlrm.sparse_update")}}, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, store_512):
    tmp = tmp_path_factory.mktemp("dp")
    params = _jax_params(SMALL)  # here: the ranks import no JAX
    try:
        run_ranks(_rank_main, WORLD, str(tmp), args=(str(tmp), store_512, params),
                  timeout_s=180)
    except RuntimeError as exc:
        pytest.fail(str(exc))
    return tmp


def test_data_parallel_step_equals_the_one_process_mean_gradient(ranks):
    model = _port_model(_jax_params(SMALL))
    one = []
    for rank in range(WORLD):
        x = _inputs(SMALL, batch=16, seed=10 + rank)
        _, g = td.dlrm_gradients(model, *(torch.from_numpy(x[k]) for k in
                                          ("dense", "ids", "labels", "mask")))
        one.append({k: v.clone() for k, v in g.items()})
    for rank in range(WORLD):
        got = torch.load(ranks / f"grads{rank}.pt")
        for name in got:
            want = (one[0][name] + one[1][name]) / 2
            assert _rel(got[name].numpy(), want.numpy()) <= 1e-6, (rank, name)


def test_data_parallel_ranks_take_equal_steps_and_end_equal(ranks, store_512):
    from petastorm_tpu_torch.torch_utils.sharding import global_step_count

    runs = [json.loads((ranks / f"rank{r}.json").read_text()) for r in range(WORLD)]
    want = global_step_count(store_512, 32, WORLD, num_epochs=1, shard_seed=7)
    assert want == 8
    assert [r["steps"] for r in runs] == [want, want]
    assert [r["max_batches"] for r in runs] == [want, want]
    assert not set(runs[0]["rows"]) & set(runs[1]["rows"])   # disjoint shards
    first, second = (torch.load(ranks / f"params{r}.pt") for r in range(WORLD))
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_data_parallel_steps_keep_the_dense_table_update(ranks):
    """Under a data-parallel group the step all-reduces the dense table
    gradient: no ``dlrm.sparse_update`` span in any of its steps."""
    for rank in range(WORLD):
        run = json.loads((ranks / f"rank{rank}.json").read_text())
        assert run["spans"] == {"step.update": run["steps"], "dlrm.sparse_update": 0}
