"""Sequence parallelism in the port at sp = 2: two spawned processes joined
in a gloo group over a ``FileStore`` under ``tmp_path`` (no fixed port),
CPU tensors, the kernels' plain versions. One spawn runs every case and
writes each rank's results; each case is its own test reading them.

- ``ring_attention`` (dense and flash local; striped and contiguous; causal
  and not; ``segment_ids``; ``lengths``; GQA) and ``ulysses_attention``
  (dense and flash): each rank's output and q/k/v gradients against the JAX
  package's ``ring_attention`` / ``ulysses_attention`` on a 2-device mesh of
  the suite's 8-device CPU platform, same seeded numpy inputs;
- ``make_seq_train_step`` (ring and Ulysses) and the LM step at sp = 2: each
  rank's loss and parameter gradients against the one-process gradients of
  the same module (which ``test_torch_sequence_model.py`` and
  ``test_torch_long_context_lm.py`` hold to JAX), and both ranks' against
  each other. A gradient ``sp`` times too large (a reduce-scatter where the
  global view needs a slice) fails here;
- the readers of a group (``sharding.reader_options``): every rank's
  reader yields the same rows in the same order over several row groups;
- ``train_lm(group=...)`` from a Parquet corpus: both ranks read the same
  batches and take the same steps, and the ring's logits match the dense
  oracle's.

Tolerances: outputs 1e-5 absolute, gradients 1e-4 relative to the largest
(f32; the two sides sum in other orders).
"""

import functools
import multiprocessing
import traceback

import numpy as np
import pytest
import torch

SP = 2
B, T, H, D = 2, 16, 4, 8
#: name -> (attention, local_attn, causal, placement, aux, K/V heads)
ATTN_CASES = {
    f"{fn}_{local}_{tag}": (fn, local, causal, placement, aux, h_kv)
    for fn, cases in {
        "ring": [("noncausal", False, "striped", None, H),
                 ("causal_striped", True, "striped", None, H),
                 ("causal_contiguous", True, "contiguous", None, H),
                 ("segments_striped", True, "striped", "seg", H),
                 ("segments_contiguous", True, "contiguous", "seg", H),
                 ("lengths", False, "striped", "lens", H),
                 ("lengths_causal_striped", True, "striped", "lens", H),
                 ("gqa_causal_striped", True, "striped", None, 2),
                 ("gqa_segments_contiguous", True, "contiguous", "seg", 1)],
        "ulysses": [("causal", True, None, None, H),
                    ("segments", True, None, "seg", H),
                    ("lengths", False, None, "lens", H)],
    }.items()
    for local in ("dense", "flash")
    for tag, causal, placement, aux, h_kv in cases
}
#: name -> (model, attention, local_attn)
STEP_CASES = {
    "seq_ring_flash": ("seq", "ring", "flash"),
    "seq_ring_dense": ("seq", "ring", "dense"),
    "seq_ulysses_flash": ("seq", "ulysses", "flash"),
    "lm_ring_flash": ("lm", "ring", "flash"),
}
LM = dict(d_model=32, num_heads=4, num_layers=2, slot_len=T, vocab=64)


def _attn_inputs(name):
    """Seeded numpy inputs of an attention case: q, k, v, the output's
    cotangent w, and the case's segment ids or lengths."""
    _, _, _, _, aux, h_kv = ATTN_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    arrays = {"q": rng.randn(B, T, H, D), "k": rng.randn(B, T, h_kv, D),
              "v": rng.randn(B, T, h_kv, D), "w": rng.randn(B, T, H, D)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    if aux == "seg":
        ids = np.sort(rng.randint(0, 3, (B, T)), axis=1).astype(np.int32)
        ids[0, -3:] = -1
        arrays["segment_ids"] = ids
    elif aux == "lens":
        arrays["lengths"] = np.array([T, 5], np.int32)
    return arrays


def _step_inputs(model):
    rng = np.random.RandomState(4)
    if model == "seq":
        return {"windows": rng.randn(B, T, 6).astype(np.float32),
                "labels": np.array([2, 0], np.int64),
                "mask": np.array([True, True]),
                "lengths": np.array([T, 11], np.int32)}
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_POSITION_KEY,
        PACK_SEGMENT_KEY,
        pack_ragged,
    )

    rows = [{"tokens": rng.randint(0, LM["vocab"], int(rng.randint(3, 12))).astype(np.int32)}
            for _ in range(12)]
    batch = next(pack_ragged(iter(rows), slot_len=T, slots=4))
    return {"tokens": batch["tokens"], "positions": batch[PACK_POSITION_KEY],
            "segment_ids": batch[PACK_SEGMENT_KEY]}


def _step_grads(name, group):
    """Loss and parameter gradients of one step of a ``STEP_CASES`` model
    (one process for ``group=None``, with dense attention there)."""
    from petastorm_tpu_torch.models import long_context_lm as lm
    from petastorm_tpu_torch.models import sequence_model as sm

    model_kind, attn, local = STEP_CASES[name]
    x = {k: torch.from_numpy(v) for k, v in _step_inputs(model_kind).items()}
    if model_kind == "seq":
        model = sm.init_seq_params(5, feature_dim=6, d_model=32, num_heads=4,
                                   num_classes=3, max_len=T, device="cpu")
        loss = sm.seq_loss(model, x["windows"], x["labels"], x["mask"], x["lengths"],
                           group=group, attn_impl=attn if group else "dense",
                           causal=True, local_attn=local, compute_dtype=torch.float32)
    else:
        model = lm.init_lm_params(5, device="cpu", **LM)
        loss = lm.lm_loss(model, x["tokens"], x["positions"], x["segment_ids"],
                          attn_impl=local if group else "dense", group=group)
    loss.backward()
    return {"loss": loss.detach(),
            **{n: p.grad.clone() for n, p in model.named_parameters()}}


def _rank_main(rank, store, out_dir, corpus_url, ragged_url):
    """One rank: join the group, run every case, save the results."""
    import torch.distributed as dist

    from petastorm_tpu_torch.models import sequence_model as sm
    from petastorm_tpu_torch.models.long_context_lm import train_lm
    from petastorm_tpu_torch.reader.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator
    from petastorm_tpu_torch.torch_utils.sharding import (
        default_shard_options,
        reader_options,
    )

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=SP)
        group = dist.group.WORLD
        results = {}
        for name, (fn, local, causal, placement, _, _) in ATTN_CASES.items():
            arrays = _attn_inputs(name)
            q, k, v = (torch.tensor(arrays[x], requires_grad=True) for x in "qkv")
            kw = dict(causal=causal, local_attn=local)
            if "segment_ids" in arrays:
                kw["segment_ids"] = torch.from_numpy(arrays["segment_ids"])
            if "lengths" in arrays:
                kw["lengths"] = torch.from_numpy(arrays["lengths"])
            if fn == "ring":
                out = sm.ring_attention(q, k, v, group, placement=placement, **kw)
            else:
                out = sm.ulysses_attention(q, k, v, group, **kw)
            (out * torch.from_numpy(arrays["w"])).sum().backward()
            results[name] = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
        for name in STEP_CASES:
            results[name] = _step_grads(name, group)
        results["shard_options"] = default_shard_options()
        with make_columnar_reader(ragged_url, num_epochs=2, shuffle_row_groups=True,
                                  shard_seed=0, schema_fields=["id"],
                                  **reader_options(group)) as reader:
            results["reader_ids"] = torch.from_numpy(np.concatenate(
                [batch["id"] for batch in batch_iterator(reader, 16)]))
        trained = train_lm(corpus_url, slot_len=32, slots=4, steps=3, num_heads=4,
                           d_model=32, epochs=1, device="cpu", group=group)
        results["train_lm"] = {"losses": trained["losses"],
                               "logit_parity": trained["logit_parity"]}
        torch.save(results, f"{out_dir}/rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Both ranks' results from one spawned gloo run; the processes are
    joined (or killed) before this returns, and a rank that failed fails
    every test with its traceback."""
    from petastorm_tpu_torch.models.long_context_lm import generate_corpus
    from petastorm_tpu_torch.models.sequence_training import generate_ragged_dataset

    tmp = tmp_path_factory.mktemp("sp")
    corpus_url, ragged_url = f"file://{tmp}/corpus", f"file://{tmp}/ragged"
    generate_corpus(corpus_url, docs=64, max_len=24)
    generate_ragged_dataset(ragged_url)  # 4 row groups of 64 rows
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), str(tmp), corpus_url, ragged_url))
             for r in range(SP)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp / f"rank{r}.err") for r in range(SP)]
    failed = [f"rank {r} (exit {p.exitcode}):\n"
              + (errors[r].read_text() if errors[r].exists() else "no traceback")
              for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        pytest.fail("\n".join(failed))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(SP)]


@functools.lru_cache(maxsize=None)
def _jax_attention(name):
    """The JAX package's output and q/k/v gradients on a 2-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from petastorm_tpu.models import sequence_model as jsm

    fn, local, causal, placement, _, _ = ATTN_CASES[name]
    arrays = _attn_inputs(name)
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    kw = dict(causal=causal, local_attn=local)
    for key in ("segment_ids", "lengths"):
        if key in arrays:
            kw[key] = jnp.asarray(arrays[key])

    def attention(q, k, v):
        if fn == "ring":
            return jsm.ring_attention(q, k, v, mesh, "sp", placement=placement, **kw)
        return jsm.ulysses_attention(q, k, v, mesh, "sp", **kw)

    @jax.jit
    def out_and_grads(q, k, v, w):
        out, vjp = jax.vjp(attention, q, k, v)
        return out, vjp(w)

    out, grads = out_and_grads(*(jnp.asarray(arrays[x]) for x in "qkvw"))
    return np.asarray(out), [np.array(g) for g in grads]


def _rel(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-6)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_matches_jax_on_every_rank(rank_results, name):
    want_out, want_grads = _jax_attention(name)
    for rank, results in enumerate(rank_results):
        got = results[name]
        np.testing.assert_allclose(got["out"].numpy(), want_out, rtol=0, atol=1e-5,
                                   err_msg=f"rank {rank}")
        for key, want in zip(("dq", "dk", "dv"), want_grads):
            assert torch.isfinite(got[key]).all()
            assert _rel(got[key], torch.from_numpy(want)) <= 1e-4, (rank, key)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_gradients_equal_one_process(rank_results, name):
    want = _step_grads(name, None)
    for rank, results in enumerate(rank_results):
        got = results[name]
        assert sorted(got) == sorted(want)
        assert abs(got["loss"].item() - want["loss"].item()) <= 1e-5 * abs(want["loss"].item())
        for key in want:
            if key != "loss":
                assert _rel(got[key], want[key]) <= 1e-4, (rank, key)


def test_ranks_hold_the_same_global_outputs(rank_results):
    first, second = rank_results
    for name in ATTN_CASES:
        for key in ("out", "dq", "dk", "dv"):
            assert torch.equal(first[name][key], second[name][key]), (name, key)


def test_group_readers_give_every_rank_the_same_batches(rank_results):
    from petastorm_tpu_torch.torch_utils.sharding import reader_options

    first, second = (r["reader_ids"].numpy() for r in rank_results)
    np.testing.assert_array_equal(first, second)
    assert sorted(first.tolist()) == sorted(list(range(256)) * 2)
    assert reader_options(None) == {}


def test_train_lm_over_the_group(rank_results):
    first, second = (r["train_lm"] for r in rank_results)
    assert len(first["losses"]) == 3 and first["losses"] == second["losses"]
    assert all(np.isfinite(first["losses"]))
    assert first["logit_parity"] <= 2e-4 and second["logit_parity"] <= 2e-4


def test_default_shard_options_come_from_the_process_group(rank_results):
    from petastorm_tpu_torch.torch_utils.sharding import default_shard_options

    assert [r["shard_options"] for r in rank_results] == [(0, SP), (1, SP)]
    assert default_shard_options() == (None, None)   # no group in this process
    assert default_shard_options(3, 4) == (3, 4)
