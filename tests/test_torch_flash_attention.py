"""The port's flash attention (plain PyTorch versions of the CUDA kernels, on
the CPU) against the JAX package's Pallas kernels in interpret mode and its
dense oracles, on the same seeded numpy inputs.

Tolerances: f32 forward 1e-5 absolute and lse 1e-5 absolute; f32 gradients
1e-4 relative to the largest reference gradient (the two sides sum in other
orders); bf16 2e-2 (one bf16 rounding of the output).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models.sequence_model import attention_reference as jax_dense
from petastorm_tpu.ops import flash_attention as jax_flash
from petastorm_tpu.ops.flash_attention import _flash_forward
from petastorm_tpu_torch.ops import flash_attention as fa
from petastorm_tpu_torch.models.sequence_model import attention_reference

#: name -> (b, t_q, t_kv, h, h_kv, d, causal, aux, dtype)
CASES = {
    "plain": (2, 40, 40, 2, 2, 16, False, None, "float32"),
    "causal_ragged_tile": (2, 136, 136, 2, 2, 32, True, None, "float32"),
    "causal_tq_gt_tkv_empty_rows": (1, 70, 50, 2, 2, 16, True, None, "float32"),
    "causal_tq_lt_tkv": (2, 24, 40, 2, 2, 16, True, None, "float32"),
    "kv_lengths": (3, 64, 64, 2, 2, 16, False, "lens", "float32"),
    "kv_lengths_causal": (3, 33, 33, 2, 2, 32, True, "lens", "float32"),
    "segment_ids_causal": (2, 96, 96, 2, 2, 32, True, "seg", "float32"),
    "segment_ids_pair": (2, 48, 80, 2, 2, 16, False, "pair", "float32"),
    "gqa_causal": (2, 72, 72, 4, 2, 16, True, None, "float32"),
    "mqa_causal_segments": (2, 8, 8, 4, 1, 16, True, "seg", "float32"),
    "bf16_causal_segments": (2, 64, 64, 2, 2, 16, True, "seg", "bfloat16"),
}


def _segments(rng, b, t):
    """Sorted packed ids with a -1 padding tail on the first row."""
    ids = np.sort(rng.randint(0, 4, (b, t)), axis=1).astype(np.int32)
    ids[0, -max(1, t // 8):] = -1
    return ids


@functools.lru_cache(maxsize=None)
def _inputs(name):
    b, t_q, t_kv, h, h_kv, d, causal, aux, dtype = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    arrays = {
        "q": rng.randn(b, t_q, h, d).astype(np.float32),
        "k": rng.randn(b, t_kv, h_kv, d).astype(np.float32),
        "v": rng.randn(b, t_kv, h_kv, d).astype(np.float32),
        "do": rng.randn(b, t_q, h, d).astype(np.float32),
    }
    if dtype == "bfloat16":  # round once so both sides see the same values
        arrays = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                  for k, v in arrays.items()}
    extra = {}
    if aux == "lens":
        extra["kv_lengths"] = np.array([t_kv, t_kv // 3, 0][:b], np.int32)
    elif aux == "seg":
        extra["segment_ids"] = _segments(rng, b, t_q)
    elif aux == "pair":
        extra["segment_ids"] = (_segments(rng, b, t_q), _segments(rng, b, t_kv))
    return arrays, extra, causal, dtype


def _jax_kwargs(extra):
    out = dict(extra)
    if "segment_ids" in out:
        seg = out["segment_ids"]
        out["segment_ids"] = (tuple(jnp.asarray(s) for s in seg)
                              if isinstance(seg, tuple) else jnp.asarray(seg))
    if "kv_lengths" in out:
        out["kv_lengths"] = jnp.asarray(out["kv_lengths"])
    return out


def _torch_kwargs(extra):
    out = dict(extra)
    if "segment_ids" in out:
        seg = out["segment_ids"]
        out["segment_ids"] = (tuple(torch.from_numpy(s) for s in seg)
                              if isinstance(seg, tuple) else torch.from_numpy(seg))
    if "kv_lengths" in out:
        out["kv_lengths"] = torch.from_numpy(out["kv_lengths"])
    return out


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """JAX flash (Pallas interpret mode off-TPU): output, internal lse
    residual and the gradients of sum(out * do)."""
    arrays, extra, causal, dtype = _inputs(name)
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(arrays[x], jdt) for x in "qkv")
    kw = _jax_kwargs(extra)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, **kw)

    out, vjp = jax.vjp(f, q, k, v)
    grads = vjp(jnp.asarray(arrays["do"], jdt))
    _, lse = _flash_forward(q, k, v, 128, 128, True, causal=causal,
                            return_residuals=True,
                            kv_lengths=kw.get("kv_lengths"),
                            segment_ids=kw.get("segment_ids"))
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return f32(out), f32(lse[:, :q.shape[1]]), tuple(f32(g) for g in grads)


def _torch_run(name):
    arrays, extra, causal, dtype = _inputs(name)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(arrays[x], dtype=tdt, requires_grad=True)
               for x in "qkv")
    out = fa.flash_attention(q, k, v, causal=causal, device="cpu",
                             **_torch_kwargs(extra))
    out.backward(torch.tensor(arrays["do"], dtype=tdt))
    return out, (q.grad, k.grad, v.grad)


def _tol(dtype):
    return (2e-2, 2e-2) if dtype == "bfloat16" else (1e-5, 1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_flash(name):
    _, _, _, dtype = _inputs(name)
    out, _ = _torch_run(name)
    jax_out, _, _ = _jax_results(name)
    got = out.detach().float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=_tol(dtype)[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_flash(name):
    _, _, _, dtype = _inputs(name)
    _, grads = _torch_run(name)
    _, _, jax_grads = _jax_results(name)
    for got, want in zip(grads, jax_grads):
        got = got.float().numpy()
        assert np.isfinite(got).all()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale <= _tol(dtype)[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_residual_matches_jax(name):
    """The forward's lse residual, +inf on rows with no visible key."""
    arrays, extra, causal, dtype = _inputs(name)
    tdt = getattr(torch, dtype)
    kw = _torch_kwargs(extra)
    seg = kw.pop("segment_ids", None)
    q_seg, kv_seg = (seg if isinstance(seg, tuple) else (seg, seg))
    _, lse = fa.flash_forward_plain(
        *(torch.tensor(arrays[x], dtype=tdt) for x in "qkv"), causal=causal,
        causal_offset=arrays["k"].shape[1] - arrays["q"].shape[1],
        q_seg=q_seg, kv_seg=kv_seg, kv_lengths=kw.get("kv_lengths"))
    _, jax_lse, _ = _jax_results(name)
    lse = lse.numpy()
    np.testing.assert_array_equal(np.isposinf(lse), np.isposinf(jax_lse))
    finite = np.isfinite(jax_lse)
    np.testing.assert_allclose(lse[finite], jax_lse[finite], rtol=0,
                               atol=_tol(dtype)[0])


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if CASES[n][7] != "pair"
                                  and CASES[n][8] == "float32"])
def test_matches_dense_oracle(name):
    """Port flash vs the JAX dense oracle (K/V heads repeated for GQA), and
    the port's own dense oracle vs the JAX one."""
    arrays, extra, causal, _ = _inputs(name)
    group = arrays["q"].shape[2] // arrays["k"].shape[2]
    k = np.repeat(arrays["k"], group, axis=2)
    v = np.repeat(arrays["v"], group, axis=2)
    jkw = _jax_kwargs(extra)
    want = np.asarray(jax_dense(jnp.asarray(arrays["q"]), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                lengths=jkw.get("kv_lengths"),
                                segment_ids=jkw.get("segment_ids")))
    out, _ = _torch_run(name)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    tkw = _torch_kwargs(extra)
    mine = attention_reference(
        torch.from_numpy(arrays["q"]), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, lengths=tkw.get("kv_lengths"),
        segment_ids=tkw.get("segment_ids"))
    np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=1e-5)


def test_empty_rows_are_zero_and_nan_free():
    """T_q > T_kv causal: the first T_q - T_kv rows see no key."""
    out, grads = _torch_run("causal_tq_gt_tkv_empty_rows")
    assert torch.all(out[:, :20] == 0)
    assert all(torch.isfinite(g).all() for g in grads)


def test_ops_reference_matches_jax_reference():
    arrays, _, _, _ = _inputs("causal_tq_gt_tkv_empty_rows")
    from petastorm_tpu.ops.flash_attention import _attention_reference

    want = _attention_reference(*(jnp.asarray(arrays[x]) for x in "qkv"),
                                causal=True)
    got = attention_reference(*(torch.from_numpy(arrays[x]) for x in "qkv"),
                              causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _bad(kind):
    rng = np.random.RandomState(0)
    q = rng.randn(2, 8, 4, 16).astype(np.float32)
    kv = rng.randn(2, 8, 4, 16).astype(np.float32)
    seg = np.zeros((2, 8), np.int32)
    if kind == "kv_heads_differ":
        return q, kv, kv[:, :, :2], {}
    if kind == "heads_do_not_group":
        return q, kv[:, :, :3], kv[:, :, :3], {}
    if kind == "seg_and_lens":
        return q, kv, kv, {"segment_ids": seg, "kv_lengths": np.full(2, 8, np.int32)}
    if kind == "seg_1d":
        return q, kv, kv, {"segment_ids": seg[0]}
    if kind == "seg_single_cross_length":
        return q, kv[:, :6], kv[:, :6], {"segment_ids": seg}
    if kind == "seg_wrong_t":
        return q, kv, kv, {"segment_ids": seg[:, :5]}
    if kind == "seg_pair_swapped":
        return q, kv[:, :6], kv[:, :6], {"segment_ids": (seg[:, :6], seg)}
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["kv_heads_differ", "heads_do_not_group",
                                  "seg_and_lens", "seg_1d",
                                  "seg_single_cross_length", "seg_wrong_t",
                                  "seg_pair_swapped"])
def test_same_value_errors_as_jax(kind):
    q, k, v, extra = _bad(kind)
    with pytest.raises(ValueError) as jax_err:
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  **_jax_kwargs(extra))
    with pytest.raises(ValueError) as port_err:
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), device="cpu",
                           **_torch_kwargs(extra))
    assert str(port_err.value) == str(jax_err.value)

