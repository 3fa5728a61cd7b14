"""The port's ``flash_attention_with_lse`` (plain PyTorch versions of the
CUDA kernels, on the CPU) against the JAX package's Pallas kernels in
interpret mode, on the same seeded numpy inputs: the output, the public lse
(``-inf`` in the same places) and the gradients of a loss that reads both
outputs, so the lse cotangent runs through the backward.

Cases: every case of ``test_torch_flash_attention.py`` at ``causal_shift``
0, plus strict causal (``causal_shift=-1``), a causal ``(q_ids, kv_ids)``
pair at strict causal as the striped ring runs it, and head dim 8.
Tolerances are that file's (``_tol``).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.ops.flash_attention import flash_attention_with_lse as jax_with_lse
from petastorm_tpu_torch.ops import flash_attention as fa
from test_torch_flash_attention import CASES as BASE_CASES
from test_torch_flash_attention import _jax_kwargs, _segments, _tol, _torch_kwargs

#: name -> (b, t_q, t_kv, h, h_kv, d, causal, aux, dtype, causal_shift)
CASES = {name: case + (0,) for name, case in BASE_CASES.items()}
CASES.update({
    "strict_causal": (2, 64, 64, 2, 2, 16, True, None, "float32", -1),
    "strict_causal_pair": (2, 48, 48, 4, 2, 16, True, "pair", "float32", -1),
    "d8_causal_segments": (2, 40, 40, 4, 4, 8, True, "seg", "float32", 0),
    "d8_strict_causal_lens": (3, 24, 24, 4, 4, 8, True, "lens", "float32", -1),
    "d8_pair": (2, 24, 32, 2, 1, 8, False, "pair", "float32", 0),
})


@functools.lru_cache(maxsize=None)
def _inputs(name):
    b, t_q, t_kv, h, h_kv, d, causal, aux, dtype, shift = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)) + 7)
    arrays = {
        "q": rng.randn(b, t_q, h, d).astype(np.float32),
        "k": rng.randn(b, t_kv, h_kv, d).astype(np.float32),
        "v": rng.randn(b, t_kv, h_kv, d).astype(np.float32),
        "do": rng.randn(b, t_q, h, d).astype(np.float32),
        "dlse": rng.randn(b, t_q, h).astype(np.float32),
    }
    if dtype == "bfloat16":
        arrays = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                  for k, v in arrays.items()}
    extra = {}
    if aux == "lens":
        extra["kv_lengths"] = np.array([t_kv, t_kv // 3, 0][:b], np.int32)
    elif aux == "seg":
        extra["segment_ids"] = _segments(rng, b, t_q)
    elif aux == "pair":
        extra["segment_ids"] = (_segments(rng, b, t_q), _segments(rng, b, t_kv))
    return arrays, extra, causal, dtype, shift


def _loss(out, lse, do, dlse, where):
    """sum(out * do) + sum(lse * dlse) over the rows that see a key."""
    return (out * do).sum() + where(lse > -np.inf, lse * dlse, 0.0).sum()


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    arrays, extra, causal, dtype, shift = _inputs(name)
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(arrays[x], jdt) for x in "qkv")
    kw = _jax_kwargs(extra)

    def f(q, k, v):
        out, lse = jax_with_lse(q, k, v, causal=causal, causal_shift=shift, **kw)
        return _loss(out.astype(jnp.float32), lse, jnp.asarray(arrays["do"]),
                     jnp.asarray(arrays["dlse"]), jnp.where), (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return f32(out), f32(lse), tuple(f32(g) for g in grads)


def _torch_results(name):
    arrays, extra, causal, dtype, shift = _inputs(name)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(arrays[x], dtype=tdt, requires_grad=True) for x in "qkv")
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, causal_shift=shift,
                                           device="cpu", **_torch_kwargs(extra))
    _loss(out.float(), lse, torch.tensor(arrays["do"]),
          torch.tensor(arrays["dlse"]), torch.where).backward()
    return out.detach().float().numpy(), lse.detach().numpy(), tuple(
        t.grad.float().numpy() for t in (q, k, v))


@pytest.mark.parametrize("name", sorted(CASES))
def test_with_lse_matches_jax(name):
    dtype = CASES[name][8]
    out, lse, grads = _torch_results(name)
    jax_out, jax_lse, jax_grads = _jax_results(name)
    assert lse.dtype == np.float32 and lse.shape == jax_lse.shape
    np.testing.assert_allclose(out, jax_out, rtol=0, atol=_tol(dtype)[0])
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(jax_lse))
    assert not np.isposinf(lse).any() and not np.isnan(lse).any()
    finite = np.isfinite(jax_lse)
    np.testing.assert_allclose(lse[finite], jax_lse[finite], rtol=0, atol=_tol(dtype)[0])
    for got, want in zip(grads, jax_grads):
        assert np.isfinite(got).all()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale <= _tol(dtype)[1]


def test_strict_causal_leaves_row_zero_empty_and_nan_free():
    out, lse, grads = _torch_results("strict_causal")
    assert np.isneginf(lse[:, 0]).all() and np.isfinite(lse[:, 1:]).all()
    assert (out[:, 0] == 0).all()
    assert all(np.isfinite(g).all() for g in grads)


def test_dlse_enters_delta_with_a_minus_sign():
    """The plain dQ version returns ``rowsum(do * o) - dlse`` as delta, the
    quantity both backward kernels read."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.tensor(rng.randn(2, 16, 2, 8), dtype=torch.float32)
                   for _ in range(4))
    o, lse = fa.flash_forward_plain(q, k, v, causal=True)
    dlse = torch.tensor(rng.randn(4, 16), dtype=torch.float32)
    _, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=True)
    _, delta_dlse = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal=True, dlse=dlse)
    torch.testing.assert_close(delta_dlse, delta - dlse, rtol=0, atol=0)


def test_flash_attention_output_equals_with_lse_output():
    arrays, extra, causal, _, _ = _inputs("causal_ragged_tile")
    q, k, v = (torch.from_numpy(arrays[x]) for x in "qkv")
    out = fa.flash_attention(q, k, v, causal=causal, device="cpu", **_torch_kwargs(extra))
    out2, _ = fa.flash_attention_with_lse(q, k, v, causal=causal, device="cpu",
                                          **_torch_kwargs(extra))
    assert torch.equal(out, out2)


@pytest.mark.parametrize("d", [8, 24, 100])
def test_kernel_head_dim_padding_plan(d):
    """Head dims the kernels are not instantiated for are zero-padded to the
    next instantiated one, with the true head dim's scale; instantiated ones
    are never padded, and the kernels' input checks take only those."""
    dk = fa._kernel_head_dim(d)
    assert dk in fa.KERNEL_HEAD_DIMS and dk >= d
    assert all(fa._kernel_head_dim(x) == x for x in fa.KERNEL_HEAD_DIMS)
    t = torch.randn(2, 3, 4, d)
    (padded, _), scale = fa.pad_head_dim(t, t)
    assert scale == 1.0 / math.sqrt(d)
    assert padded.shape[-1] == dk and torch.equal(padded[..., :d], t)
    assert (padded[..., d:] == 0).all()
    assert torch.equal(fa._unpad_head_dim(padded, d), t)
    assert fa.pad_head_dim(padded)[0][0] is padded
    fa._check_kernel_inputs(padded, padded, padded)
    with pytest.raises(ValueError, match="D in"):
        fa._check_kernel_inputs(t, t, t)
    with pytest.raises(ValueError, match="D in"):
        fa._check_kernel_inputs(*(torch.zeros(1, 2, 1, 136),) * 3)


@pytest.mark.parametrize("d", [8, 24])
def test_padded_plain_versions_equal_the_true_head_dim(d):
    """The layout the autograd functions give the kernels: the plain
    versions on zero-padded inputs with ``1 / sqrt(d)`` compute the true
    head dim's outputs and gradients (the padded columns come out zero)."""
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.tensor(rng.randn(2, 40, 2, d), dtype=torch.float32)
                   for _ in range(4))
    dlse = torch.tensor(rng.randn(4, 40), dtype=torch.float32)
    kw = dict(causal=True, causal_offset=-1)
    o, lse = fa.flash_forward_plain(q, k, v, **kw)
    grads = fa.flash_backward_plain(q, k, v, o, lse, do, dlse=dlse, **kw)
    (qp, kp, vp, dop), scale = fa.pad_head_dim(q, k, v, do)
    op, lsep = fa.flash_forward_plain(qp, kp, vp, scale=scale, **kw)
    gradsp = fa.flash_backward_plain(qp, kp, vp, op, lsep, dop, dlse=dlse, scale=scale, **kw)
    torch.testing.assert_close(op[..., :d], o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lsep, lse, rtol=0, atol=1e-6)
    for got, want in zip(gradsp, grads):
        assert (got[..., d:] == 0).all()
        torch.testing.assert_close(got[..., :d], want, rtol=0, atol=1e-5)
