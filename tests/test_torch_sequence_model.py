"""The port's sequence encoder with no process group against the JAX
package's ``models/sequence_model.py`` on carried-over weights and the same
seeded numpy windows: logits of every attention path (dense oracle, the
flash kernels' plain versions against the JAX Pallas kernels in interpret
mode), causal or not, with ``lengths`` or not, and one SGD step's loss and
parameters. f32 compute on both sides; tolerances 1e-4 relative to the
largest value (the two sides sum in other orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models import sequence_model as jsm
from petastorm_tpu_torch.models import sequence_model as sm

B, T, F, D_MODEL, HEADS, CLASSES = 4, 16, 6, 32, 4, 3
PARAM_NAMES = ("embed", "pos", "wq", "wk", "wv", "wo", "cls")


@functools.lru_cache(maxsize=None)
def _setup():
    params = jsm.init_seq_params(jax.random.PRNGKey(3), feature_dim=F, d_model=D_MODEL,
                                 num_heads=HEADS, num_classes=CLASSES, max_len=32)
    rng = np.random.RandomState(11)
    windows = rng.randn(B, T, F).astype(np.float32)
    lengths = np.array([T, 5, 9, 1], np.int32)
    labels = np.array([0, 2, 1, 2], np.int32)
    mask = np.array([True, True, False, True])
    return params, {k: np.asarray(v) for k, v in params.items()}, windows, lengths, labels, mask


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-6)


CONFIGS = [(impl, causal, lens) for impl in ("dense", "flash", "ring")
           for causal in (False, True) for lens in (False, True)]


@pytest.mark.parametrize("impl,causal,lens", CONFIGS)
def test_logits_match_jax(impl, causal, lens):
    params, numpy_params, windows, lengths, _, _ = _setup()
    want = jsm.apply_seq_model(params, jnp.asarray(windows), num_heads=HEADS,
                               compute_dtype=jnp.float32, attn_impl=impl, causal=causal,
                               lengths=jnp.asarray(lengths) if lens else None)
    model = sm.params_from_jax(numpy_params, HEADS, device="cpu")
    with torch.no_grad():
        got = sm.apply_seq_model(model, torch.from_numpy(windows),
                                 compute_dtype=torch.float32, attn_impl=impl, causal=causal,
                                 lengths=torch.from_numpy(lengths) if lens else None)
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES)
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("impl,causal", [("dense", False), ("flash", True), ("ring", True)])
def test_one_train_step_matches_jax(impl, causal):
    params, numpy_params, windows, lengths, labels, mask = _setup()
    new_params, loss = jax.jit(_jax_f32_step(impl, causal))(
        params, jnp.asarray(windows), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(lengths))
    model = sm.params_from_jax(numpy_params, HEADS, device="cpu")
    port_step = sm.make_seq_train_step(model, 0.05, attn_impl=impl, causal=causal,
                                       compute_dtype=torch.float32)
    got = port_step(torch.from_numpy(windows), torch.from_numpy(labels),
                    torch.from_numpy(mask), torch.from_numpy(lengths))
    assert abs(float(got) - float(loss)) <= 1e-4 * abs(float(loss))
    for name in PARAM_NAMES:
        assert _rel(getattr(model, name).detach().numpy(), new_params[name]) <= 1e-4, name


def _jax_f32_step(impl, causal):
    """The JAX package's ``make_seq_train_step`` loss and SGD update, with
    ``apply_seq_model`` in f32 (that step computes in its bf16 default)."""
    def loss_fn(params, windows, labels, mask, lengths):
        logits = jsm.apply_seq_model(params, windows, num_heads=HEADS,
                                     compute_dtype=jnp.float32, attn_impl=impl,
                                     causal=causal, lengths=lengths)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        nll = jnp.where(mask, nll, 0.0)
        return nll.sum() / jnp.maximum(mask.sum(), 1).astype(jnp.float32)

    def step(params, windows, labels, mask, lengths):
        loss, grads = jax.value_and_grad(loss_fn)(params, windows, labels, mask, lengths)
        return jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, params, grads), loss

    return step


def test_ring_and_ulysses_need_a_group_as_in_jax():
    params, numpy_params, windows, _, _, _ = _setup()
    with pytest.raises(ValueError) as jax_err:
        jsm.apply_seq_model(params, jnp.asarray(windows), num_heads=HEADS,
                            attn_impl="ulysses")
    model = sm.params_from_jax(numpy_params, HEADS, device="cpu")
    with pytest.raises(ValueError) as port_err:
        sm.apply_seq_model(model, torch.from_numpy(windows), attn_impl="ulysses")
    assert str(port_err.value) == str(jax_err.value)


def test_bf16_default_compute_is_finite_and_near_f32():
    _, numpy_params, windows, lengths, _, _ = _setup()
    model = sm.params_from_jax(numpy_params, HEADS, device="cpu")
    with torch.no_grad():
        f32 = sm.apply_seq_model(model, torch.from_numpy(windows), attn_impl="flash",
                                 causal=True, lengths=torch.from_numpy(lengths),
                                 compute_dtype=torch.float32)
        bf16 = sm.apply_seq_model(model, torch.from_numpy(windows), attn_impl="flash",
                                  causal=True, lengths=torch.from_numpy(lengths))
    assert torch.isfinite(bf16).all()
    # bf16 keeps 8 bits of mantissa through three products
    assert _rel(bf16.numpy(), f32.numpy()) <= 5e-2


def test_params_from_jax_keeps_layout():
    _, numpy_params, _, _, _, _ = _setup()
    model = sm.params_from_jax(numpy_params, HEADS, device="cpu")
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      numpy_params[name])


def test_init_matches_jax_distributions():
    model = sm.init_seq_params(0, feature_dim=64, d_model=64, num_heads=4, device="cpu")
    assert abs(model.pos.std().item() - 0.02) < 0.002
    assert abs(model.wq.std().item() - 1 / 8) < 0.01
    assert abs(model.embed.std().item() - 1 / 8) < 0.01


@pytest.mark.parametrize("sp", [2, 4])
def test_stripe_matches_jax(sp):
    x = np.arange(2 * 8 * 3).reshape(2, 8, 3).astype(np.float32)
    striped = sm._stripe(torch.from_numpy(x), sp)
    np.testing.assert_array_equal(striped.numpy(), np.asarray(jsm._stripe(jnp.asarray(x), sp)))
    np.testing.assert_array_equal(sm._unstripe(striped, sp).numpy(), x)


@pytest.mark.parametrize("on_cuda,t_full,want", [
    (False, 24, "dense"), (False, sm.ULYSSES_FLASH_THRESHOLD, "flash"),
    (True, 5, "flash"), (True, 24, "flash")])
def test_auto_local_attention_is_the_kernels_on_the_card(on_cuda, t_full, want):
    """``local_attn="auto"``: the flash kernels for CUDA tensors at any
    length; for CPU tensors the JAX package's rule (flash from
    ``ULYSSES_FLASH_THRESHOLD`` timesteps). An explicit choice stands."""
    from types import SimpleNamespace

    q = SimpleNamespace(is_cuda=on_cuda)
    assert sm._resolve_local_attn(q, t_full, "auto") == want
    assert sm._resolve_local_attn(q, t_full, "dense") == "dense"
    with pytest.raises(ValueError, match="local_attn"):
        sm._resolve_local_attn(q, t_full, "sparse")
