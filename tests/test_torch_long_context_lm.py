"""The port's long-context LM against the JAX capstone
(``examples/long_context_lm/train_lm.py``) on carried-over weights: logits,
loss, every parameter gradient and a 3-step SGD loss trajectory agree within
1e-4 (f32 on the CPU; the port runs its flash kernels' plain versions, the
JAX side its dense oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.long_context_lm import train_lm as capstone
from petastorm_tpu.jax_utils.packing import (
    PACK_POSITION_KEY,
    PACK_SEGMENT_KEY,
    pack_ragged,
)
from petastorm_tpu_torch.models.long_context_lm import (
    generate_corpus,
    init_lm_params,
    lm_loss,
    make_lm_train_step,
    params_from_jax,
    train_lm,
)

D_MODEL, HEADS, LAYERS, SLOT_LEN, SLOTS = 32, 2, 2, 32, 4


@pytest.fixture(scope="module")
def setup():
    params = capstone.init_lm_params(jax.random.PRNGKey(0), d_model=D_MODEL,
                                     num_heads=HEADS, num_layers=LAYERS,
                                     slot_len=SLOT_LEN)
    numpy_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(3)
    rows = []
    for _ in range(40):
        n = int(rng.randint(4, 20))
        rows.append({"tokens": ((np.cumsum(rng.randint(0, 3, n))
                                 + rng.randint(capstone.VOCAB))
                                % capstone.VOCAB).astype(np.int32)})
    batches = list(pack_ragged(iter(rows), slot_len=SLOT_LEN, slots=SLOTS))
    batch = batches[0]
    return params, numpy_params, batches, (batch["tokens"],
                                           batch[PACK_POSITION_KEY],
                                           batch[PACK_SEGMENT_KEY])


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def _jax_loss(params, tokens, positions, segment_ids):
    logits = capstone.apply_lm(params, tokens, positions, segment_ids, HEADS)
    logp = jax.nn.log_softmax(logits[:, :-1])
    nll = -jnp.take_along_axis(logp, tokens[:, 1:, None].astype(jnp.int32),
                               axis=2)[..., 0]
    cont = ((segment_ids[:, 1:] == segment_ids[:, :-1])
            & (segment_ids[:, 1:] >= 0)).astype(jnp.float32)
    return (nll * cont).sum() / jnp.maximum(cont.sum(), 1.0)


def test_params_from_jax_keeps_layout(setup):
    _, numpy_params, _, _ = setup
    model = params_from_jax(numpy_params, HEADS, device="cpu")
    np.testing.assert_array_equal(model.embed.detach().numpy(), numpy_params["embed"])
    np.testing.assert_array_equal(model.pos.detach().numpy(), numpy_params["pos"])
    for blk, src in zip(model.blocks, numpy_params["blocks"]):
        for name in ("wq", "wk", "wv", "wo", "ffn"):
            np.testing.assert_array_equal(getattr(blk, name).detach().numpy(), src[name])


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_logits_match_capstone(setup, attn_impl):
    params, numpy_params, _, batch = setup
    model = params_from_jax(numpy_params, HEADS, device="cpu")
    want = np.asarray(capstone.apply_lm(params, *map(jnp.asarray, batch), HEADS))
    with torch.no_grad():
        got = model(*_torch_batch(batch), attn_impl=attn_impl).numpy()
    assert got.shape == want.shape == (SLOTS, SLOT_LEN, capstone.VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_loss_and_every_gradient_match_capstone(setup):
    params, numpy_params, _, batch = setup
    model = params_from_jax(numpy_params, HEADS, device="cpu")
    loss, grads = jax.value_and_grad(_jax_loss)(params, *map(jnp.asarray, batch))
    got = lm_loss(model, *_torch_batch(batch))
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-4 * abs(float(loss))

    def rel(port, ref):
        ref = np.asarray(ref)
        return np.abs(port.grad.numpy() - ref).max() / np.abs(ref).max()

    assert rel(model.embed, grads["embed"]) <= 1e-4
    assert rel(model.pos, grads["pos"]) <= 1e-4
    for blk, ref in zip(model.blocks, grads["blocks"]):
        for name in ("wq", "wk", "wv", "wo", "ffn"):
            assert rel(getattr(blk, name), ref[name]) <= 1e-4, name


def test_three_sgd_steps_match_capstone(setup):
    params, numpy_params, batches, _ = setup
    step = jax.jit(capstone.make_lm_train_step(HEADS))
    model = params_from_jax(numpy_params, HEADS, device="cpu")
    port_step = make_lm_train_step(model)
    for packed in batches[:3]:
        batch = (packed["tokens"], packed[PACK_POSITION_KEY], packed[PACK_SEGMENT_KEY])
        params, loss = step(params, *map(jnp.asarray, batch))
        got = float(port_step(*_torch_batch(batch)))
        assert abs(got - float(loss)) <= 1e-4 * abs(float(loss))


def test_init_matches_capstone_distributions():
    model = init_lm_params(seed=1, d_model=64, num_heads=4, device="cpu")
    assert abs(model.embed.std().item() - 0.05) < 0.005
    assert abs(model.pos.std().item() - 0.02) < 0.002
    assert abs(model.blocks[0].wq.std().item() - 1 / 8) < 0.01


def test_train_lm_on_cpu(tmp_path):
    url = f"file://{tmp_path}/corpus"
    generate_corpus(url, docs=256, max_len=32)
    result = train_lm(url, slot_len=64, slots=4, steps=12, d_model=32,
                      num_heads=2, device="cpu")
    losses = result["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert result["batch_devices"] == ["cpu"]
    assert result["logit_parity"] < 2e-4
    assert "input_stall_pct" in result["diagnostics"]
