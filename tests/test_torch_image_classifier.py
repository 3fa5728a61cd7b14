"""The port's image classifier against the JAX package's
(``petastorm_tpu/models/image_classifier.py``) on identical weights and
inputs, at 16x16x3 images, 8 conv features, hidden 32, 10 classes:

- forward in f32 compute against ``apply_model(..., compute_dtype=f32)``:
  1e-5 relative to the largest logit; in bf16 compute against the default
  bf16 ``apply_model``: 1e-2 relative (one bf16 step is 2^-8 = 3.9e-3);
- one masked SGD step in f32 compute against the same loss under
  ``jax.value_and_grad``: loss and the step's implied gradient 1e-5
  relative; and against ``make_train_step`` (bf16 compute): loss 1e-3
  relative, the implied gradient 0.15 relative to each parameter's largest
  — JAX sums the conv-bias gradient over B·H·W in bf16 (11 % off the f32
  gradient on one input where the port's bf16 sum is 2 % off);
- a check that an NCHW flatten before ``dense1`` would fail the parity test;
- the whole image path on the CPU (``train_image_classifier``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.models.image_classifier import apply_model, init_params, make_train_step
from petastorm_tpu_torch.models.image_classifier import (
    generate_image_dataset,
    init_image_classifier,
    make_image_train_step,
    masked_cross_entropy,
    params_from_jax,
    train_image_classifier,
)
from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage

SHAPE, CLASSES, LR = (16, 16, 3), 10, 0.01
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(1), SHAPE, CLASSES, hidden=32, conv_features=8)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(0)
    for layer in np_params.values():  # non-zero biases, so their layout is checked too
        layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
    x = (2 * rng.rand(6, *SHAPE) - 1).astype(np.float32)
    labels = rng.randint(0, CLASSES, 6).astype(np.int32)
    mask = np.array([True, True, True, True, False, False])
    return np_params, x, labels, mask


def _jax(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _state(np_params):
    return params_from_jax(np_params, SHAPE, device="cpu").state_dict()


@pytest.mark.parametrize("compute,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_forward_matches_apply_model(setup, compute, tol):
    np_params, x, _, _ = setup
    jax_dtype, torch_dtype = DTYPES[compute]
    want = np.asarray(apply_model(_jax(np_params), jnp.asarray(x), compute_dtype=jax_dtype))
    model = params_from_jax(np_params, SHAPE, compute_dtype=torch_dtype, device="cpu")
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (6, CLASSES)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_an_nchw_flatten_would_fail_the_parity_test(setup):
    """dense1's rows are in JAX's (h, w, feature) order: flattening the
    conv output in NCHW order feeds them the wrong features."""
    np_params, x, _, _ = setup
    want = np.asarray(apply_model(_jax(np_params), jnp.asarray(x), compute_dtype=jnp.float32))
    model = params_from_jax(np_params, SHAPE, compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        h = torch.relu(torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), model.conv_weight, padding=1)
            + model.conv_bias[:, None, None])
        h = torch.nn.functional.avg_pool2d(h, 2).reshape(6, -1)  # NCHW flatten
        h = torch.relu(h @ model.dense1_kernel + model.dense1_bias)
        nchw = (h @ model.dense2_kernel + model.dense2_bias).numpy()
    assert np.abs(nchw - want).max() > 100 * 1e-5 * np.abs(want).max()


def _jax_f32_step(params, x, labels, mask):
    """``make_train_step``'s loss and SGD update with f32 compute."""
    def loss_fn(params):
        logp = jax.nn.log_softmax(apply_model(params, x, compute_dtype=jnp.float32))
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        nll = jnp.where(mask, nll, 0.0)
        return nll.sum() / jnp.maximum(mask.sum(), 1).astype(jnp.float32)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return jax.tree_util.tree_map(lambda p, g: p - LR * g, params, grads), loss


@pytest.mark.parametrize("compute,loss_tol,grad_tol", [("f32", 1e-5, 1e-5),
                                                       ("bf16", 1e-3, 0.15)])
def test_one_masked_sgd_step_matches_jax(setup, compute, loss_tol, grad_tol):
    np_params, x, labels, mask = setup
    args = (jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    if compute == "f32":
        new_params, want_loss = _jax_f32_step(_jax(np_params), *args)
    else:
        new_params, want_loss = make_train_step(LR)(_jax(np_params), *args)
    model = params_from_jax(np_params, SHAPE, compute_dtype=DTYPES[compute][1], device="cpu")
    loss = make_image_train_step(model, LR)(torch.from_numpy(x), torch.from_numpy(labels),
                                            torch.from_numpy(mask))
    assert abs(float(loss) - float(want_loss)) <= loss_tol * abs(float(want_loss))
    before, want = _state(np_params), _state(jax.tree_util.tree_map(np.asarray, new_params))
    for name, p in model.state_dict().items():
        got_grad, want_grad = (before[name] - p) / LR, (before[name] - want[name]) / LR
        scale = want_grad.abs().max()
        assert scale > 0 and (got_grad - want_grad).abs().max() <= grad_tol * scale, name


def test_masked_rows_add_nothing_to_the_loss(setup):
    _, x, labels, mask = setup
    logits = torch.randn(6, CLASSES, generator=torch.Generator().manual_seed(0))
    full = masked_cross_entropy(logits[:4], torch.from_numpy(labels[:4]),
                                torch.ones(4, dtype=torch.bool))
    masked = masked_cross_entropy(logits, torch.from_numpy(labels), torch.from_numpy(mask))
    assert torch.allclose(full, masked, rtol=1e-6, atol=0)
    assert masked_cross_entropy(logits, torch.from_numpy(labels),
                                torch.zeros(6, dtype=torch.bool)) == 0


def test_init_draws_the_reference_scales():
    model = init_image_classifier((32, 32, 3), CLASSES, hidden=64, conv_features=16,
                                  device="cpu").requires_grad_(False)
    assert model.dense1_kernel.shape == (16 * 16 * 16, 64)
    assert abs(float(model.dense1_kernel.std()) * 64 - 1) < 0.05  # N(0, 1/4096)
    assert abs(float(model.conv_weight.std()) * np.sqrt(27) - 1) < 0.1
    assert float(model.dense2_bias.abs().max()) == 0.0


def test_train_image_classifier_on_the_cpu(tmp_path):
    url = f"file://{tmp_path}/images"
    generate_image_dataset(url, CompressedImageCodec("png"), rows=80, image_shape=SHAPE,
                           rows_per_row_group=16)
    stage = DeviceStage(normalize=(127.5, 127.5), crop=(12, 12), flip=True)
    result = train_image_classifier(url, batch_size=32, epochs=4, conv_features=8, hidden=32,
                                    learning_rate=0.05, device_stage=stage,
                                    reader_pool_type="dummy", device="cpu")
    losses = result["losses"]
    # 4 epochs of 80 rows are one stream of 10 batches; the warm-up is an
    # epoch's worth of steps.
    assert result["warmup_steps"] == 3 and len(losses) == 10
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3])
    assert result["batch_devices"] == ["cpu"]
    assert result["model"].dense1_kernel.shape == (6 * 6 * 8, 32)  # the crop's size
    diag = result["diagnostics"]
    assert diag["rows"] == 10 * 32 and diag["device_decode_s"] > 0
    assert result["images_per_s"] > 0 and result["peak_memory_bytes"] is None
