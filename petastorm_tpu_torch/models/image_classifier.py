"""Small CNN image classifier trained from a petastorm image dataset, on the card.

Counterpart of ``petastorm_tpu/models/image_classifier.py`` (``init_params``,
``apply_model``, ``make_train_step``; its sharding specs are not ported) and
of the image path that feeds it: ``make_reader`` over an image dataset →
:func:`make_torch_dataloader` with a :class:`DeviceStage` (uint8 bytes
staged, crop / flip / cast / normalize on the card) → conv3x3 → relu → 2x2
mean-pool → dense → relu → dense → masked mean cross-entropy → plain SGD.

The module computes in ``compute_dtype`` (bfloat16 by default) and keeps
float32 parameters, cast at each use, as the reference does. Weights keep
the JAX layouts where the math allows: dense kernels ``[d_in, d_out]``
(``x @ w``), and the flatten before ``dense1`` runs over NHWC, so
``dense1``'s rows are in (h, w, feature) order as JAX's are. The conv
kernel is OIHW (JAX's is HWIO); "SAME" 3x3 at stride 1 is padding 1.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.ops.flash_attention import resolve_device


def generate_image_dataset(dataset_url, image_codec, rows=1536, image_shape=(64, 64, 3),
                           num_classes=10, rows_per_row_group=128, seed=0):
    """The image benchmark's schema (``id`` int64, ``image`` uint8 through
    ``image_codec``, ``features`` f32 ``(16,)``, ``label`` int32) with
    learnable labels: each image's pixels are ``24 + 20 * label`` plus
    seeded noise (N(0, 24²), clipped to uint8)."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("ImageSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, image_shape, image_codec, False),
        UnischemaField("features", np.float32, (16,), NdarrayCodec(), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(seed)

    def make_rows():
        for i in range(rows):
            label = i % num_classes
            pixels = 24 + 20 * label + 24 * rng.randn(*image_shape)
            yield {"id": np.int64(i),
                   "image": np.clip(np.rint(pixels), 0, 255).astype(np.uint8),
                   "features": rng.rand(16).astype(np.float32),
                   "label": np.int32(label)}

    materialize_rows(dataset_url, schema, make_rows(), rows_per_row_group=rows_per_row_group)
    return dataset_url


class ImageClassifier(nn.Module):
    """conv3x3 → relu → 2x2 mean-pool → dense → relu → dense over
    ``[B, H, W, C]`` images; f32 logits ``[B, num_classes]``."""

    def __init__(self, image_shape, num_classes, hidden=256, conv_features=32,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        h, w, c = image_shape
        flat = (h // 2) * (w // 2) * conv_features
        self.compute_dtype = compute_dtype
        self.conv_weight = nn.Parameter(torch.zeros(conv_features, c, 3, 3))
        self.conv_bias = nn.Parameter(torch.zeros(conv_features))
        self.dense1_kernel = nn.Parameter(torch.zeros(flat, hidden))
        self.dense1_bias = nn.Parameter(torch.zeros(hidden))
        self.dense2_kernel = nn.Parameter(torch.zeros(hidden, num_classes))
        self.dense2_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, images):
        cd = self.compute_dtype
        x = images.to(cd).permute(0, 3, 1, 2)
        # The bias is added after the conv, in the compute dtype, as the
        # reference does (a fused conv bias would round once instead of twice).
        x = F.conv2d(x, self.conv_weight.to(cd), padding=1)
        x = torch.relu(x + self.conv_bias.to(cd)[:, None, None])
        x = F.avg_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = torch.relu(x @ self.dense1_kernel.to(cd) + self.dense1_bias.to(cd))
        logits = x @ self.dense2_kernel.to(cd) + self.dense2_bias.to(cd)
        return logits.float()


def init_image_classifier(image_shape, num_classes, hidden=256, conv_features=32,
                          compute_dtype=torch.bfloat16, seed=0, device="cuda"):
    """An :class:`ImageClassifier` with the reference's initial
    distributions (kernels ~ N(0, 1/fan_in), zero biases), drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``."""
    device = resolve_device(device)
    model = ImageClassifier(image_shape, num_classes, hidden, conv_features, compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    c = image_shape[2]
    with torch.no_grad():
        for p, fan_in in ((model.conv_weight, 9 * c),
                          (model.dense1_kernel, model.dense1_kernel.shape[0]),
                          (model.dense2_kernel, model.dense2_kernel.shape[0])):
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    return model.to(device)


def params_from_jax(numpy_params, image_shape, compute_dtype=torch.bfloat16,
                    device="cuda"):
    """The JAX classifier's parameter pytree (numpy arrays: ``conv``,
    ``dense1``, ``dense2``, each ``{kernel, bias}``) as an
    :class:`ImageClassifier` on ``device``: the conv kernel goes HWIO →
    OIHW; the dense kernels are copied as they are."""
    device = resolve_device(device)
    conv = np.asarray(numpy_params["conv"]["kernel"], np.float32)
    d1 = np.asarray(numpy_params["dense1"]["kernel"], np.float32)
    d2 = np.asarray(numpy_params["dense2"]["kernel"], np.float32)
    model = ImageClassifier(image_shape, d2.shape[1], hidden=d1.shape[1],
                            conv_features=conv.shape[3], compute_dtype=compute_dtype)
    tensors = {
        "conv_weight": conv.transpose(3, 2, 0, 1),
        "conv_bias": numpy_params["conv"]["bias"],
        "dense1_kernel": d1, "dense1_bias": numpy_params["dense1"]["bias"],
        "dense2_kernel": d2, "dense2_bias": numpy_params["dense2"]["bias"],
    }
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v, np.float32))
                           for k, v in tensors.items()})
    return model.to(device)


def masked_cross_entropy(logits, labels, mask):
    """Mean cross-entropy over the rows where ``mask`` is True (the loader's
    ``__pad_mask__``: padded rows add nothing)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(mask.sum(), min=1).float()


def make_image_train_step(model, learning_rate=0.01):
    """``step(images, labels, mask) -> loss``: one SGD step on ``model``'s
    parameters, updated in place."""

    def step(images, labels, mask):
        model.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(model(images), labels, mask)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= learning_rate * p.grad
        return loss.detach()

    return step


def train_image_classifier(dataset_url, batch_size=128, epochs=3, num_classes=10,
                           conv_features=64, hidden=2048, learning_rate=0.01,
                           device_stage=None, reader_pool_type="thread", device="cuda"):
    """The image path end to end on ``device`` (``"cuda"`` unless the caller
    asks for ``"cpu"``): ``make_reader`` (seeded row-group shuffle, ``epochs``
    epochs, 10 decode workers) → ``make_torch_dataloader(batch_size,
    last_batch="pad", device_stage=...)`` → :class:`ImageClassifier` (bf16
    compute, weights drawn from seed 0) → masked SGD. The image field is
    ``image``, the label field ``label``; ``device_stage`` defaults to
    ``DeviceStage(normalize=(127.5, 127.5))``, and its crop sets the model's
    input size.

    Returns a dict: ``losses`` (one per step), ``images_per_s`` and
    ``step_ms`` over the steps after the first epoch's (the warm-up; the
    clock starts after a sync), ``warmup_steps``, the loader's
    ``diagnostics``, ``batch_devices`` (where every batch arrived),
    ``peak_memory_bytes`` (CUDA only) and the ``model``."""
    from petastorm_tpu_torch.etl.metadata import get_schema_from_dataset_url
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    device = resolve_device(device)
    stage = device_stage or DeviceStage(normalize=(127.5, 127.5))
    h, w, c = get_schema_from_dataset_url(dataset_url).fields["image"].shape
    crop = stage.describe()["crop"]
    model = init_image_classifier(crop + (c,) if crop else (h, w, c), num_classes,
                                  hidden=hidden, conv_features=conv_features, device=device)
    step = make_image_train_step(model, learning_rate)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reader = make_reader(dataset_url, schema_fields=["image", "label"],
                         reader_pool_type=reader_pool_type, workers_count=10,
                         num_epochs=epochs, shuffle_row_groups=True, shard_seed=0)
    loader = make_torch_dataloader(reader, batch_size, last_batch="pad", device=device,
                                   device_stage=stage)
    losses, batch_devices, timed_rows, t0 = [], set(), 0, None
    with loader:
        warmup_steps = -(-reader.rows_per_epoch // batch_size)
        for i, batch in enumerate(loader):
            if i == warmup_steps:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
            batch_devices.update(str(t.device) for t in batch.values())
            images = batch["image"]
            mask = batch.get(PAD_MASK_KEY)  # only a padded last batch has one
            if mask is None:
                mask = torch.ones(images.shape[0], dtype=torch.bool, device=images.device)
            losses.append(step(images, batch["label"], mask))
            if t0 is not None:
                timed_rows += images.shape[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0 if t0 is not None else None
        diagnostics = loader.diagnostics
    timed_steps = len(losses) - warmup_steps
    if timed_steps < 1:
        raise RuntimeError(f"{len(losses)} steps leave none after the "
                           f"{warmup_steps}-step warm-up epoch: train more epochs")
    return {
        "losses": [float(x) for x in losses],
        "images_per_s": timed_rows / elapsed,
        "step_ms": 1e3 * elapsed / timed_steps,
        "warmup_steps": warmup_steps,
        "diagnostics": diagnostics,
        "batch_devices": sorted(batch_devices),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "model": model,
    }
