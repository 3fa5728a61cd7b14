"""The MNIST example's store, transform and model for the port
(counterparts of ``examples/mnist/generate_petastorm_mnist.py`` and
``examples/mnist/pytorch_example.py``).

- :data:`MnistSchema`: ``idx`` int64, ``digit`` int64, ``image`` uint8
  28x28 as png; :func:`generate_mnist_dataset` writes it in row groups of
  200, as the example does, from the example's synthetic digits
  (``RandomState(seed)``: random pixels and labels; the real corpus is not
  read here);
- :data:`MNIST_TRANSFORM`: the example's ``_to_float`` (the image as
  float32 in [0, 1]) as a TransformSpec;
- :func:`init_mnist_mlp`: the example's model at full width (Flatten,
  784→128, ReLU, 128→10) with weights from a seed, on ``device`` (the card
  unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from petastorm_tpu_torch.etl.metadata import materialize_rows
from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.schema.transform import TransformSpec
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

MnistSchema = Unischema("MnistSchema", [
    UnischemaField("idx", np.int64, (), ScalarCodec(), False),
    UnischemaField("digit", np.int64, (), ScalarCodec(), False),
    UnischemaField("image", np.uint8, (28, 28), CompressedImageCodec("png"), False),
])

MNIST_ROWS_PER_ROW_GROUP = 200


def mnist_rows(count, seed=0):
    """The example's synthetic MNIST-shaped rows: ``{"idx", "digit",
    "image"}`` dicts from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (count, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, count)
    for i, (image, label) in enumerate(zip(images, labels)):
        yield {"idx": i, "digit": int(label), "image": np.ascontiguousarray(image)}


def generate_mnist_dataset(dataset_url, count, seed=0,
                           rows_per_row_group=MNIST_ROWS_PER_ROW_GROUP):
    """Write ``count`` synthetic rows of :data:`MnistSchema` as a petastorm
    store."""
    materialize_rows(dataset_url, MnistSchema, mnist_rows(count, seed),
                     rows_per_row_group=rows_per_row_group)


def to_float(row):
    """The example's transform: the image as float32 in [0, 1]."""
    row["image"] = row["image"].astype(np.float32) / 255.0
    return row


MNIST_TRANSFORM = TransformSpec(to_float, edit_fields=[("image", np.float32, (28, 28), False)])


def init_mnist_mlp(seed=0, device="cuda"):
    """The example's MLP (Flatten, 784→128, ReLU, 128→10), initialized by
    torch's default initializers under ``seed``, on ``device``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(28 * 28, 128),
                                    torch.nn.ReLU(), torch.nn.Linear(128, 10))
    return model.to(device)
