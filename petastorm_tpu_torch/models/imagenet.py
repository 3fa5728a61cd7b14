"""The ImageNet example's store (the port's own copy of
``examples/imagenet/schema.py`` and the example's synthetic rows,
``examples/imagenet/generate_petastorm_imagenet.py``): ``noun_id`` and
``text`` strings and a 375x500x3 uint8 png image, written by the example
with ``row_group_size_mb=64``."""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

IMAGE_SHAPE = (375, 500, 3)

ImagenetSchema = Unischema("ImagenetSchema", [
    UnischemaField("noun_id", str, (), ScalarCodec(), False),
    UnischemaField("text", str, (), ScalarCodec(), False),
    UnischemaField("image", np.uint8, IMAGE_SHAPE, CompressedImageCodec("png"), False),
])


def synthetic_rows(count, seed=0):
    """The example's synthetic rows: one ``RandomState(seed)`` stream of
    ``count`` random images (the example's seed is 0)."""
    rng = np.random.RandomState(seed)
    for i in range(count):
        yield {"noun_id": f"n{i:08d}", "text": f"synthetic noun {i}",
               "image": rng.randint(0, 255, IMAGE_SHAPE, dtype=np.uint8)}
