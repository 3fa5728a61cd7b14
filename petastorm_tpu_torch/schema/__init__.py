"""Tensor-aware schema (``Unischema``) and column codecs."""

from petastorm_tpu_torch.schema.codecs import (  # noqa: F401
    CompressedImageCodec,
    CompressedNdarrayCodec,
    NdarrayCodec,
    ScalarCodec,
)
from petastorm_tpu_torch.schema.unischema import (  # noqa: F401
    Unischema,
    UnischemaField,
    match_unischema_fields,
)
