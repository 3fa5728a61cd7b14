"""Delivery to PyTorch on the card (counterpart of ``petastorm_tpu/jax_utils``)."""

from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader  # noqa: F401
from petastorm_tpu_torch.torch_utils.packing import (  # noqa: F401
    PACK_POSITION_KEY,
    PACK_SEGMENT_KEY,
    make_packed_torch_dataloader,
    pack_ragged,
    packed_valid_mask,
)
