"""Delivery to PyTorch on the card (counterpart of ``petastorm_tpu/jax_utils``)."""

from petastorm_tpu_torch.torch_utils.batcher import (  # noqa: F401
    PAD_MASK_KEY,
    batch_iterator,
    collate_ngram_rows,
)
from petastorm_tpu_torch.torch_utils.checkpoint import (  # noqa: F401
    restore_training_state,
    save_training_state,
)
from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage  # noqa: F401
from petastorm_tpu_torch.torch_utils.loader import (  # noqa: F401
    TorchDataLoader,
    make_torch_dataloader,
)
from petastorm_tpu_torch.torch_utils.packing import (  # noqa: F401
    PACK_POSITION_KEY,
    PACK_SEGMENT_KEY,
    make_packed_torch_dataloader,
    pack_ragged,
    packed_valid_mask,
)
