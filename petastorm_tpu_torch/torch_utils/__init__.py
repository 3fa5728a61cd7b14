"""Delivery to PyTorch on the card (counterpart of ``petastorm_tpu/jax_utils``).

Exports are lazy: importing a submodule that needs no torch (``batcher``,
which the data service's workers collate with) imports no torch, so a
worker process never loads the CUDA libraries.
"""

import importlib

_LAZY_EXPORTS = {
    "PAD_MASK_KEY": "batcher", "batch_iterator": "batcher",
    "collate_ngram_rows": "batcher",
    "restore_training_state": "checkpoint", "save_training_state": "checkpoint",
    "DeviceStage": "device_stage",
    "TorchDataLoader": "loader", "make_torch_dataloader": "loader",
    "PACK_POSITION_KEY": "packing", "PACK_SEGMENT_KEY": "packing",
    "make_packed_torch_dataloader": "packing", "pack_ragged": "packing",
    "packed_valid_mask": "packing",
}

__all__ = sorted(_LAZY_EXPORTS)


def __getattr__(name):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
