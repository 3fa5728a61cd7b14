"""petastorm_tpu_torch — the PyTorch / CUDA counterpart of petastorm_tpu.

The same Parquet input path (Unischema + codecs, metadata, row and
columnar readers over worker pools, row batching, sequence packing)
delivering batches to PyTorch on an NVIDIA GPU, with the on-card image stage
(crop / flip / cast / normalize of staged uint8 bytes), NGram windows, and
three consumers: a CNN image classifier, the sequence encoder family, and
the long-context decoder LM, whose attention runs on hand-written CUDA
flash-attention kernels (forward, dQ, dK/dV) for Hopper, on one process or
sequence-parallel (ring or Ulysses attention over ``torch.distributed``).
The package imports nothing of ``petastorm_tpu`` and no JAX: it keeps its
own copies of what it needs.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``, where the kernels' plain PyTorch versions run);
without a card a CUDA request raises. Exports are lazy.
"""

__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "make_reader": ("petastorm_tpu_torch.reader.reader", "make_reader"),
    "make_columnar_reader": ("petastorm_tpu_torch.reader.reader",
                             "make_columnar_reader"),
    "Reader": ("petastorm_tpu_torch.reader.reader", "Reader"),
    "NoDataAvailableError": ("petastorm_tpu_torch.errors",
                             "NoDataAvailableError"),
    "Unischema": ("petastorm_tpu_torch.schema.unischema", "Unischema"),
    "UnischemaField": ("petastorm_tpu_torch.schema.unischema",
                       "UnischemaField"),
    "TransformSpec": ("petastorm_tpu_torch.schema.transform", "TransformSpec"),
    "CompressedImageCodec": ("petastorm_tpu_torch.schema.codecs",
                             "CompressedImageCodec"),
    "CompressedNdarrayCodec": ("petastorm_tpu_torch.schema.codecs",
                               "CompressedNdarrayCodec"),
    "materialize_rows": ("petastorm_tpu_torch.etl.metadata",
                         "materialize_rows"),
    "TorchDataLoader": ("petastorm_tpu_torch.torch_utils.loader",
                        "TorchDataLoader"),
    "make_torch_dataloader": ("petastorm_tpu_torch.torch_utils.loader",
                              "make_torch_dataloader"),
    "DeviceStage": ("petastorm_tpu_torch.torch_utils.device_stage", "DeviceStage"),
    "make_packed_torch_dataloader": ("petastorm_tpu_torch.torch_utils.packing",
                                     "make_packed_torch_dataloader"),
    "flash_attention": ("petastorm_tpu_torch.ops.flash_attention",
                        "flash_attention"),
    "flash_attention_with_lse": ("petastorm_tpu_torch.ops.flash_attention",
                                 "flash_attention_with_lse"),
    "NGram": ("petastorm_tpu_torch.ngram", "NGram"),
    "ring_attention": ("petastorm_tpu_torch.models.sequence_model",
                       "ring_attention"),
    "ulysses_attention": ("petastorm_tpu_torch.models.sequence_model",
                          "ulysses_attention"),
    "train_lm": ("petastorm_tpu_torch.models.long_context_lm", "train_lm"),
    "train_image_classifier": ("petastorm_tpu_torch.models.image_classifier",
                               "train_image_classifier"),
    "train_sequence": ("petastorm_tpu_torch.models.sequence_training",
                       "train_sequence"),
}

__all__ = list(_LAZY_EXPORTS) + ["__version__"]


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)
