"""petastorm_tpu_torch — the PyTorch / CUDA counterpart of petastorm_tpu.

The same Parquet input path (Unischema + codecs, metadata, a columnar
reader over worker pools, sequence packing) delivering batches to PyTorch
on an NVIDIA GPU, and the long-context decoder LM that consumes them, whose
attention runs on hand-written CUDA flash-attention kernels (forward, dQ,
dK/dV) for Hopper. The package imports nothing of ``petastorm_tpu`` and no
JAX: it keeps its own copies of what it needs.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``, where the kernels' plain PyTorch versions run);
without a card a CUDA request raises. Exports are lazy.
"""

__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "make_columnar_reader": ("petastorm_tpu_torch.reader.reader",
                             "make_columnar_reader"),
    "Reader": ("petastorm_tpu_torch.reader.reader", "Reader"),
    "NoDataAvailableError": ("petastorm_tpu_torch.errors",
                             "NoDataAvailableError"),
    "Unischema": ("petastorm_tpu_torch.schema.unischema", "Unischema"),
    "UnischemaField": ("petastorm_tpu_torch.schema.unischema",
                       "UnischemaField"),
    "materialize_rows": ("petastorm_tpu_torch.etl.metadata",
                         "materialize_rows"),
    "TorchDataLoader": ("petastorm_tpu_torch.torch_utils.loader",
                        "TorchDataLoader"),
    "make_packed_torch_dataloader": ("petastorm_tpu_torch.torch_utils.packing",
                                     "make_packed_torch_dataloader"),
    "flash_attention": ("petastorm_tpu_torch.ops.flash_attention",
                        "flash_attention"),
    "train_lm": ("petastorm_tpu_torch.models.long_context_lm", "train_lm"),
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
