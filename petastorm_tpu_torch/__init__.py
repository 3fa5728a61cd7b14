"""petastorm_tpu_torch — the PyTorch / CUDA counterpart of petastorm_tpu.

The same Parquet input path (Unischema + codecs, metadata, row and
columnar readers and the plain-Parquet batch reader, with Parquet-stats
``filters``, row predicates, row-group indexes and selectors, row-drop
partitions and the local-disk cache, over worker pools; row batching,
sequence packing) delivering batches to PyTorch on an NVIDIA GPU, through
the classic petastorm loaders (``petastorm_tpu_torch.pytorch``) or the
port's own (with the decoded-batch cache in front of the reader, its
memory and disk tiers replaying each later epoch in a seeded order;
producer-side staging; a per-batch Chrome trace), with resumable input (reader and
loader ``state_dict()`` / ``resume_state=``), joint model + input
checkpoints, equal-step sharded delivery over ``torch.distributed``, the
on-card image stage (crop / flip / cast / normalize of staged uint8 bytes),
NGram windows, and four consumers: a CNN image classifier, a DLRM tabular
recommender (data parallel), the sequence encoder family, and the
long-context decoder LM, whose attention runs on hand-written CUDA
flash-attention kernels (forward, dQ, dK/dV) for Hopper, on one process or
sequence-parallel (ring or Ulysses attention over ``torch.distributed``).
The package imports nothing of ``petastorm_tpu`` and no JAX: it keeps its
own copies of what it needs.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU (``device="cpu"``, where the kernels' plain PyTorch versions run);
without a card a CUDA request raises. Exports are lazy; the modules
``pytorch``, ``predicates`` and ``selectors`` are exported as modules.
"""

__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "make_reader": ("petastorm_tpu_torch.reader.reader", "make_reader"),
    "make_columnar_reader": ("petastorm_tpu_torch.reader.reader",
                             "make_columnar_reader"),
    "make_batch_reader": ("petastorm_tpu_torch.reader.reader", "make_batch_reader"),
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
    "train_dlrm": ("petastorm_tpu_torch.models.tabular_dlrm", "train_dlrm"),
    "WeightedSamplingReader": ("petastorm_tpu_torch.weighted_sampling_reader",
                               "WeightedSamplingReader"),
    "build_rowgroup_index": ("petastorm_tpu_torch.etl.rowgroup_indexing",
                             "build_rowgroup_index"),
    "pytorch": ("petastorm_tpu_torch.pytorch", None),
    "predicates": ("petastorm_tpu_torch.predicates", None),
    "selectors": ("petastorm_tpu_torch.selectors", None),
    "save_training_state": ("petastorm_tpu_torch.torch_utils.checkpoint",
                            "save_training_state"),
    "restore_training_state": ("petastorm_tpu_torch.torch_utils.checkpoint",
                               "restore_training_state"),
    "BatchCache": ("petastorm_tpu_torch.cache_impl.batch_cache", "BatchCache"),
    "CacheConfig": ("petastorm_tpu_torch.cache_impl.batch_cache", "CacheConfig"),
}

__all__ = list(_LAZY_EXPORTS) + ["__version__"]


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(module_name)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)
