"""Models that consume the port's batches.

The model-parallel families are exported here under the JAX package's
names (``petastorm_tpu/models/__init__.py``), lazily: importing one model
module loads no other.
"""

_LAZY_EXPORTS = {
    "param_partition_specs": "image_classifier",
    "shard_image_classifier": "image_classifier",
    "make_dlrm_train_step": "tabular_dlrm",
    "dlrm_partition_specs": "tabular_dlrm",
    "shard_dlrm": "tabular_dlrm",
    "init_moe_params": "moe",
    "apply_moe_model": "moe",
    "make_moe_train_step": "moe",
    "moe_param_partition_specs": "moe",
    "init_pipeline_params": "pipeline",
    "apply_pipeline_model": "pipeline",
    "make_pipeline_train_step": "pipeline",
    "pipeline_param_partition_specs": "pipeline",
    "pipeline_1f1b_loss_and_grads": "pipeline",
}

__all__ = list(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)
