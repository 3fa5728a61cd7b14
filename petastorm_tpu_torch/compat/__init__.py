"""Optional-dependency shims (the port's own copy of
``petastorm_tpu/compat/``): the Spark shim,
:mod:`petastorm_tpu_torch.compat.spark_shim`."""
