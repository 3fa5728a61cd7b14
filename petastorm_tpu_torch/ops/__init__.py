"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

``ops.flash_attention`` is the module (its ``LAUNCHES`` counts kernel
launches); the public function is ``ops.flash_attention.flash_attention``,
also exported as ``petastorm_tpu_torch.flash_attention``.
"""
