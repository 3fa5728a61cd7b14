"""The benchmark of ``petastorm_tpu_torch`` on an NVIDIA H100.

``python -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
and prints one JSON line (:mod:`perfbench.runner`). ``python -m
perfbench.calibrate`` reads the numbers the correctness limits are set
from. Nothing here imports JAX or the JAX package.
"""
