"""Reader throughput benchmark and named scenarios (library + CLI).

The port's own copy of ``petastorm_tpu/benchmark/`` (reference parity:
``petastorm/benchmark/``: ``throughput.py``, ``cli.py``; console script
``petastorm-throughput.py``). Run as ``python -m
petastorm_tpu_torch.benchmark <dataset_url>``, or ``python -m
petastorm_tpu_torch.benchmark scenario <name>`` for a named workload.
"""

from petastorm_tpu_torch.benchmark.throughput import BenchmarkResult, reader_throughput

__all__ = ["reader_throughput", "BenchmarkResult"]
