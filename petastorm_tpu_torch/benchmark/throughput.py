"""Measure Reader rows/sec (and input-stall %) under pool/worker configs.

The port's own copy of ``petastorm_tpu/benchmark/throughput.py``
(reference parity: ``petastorm/benchmark/throughput.py::reader_throughput``
→ ``BenchmarkResult``). The loader mode runs through
:func:`~petastorm_tpu_torch.torch_utils.make_torch_dataloader`, which
stages each batch onto ``device`` and reports the input-stall % beside
rows/sec. The raw reader path touches no device.
"""

from __future__ import annotations

import time
from collections import namedtuple

BenchmarkResult = namedtuple(
    "BenchmarkResult",
    ["rows_per_second", "rows_count", "duration_s", "input_stall_pct"])

#: The JAX package's spellings of the loader mode, with the port's.
_JAX_SPELLINGS = {"apply_jax_loader": "apply_torch_loader",
                  "jax_batch_size": "torch_batch_size"}


def reader_throughput(dataset_url, field_regex=None,
                      warmup_cycles_count=200, measure_cycles_count=1000,
                      pool_type="thread", loaders_count=3,
                      read_method="python",
                      shuffle_row_groups=True,
                      apply_torch_loader=False, torch_batch_size=128,
                      device="cuda", **reader_kwargs):
    """Read ``warmup_cycles_count`` rows off the clock, then time
    ``measure_cycles_count`` rows.

    :param field_regex: list of field-name regexes to read (None = all).
    :param pool_type: 'thread' | 'process' | 'dummy'.
    :param loaders_count: workers_count for the pool.
    :param read_method: 'python' (make_reader) or 'arrow' (make_batch_reader —
        cycles then count record batches, as upstream).
    :param apply_torch_loader: measure through ``make_torch_dataloader``
        (cycles count batches of ``torch_batch_size`` staged onto
        ``device``); reports stall %.
    :param device: the loader's device, ``"cuda"`` (the default; raises
        without a card) or ``"cpu"``. Unused by the raw reader path.
    """
    for jax_name, torch_name in _JAX_SPELLINGS.items():
        if jax_name in reader_kwargs:
            raise NotImplementedError(
                f"{jax_name} is the JAX package's spelling; the port's is "
                f"{torch_name}")
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader

    factory = {"python": make_reader, "arrow": make_batch_reader}.get(read_method)
    if factory is None:
        raise ValueError(f"Unknown read_method {read_method!r}")
    if apply_torch_loader:
        from petastorm_tpu_torch.ops.flash_attention import resolve_device

        device = resolve_device(device)  # before any reader thread starts
    reader = factory(dataset_url,
                     schema_fields=field_regex,
                     reader_pool_type=pool_type,
                     workers_count=loaders_count,
                     shuffle_row_groups=shuffle_row_groups,
                     num_epochs=None,
                     **reader_kwargs)
    try:
        if apply_torch_loader:
            return _loader_throughput(reader, warmup_cycles_count,
                                      measure_cycles_count, torch_batch_size,
                                      device)
        return _raw_throughput(reader, warmup_cycles_count,
                               measure_cycles_count)
    finally:
        reader.stop()
        reader.join()


def _raw_throughput(reader, warmup, measure):
    it = iter(reader)
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(measure):
        next(it)
    duration = time.perf_counter() - t0
    return BenchmarkResult(rows_per_second=measure / duration,
                           rows_count=measure, duration_s=duration,
                           input_stall_pct=None)


def _loader_throughput(reader, warmup, measure, batch_size, device):
    import torch

    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    loader = make_torch_dataloader(reader, batch_size,
                                   non_tensor_policy="drop",
                                   max_batches=warmup + measure,
                                   device=device)
    it = iter(loader)
    for _ in range(warmup):
        next(it)
    rows = 0
    t0 = time.perf_counter()
    for _ in range(measure):
        batch = next(it)
        rows += next(v.shape[0] for v in batch.values() if hasattr(v, "shape"))
    if device.type == "cuda":
        # The copies are queued on the loader's stream: the window ends
        # when the last batch is on the card, not when it was queued.
        torch.cuda.synchronize(device)
    duration = time.perf_counter() - t0
    # The generator is suspended at its last yield; wall_s/input_stall_pct are
    # only final once its finally block ran, so close it before reading them.
    it.close()
    loader.stop()
    return BenchmarkResult(rows_per_second=rows / duration, rows_count=rows,
                           duration_s=duration,
                           input_stall_pct=loader.diagnostics["input_stall_pct"])
