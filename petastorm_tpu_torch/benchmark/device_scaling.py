"""Scaling measurement for the device decode stage.

The port's own copy of ``petastorm_tpu/benchmark/device_scaling.py``. It
answers one question with a number: does delivery + the on-card image
stage scale with the device count? The per-device batch is held FIXED
while the count grows (weak scaling: more cards, more global rows per
step). Raw uint8 batches are pre-collated in memory, so Parquet and codec
throughput are not in the loop, and each step's consumption is forced
with ``torch.cuda.synchronize``.

There is no sharded delivery in the port (no ``batch_sharding``): count
``n`` feeds one :class:`~petastorm_tpu_torch.torch_utils.DeviceStage` per
CUDA device ``cuda:0`` … ``cuda:n-1``, each through its own loader with
its per-device block of the global batch, and a step ends when every
device has consumed its block.

Two numbers per device count, because the two halves of delivery scale
differently on one host:

- ``rows_per_sec``: end to end, the loaders' pinned H2D copies + the
  stage + a consuming step. The copies are issued by one host process, so
  this number's scaling is bounded by host copy bandwidth.
- ``decode_kernel_rows_per_sec``: the device-parallel portion alone: the
  stage over raw batches already on their devices.

``device="cpu"`` runs count 1 on the CPU (the tests' size).
"""

from __future__ import annotations

import os
import time

import numpy as np


def _devices(device):
    """The devices a sweep may use: every CUDA device for ``"cuda"`` (the
    default; raises without a card), the one CPU for ``"cpu"``."""
    import torch

    from petastorm_tpu_torch.ops.flash_attention import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _synchronize(devices):
    import torch

    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def measure_device_stage_scaling(device_counts=(1, 8), per_device_batch=64,
                                 steps=24, image_shape=(64, 64, 3),
                                 repeats=2, seed=0, device="cuda"):
    """Aggregate rows/s of per-device delivery + the stage per device count.

    :param device: ``"cuda"`` sweeps ``cuda:0`` … ``cuda:n-1``; ``"cpu"``
        has one device.
    :return: dict with per-count ``rows_per_sec``, the end-to-end
        ``scaling`` ratio (largest vs smallest count), and environment
        facts (``host_cores``, ``device_platform``).
    """
    import torch

    from petastorm_tpu_torch.torch_utils import DeviceStage, TorchDataLoader

    devices = _devices(device)
    counts = sorted(set(int(n) for n in device_counts))
    if counts[-1] > len(devices):
        raise RuntimeError(
            f"scaling sweep needs {counts[-1]} devices, have {len(devices)}")
    rng = np.random.RandomState(seed)
    results, kernel_results = {}, {}
    for n in counts:
        used = devices[:n]
        global_batch = per_device_batch * n
        # One raw batch reused every step: the measured loop pays the full
        # per-step delivery + on-device stage cost; synthesis does not.
        images = rng.randint(0, 255, (global_batch,) + tuple(image_shape),
                             dtype=np.uint8)
        labels = (np.arange(global_batch) % 10).astype(np.int32)
        blocks = [{"image": images[d * per_device_batch:(d + 1) * per_device_batch],
                   "label": labels[d * per_device_batch:(d + 1) * per_device_batch]}
                  for d in range(n)]
        # One stage per device, kept across passes, as the JAX sweep keeps
        # one stage per count.
        stages = [DeviceStage(normalize=(127.5, 127.5), seed=seed) for _ in used]

        def one_pass():
            loaders = [TorchDataLoader(None, (lambda b=block: iter([b] * steps)),
                                       max_batches=steps, device=dev,
                                       device_stage=stage,
                                       non_tensor_policy="drop")
                       for block, dev, stage in zip(blocks, used, stages)]
            rows = 0
            t0 = time.perf_counter()
            try:
                for step_batches in zip(*loaders):
                    # Force the stage and the step on every device:
                    # dispatch-only timing would flatter n.
                    for batch in step_batches:
                        batch["image"].sum()
                    _synchronize(used)
                    rows += global_batch
            finally:
                for loader in loaders:
                    loader.stop()
            return rows / (time.perf_counter() - t0)

        one_pass()  # warm: allocator, pinned buffers, the copy streams
        results[n] = max(one_pass() for _ in range(max(1, repeats)))

        # Device-parallel portion alone: the stage over raw batches already
        # on their devices (a few distinct batches cycled, so no step reuses
        # the previous step's inputs).
        kstages = [DeviceStage(normalize=(127.5, 127.5), seed=seed) for _ in used]
        prestaged = [[torch.from_numpy(rng.randint(
            0, 255, (per_device_batch,) + tuple(image_shape),
            dtype=np.uint8)).to(dev) for _ in range(4)] for dev in used]

        def kernel_pass():
            outs = []
            t0 = time.perf_counter()
            for s in range(steps):
                for d, stage in enumerate(kstages):
                    outs.append(stage.apply(
                        {"image": prestaged[d][s % len(prestaged[d])]}, s))
            _synchronize(used)
            return steps * global_batch / (time.perf_counter() - t0)

        kernel_pass()  # warm
        kernel_results[n] = max(kernel_pass()
                                for _ in range(max(1, repeats)))
    lo, hi = counts[0], counts[-1]
    return {
        "metric": "device_stage_scaling_rows_per_sec",
        "per_device_batch": per_device_batch,
        "steps": steps,
        "image_shape": list(image_shape),
        "device_counts": counts,
        "rows_per_sec": {str(n): round(results[n], 1) for n in counts},
        "scaling": round(results[hi] / results[lo], 2),
        "decode_kernel_rows_per_sec": {str(n): round(kernel_results[n], 1)
                                       for n in counts},
        "decode_kernel_scaling": round(kernel_results[hi]
                                       / kernel_results[lo], 2),
        "scaling_devices": f"{lo}->{hi}",
        "host_cores": os.cpu_count(),
        "device_platform": devices[0].type,
        "note": "rows_per_sec includes the one host's serial pinned H2D "
                "copies of every device's block; decode_kernel_* is the "
                "device-parallel stage itself",
    }
