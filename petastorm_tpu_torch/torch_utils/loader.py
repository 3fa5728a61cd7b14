"""``TorchDataLoader``: host batches → the card, prefetched and overlapped.

Counterpart of ``petastorm_tpu/jax_utils/loader.py::JaxDataLoader`` for the
main path: a producer thread pulls host batches from a ``batch_source`` (for
example the packer of :mod:`.packing`) into a bounded queue, and the
consuming thread keeps ``device_prefetch`` batches in flight on the card.

Staging (the counterpart of ``jax.device_put``) for a CUDA device:

- the producer copies each numpy column into pinned host memory;
- the consumer issues ``non_blocking`` H2D copies on a dedicated copy
  stream and records an event there;
- before a batch is handed out, the consumer's current stream waits on that
  event, and every tensor is ``record_stream``-ed onto it, so the caching
  allocator cannot reuse a buffer while the copy or the step still reads it.

``diagnostics`` reports the per-iteration ``input_stall_pct`` (time the
consumer waited for a host batch over the iteration's wall time, both on
``time.perf_counter``), the stage breakdown and ``h2d_bytes``. Threads are
joined by :meth:`stop` and on ``__exit__``. (Row batching from a plain
reader, ``state_dict``, the decoded-batch cache, global sharding, the
on-device decode stage, autotuning and telemetry are not ported yet.)
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np
import torch

from petastorm_tpu_torch.ops.flash_attention import resolve_device

_SENTINEL = object()


class TorchDataLoader:
    """Iterable / context manager yielding ``{field: tensor}`` batches on
    ``device``."""

    def __init__(self, reader, batch_source, max_batches=None, device="cuda",
                 host_prefetch=4, device_prefetch=2):
        if batch_source is None:
            raise ValueError(
                "TorchDataLoader needs a batch_source (a zero-argument "
                "callable returning an iterator of {field: ndarray} "
                "batches); row batching from a plain reader is not ported")
        if device_prefetch < 1:
            raise ValueError("device_prefetch must be >= 1")
        self.reader = reader
        self._batch_source = batch_source
        self._max_batches = max_batches
        self._device = resolve_device(device)
        self._host_prefetch = max(1, host_prefetch)
        self._device_prefetch = device_prefetch
        self._copy_stream = None
        self._queue = None
        self._producer = None
        self._producer_error = None
        self._stop = threading.Event()
        self._reset_diagnostics()

    # -- diagnostics -------------------------------------------------------

    def _reset_diagnostics(self):
        self._stats = {"batches": 0, "decode_s": 0.0, "queue_wait_s": 0.0,
                       "stall_s": 0.0, "dispatch_s": 0.0, "consumer_s": 0.0,
                       "h2d_bytes": 0}
        self._iter_start = None
        self._iter_end = None

    @property
    def diagnostics(self):
        """This iteration's counters, read live: ``batches``, ``wall_s``,
        ``stall_s`` and ``input_stall_pct`` (the consumer's wait for host
        batches over wall time), ``producer_decode_s`` (source pull +
        packing + pinning), ``producer_queue_wait_s``, ``device_dispatch_s``
        (issuing the H2D copies), ``consumer_s`` (time the caller held each
        batch) and ``h2d_bytes``."""
        start, end = self._iter_start, self._iter_end
        wall = 0.0 if start is None else max(
            0.0, (time.perf_counter() if end is None else end) - start)
        s = self._stats
        return {
            "batches": s["batches"],
            "wall_s": wall,
            "stall_s": s["stall_s"],
            "input_stall_pct": (round(100.0 * s["stall_s"] / wall, 2)
                                if wall > 0 else 0.0),
            "max_batches": self._max_batches,
            "producer_decode_s": s["decode_s"],
            "producer_queue_wait_s": s["queue_wait_s"],
            "device_dispatch_s": s["dispatch_s"],
            "consumer_s": s["consumer_s"],
            "h2d_bytes": s["h2d_bytes"],
            "device": str(self._device),
        }

    # -- producer ----------------------------------------------------------

    def _to_host_tensors(self, batch):
        out = {}
        for name, col in batch.items():
            arr = np.asarray(col)
            if arr.dtype == object or arr.dtype.kind in ("U", "S", "M", "m"):
                raise TypeError(
                    f"Column {name!r} has non-tensor dtype {arr.dtype}; the "
                    "torch loader stages numeric columns only")
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self._device.type == "cuda":
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t)
                t = pinned
            out[name] = t
        return out

    def _produce(self):
        try:
            batches = iter(self._batch_source())
            if self._max_batches is not None:
                batches = itertools.islice(batches, self._max_batches)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                batch = next(batches, _SENTINEL)
                if batch is not _SENTINEL:
                    batch = self._to_host_tensors(batch)
                self._stats["decode_s"] += time.perf_counter() - t0
                if batch is _SENTINEL:
                    break
                t0 = time.perf_counter()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                batch = None
                self._stats["queue_wait_s"] += time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 - re-raised on the consumer side
            self._producer_error = exc
        finally:
            while True:
                try:
                    self._queue.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    # -- consumer ----------------------------------------------------------

    def _stage(self, host_batch):
        """Host tensors → ``(device batch, ready event)``; the event is None
        when there is no copy to wait for (CPU device)."""
        if self._device.type != "cuda":
            return host_batch, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self._device)
        t0 = time.perf_counter()
        with torch.cuda.stream(self._copy_stream):
            out = {name: t.to(self._device, non_blocking=True)
                   for name, t in host_batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        self._stats["dispatch_s"] += time.perf_counter() - t0
        self._stats["h2d_bytes"] += sum(t.nbytes for t in host_batch.values())
        return out, ready

    def _hand_over(self, batch, ready):
        if ready is None:
            return batch
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(ready)
        for t in batch.values():
            # The tensors were allocated on the copy stream; tell the
            # allocator the consumer stream uses them too.
            t.record_stream(consumer)
        return batch

    def __iter__(self):
        self.stop()
        self._queue = queue.Queue(maxsize=self._host_prefetch)
        self._stop.clear()
        self._producer_error = None
        self._reset_diagnostics()
        self._iter_start = time.perf_counter()
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name="torch-loader-producer")
        self._producer.start()
        return self._iterate()

    def _iterate(self):
        inflight = []
        done = False
        try:
            while True:
                while not done and len(inflight) < self._device_prefetch:
                    t0 = time.perf_counter()
                    host_batch = self._queue.get()
                    self._stats["stall_s"] += time.perf_counter() - t0
                    if host_batch is _SENTINEL:
                        done = True
                        if self._producer_error is not None:
                            raise self._producer_error
                        break
                    inflight.append(self._stage(host_batch))
                    host_batch = None
                if not inflight:
                    return
                batch = self._hand_over(*inflight.pop(0))
                self._stats["batches"] += 1
                t0 = time.perf_counter()
                yield batch
                batch = None
                self._stats["consumer_s"] += time.perf_counter() - t0
        finally:
            self._iter_end = time.perf_counter()
            self.stop()

    # -- lifecycle ---------------------------------------------------------

    def stop(self):
        """Stop the producer and join it (a stopped loader can be iterated
        again)."""
        self._stop.set()
        producer = self._producer
        if producer is not None:
            while producer.is_alive():
                try:  # unblock a producer waiting on a full queue
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                producer.join(timeout=0.1)
            self._producer = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.reader.stop()
        self.reader.join()
