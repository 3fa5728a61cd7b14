"""``make_torch_dataloader`` / ``TorchDataLoader``: reader batches → the card,
prefetched and overlapped.

Counterpart of ``petastorm_tpu/jax_utils/loader.py`` (``make_jax_dataloader``
and ``JaxDataLoader``) on one device: a producer thread pulls host batches
from a ``batch_source`` — a reader's fixed-size row batches
(:func:`make_torch_dataloader` over :mod:`.batcher`: last-batch policy, a
seeded shuffle buffer) or the packer of :mod:`.packing` — into a bounded
queue, and the consuming thread keeps ``device_prefetch`` batches in flight
on the card.

Staging (the counterpart of ``jax.device_put``) for a CUDA device:

- the producer copies each numeric column into pinned host memory; columns
  of strings, Decimals or ragged rows follow ``non_tensor_policy`` (kept on
  the host as numpy, dropped, or an error);
- the consumer issues ``non_blocking`` H2D copies on a dedicated copy
  stream; with a :class:`~.device_stage.DeviceStage` the image fields are
  staged as raw uint8 bytes and the stage's crop / flip / cast / normalize
  run on that stream too, after which the raw tensors are dropped at once;
- an event recorded on the copy stream after all of that is what the
  consumer's stream waits on before a batch is handed out, and every tensor
  is ``record_stream``-ed onto it, so the caching allocator cannot reuse a
  buffer while the copy or the step still reads it.

``diagnostics`` reports the keys of the JAX loader's unsharded path. Threads
are joined by :meth:`stop` and on ``__exit__``.

:meth:`TorchDataLoader.state_dict` checkpoints the input at what the loader
has *yielded*: the reader's state rolled back past the rows still buffered
in the batcher, the host queue and the device prefetch, so they are re-read
on resume. Under a ``torch.distributed`` group, :func:`make_torch_dataloader`
derives the equal-step ``max_batches`` from the reader's shard metadata, as
the JAX loader does under a sharding. (The decoded-batch cache, global
arrays, autotuning and telemetry are not ported yet; in the data-parallel
layout each rank keeps its own local batch on its own card.)
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time

import numpy as np
import torch

from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY, batch_iterator

_SENTINEL = object()


def make_torch_dataloader(reader, batch_size, last_batch="drop", max_batches=None,
                          device="cuda", host_prefetch=4, device_prefetch=2,
                          non_tensor_policy="host", shuffle_buffer_size=0,
                          shuffle_seed=None, device_stage=None, group=None):
    """A :class:`TorchDataLoader` over ``reader``'s rows (``make_reader``)
    or column batches (``make_columnar_reader``, ``make_batch_reader``).

    :param batch_size: rows per batch.
    :param last_batch: ``"drop"`` | ``"pad"`` | ``"keep"``; ``"pad"`` adds a
        boolean ``__pad_mask__`` column (True = real row).
    :param max_batches: stop after this many batches.
    :param device: ``"cuda"`` (the default) or ``"cpu"``.
    :param host_prefetch: depth of the host-batch queue.
    :param device_prefetch: batches kept in flight on the device (>= 1).
    :param non_tensor_policy: ``"host"`` | ``"drop"`` | ``"error"`` for
        object, string and datetime columns.
    :param shuffle_buffer_size: > 0 shuffles rows through a
        ``RandomShufflingBuffer`` seeded by ``shuffle_seed`` (row readers).
    :param device_stage: a :class:`~.device_stage.DeviceStage` or None.
    :param group: a ``torch.distributed`` group whose ranks train in
        lockstep on their shards; with ``max_batches=None`` every rank stops
        after the smallest shard's batch count
        (:func:`~.sharding.derive_equal_step_max_batches`, no collective).
    """
    if group is not None and max_batches is None:
        from petastorm_tpu_torch.torch_utils.sharding import derive_equal_step_max_batches

        max_batches = derive_equal_step_max_batches(reader, batch_size, last_batch)
    return TorchDataLoader(
        reader, ReaderBatchSource(reader, batch_size, last_batch, shuffle_buffer_size,
                                  shuffle_seed),
        max_batches=max_batches, device=device, host_prefetch=host_prefetch,
        device_prefetch=device_prefetch, non_tensor_policy=non_tensor_policy,
        device_stage=device_stage)


class ReaderBatchSource:
    """A reader's rows as fixed-size batches (:func:`batch_iterator`), the
    ``batch_source`` of :func:`make_torch_dataloader`. The rows it batches
    are those the reader delivered, in order, so the loader can checkpoint
    by rolling the reader's state back to the rows it yielded."""

    def __init__(self, reader, batch_size, last_batch, shuffle_buffer_size, shuffle_seed):
        self.reader = reader
        self.shuffle_buffer_size = shuffle_buffer_size
        self._kwargs = dict(batch_size=batch_size, last_batch=last_batch,
                            shuffle_buffer_size=shuffle_buffer_size,
                            shuffle_seed=shuffle_seed)

    def __call__(self):
        return batch_iterator(self.reader, **self._kwargs)


class TorchDataLoader:
    """Iterable / context manager yielding ``{field: tensor}`` batches on
    ``device`` (host-side columns stay numpy arrays). Batches come from
    ``batch_source``, a zero-argument callable returning an iterator of
    ``{field: ndarray}`` batches (row batches of ``reader`` for
    :func:`make_torch_dataloader`, packed batches for the packing loader);
    ``reader`` is stopped and joined on ``__exit__``."""

    def __init__(self, reader, batch_source, max_batches=None, device="cuda",
                 host_prefetch=4, device_prefetch=2, non_tensor_policy="host",
                 device_stage=None):
        self._device = resolve_device(device)
        if non_tensor_policy not in ("host", "drop", "error"):
            raise ValueError("non_tensor_policy must be host|drop|error")
        if device_prefetch < 1:
            raise ValueError("device_prefetch must be >= 1")
        self.reader = reader
        self._batch_source = batch_source
        self._max_batches = max_batches
        self._non_tensor_policy = non_tensor_policy
        self._device_stage = device_stage
        self._host_prefetch = max(1, host_prefetch)
        self._device_prefetch = device_prefetch
        # Production ordinal of the next staged raw batch, the device
        # stage's draw seed: monotonic across iterations, so epoch 2 draws
        # afresh and the draws do not depend on the prefetch depth.
        self._stage_step = 0
        self._copy_stream = None
        self._queue = None
        self._producer = None
        self._producer_error = None
        self._stop = threading.Event()
        self._rows_yielded = 0  # real rows handed out, over all iterations
        self._reset_diagnostics()

    # -- diagnostics -------------------------------------------------------

    def _reset_diagnostics(self):
        self._stats = {"batches": 0, "rows": 0, "decode_s": 0.0, "queue_wait_s": 0.0,
                       "stall_s": 0.0, "device_put_s": 0.0, "raw_stage_s": 0.0,
                       "device_decode_s": 0.0, "consumer_s": 0.0, "h2d_bytes": 0}
        self._iter_start = None
        self._iter_end = None

    @property
    def diagnostics(self):
        """This iteration's counters, read live, under the JAX loader's key
        names: ``batches``, ``rows``, ``wall_s``, ``stall_s`` and
        ``input_stall_pct`` (the consumer's wait for host batches over wall
        time), ``producer_decode_s`` (reader pull + collation + pinning),
        ``producer_queue_wait_s``, ``device_dispatch_s`` (issuing the H2D
        copies and the device stage: the sum of plain-tensor copies,
        ``raw_stage_s`` and ``device_decode_s``), ``shard_put_s`` (0.0: no
        sharded delivery here), ``dispatch_overlap_pct`` (the share of
        dispatch hidden inside decode or the consumer's step rather than
        extending the wall), ``consumer_s`` (time the caller held each
        batch) and ``h2d_bytes`` (bytes copied to a CUDA device)."""
        start, end = self._iter_start, self._iter_end
        wall = 0.0 if start is None else max(
            0.0, (time.perf_counter() if end is None else end) - start)
        s = self._stats
        dispatch = s["device_put_s"] + s["raw_stage_s"] + s["device_decode_s"]
        overlap_pct = (round(100.0 * max(0.0, min(1.0, (
            s["decode_s"] + s["consumer_s"] + dispatch - wall) / dispatch)), 2)
            if dispatch > 0 else 100.0)
        return {
            "batches": s["batches"],
            "rows": s["rows"],
            "stall_s": s["stall_s"],
            "wall_s": wall,
            "input_stall_pct": (round(100.0 * s["stall_s"] / wall, 2)
                                if wall > 0 else 0.0),
            "max_batches": self._max_batches,
            "producer_decode_s": s["decode_s"],
            "producer_queue_wait_s": s["queue_wait_s"],
            "device_dispatch_s": dispatch,
            "raw_stage_s": s["raw_stage_s"],
            "device_decode_s": s["device_decode_s"],
            "shard_put_s": 0.0,
            "dispatch_overlap_pct": overlap_pct,
            "h2d_bytes": s["h2d_bytes"],
            "consumer_s": s["consumer_s"],
        }

    # -- producer ----------------------------------------------------------

    def _host_tensor(self, arr):
        """A host column as a tensor: copied into pinned memory for a CUDA
        device; for the CPU, shared, or copied when it is read-only (Arrow
        buffers of the batch reader), which torch cannot share."""
        arr = np.ascontiguousarray(arr)
        if self._device.type == "cuda":
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            pinned.numpy()[...] = arr
            return pinned
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

    def _to_host(self, batch):
        """A collated batch → ``(columns, raw image fields)``: numeric
        columns as (pinned) tensors, non-tensor columns as numpy or dropped
        by ``non_tensor_policy``, the device stage's fields apart."""
        raw = {}
        if self._device_stage is not None:
            raw, batch = self._device_stage.split(batch)
        out = {}
        for name, col in batch.items():
            arr = np.asarray(col)
            if arr.dtype == object or arr.dtype.kind in ("U", "S", "M", "m"):
                if self._non_tensor_policy == "error":
                    raise TypeError(
                        f"Column {name!r} has non-tensor dtype {arr.dtype}; set "
                        "non_tensor_policy='host' or 'drop', select numeric "
                        "schema_fields, or add a TransformSpec")
                if self._non_tensor_policy == "host":
                    out[name] = arr
                continue
            out[name] = self._host_tensor(arr)
        return out, {name: self._host_tensor(arr) for name, arr in raw.items()}

    def _produce(self):
        try:
            batches = iter(self._batch_source())
            if self._max_batches is not None:
                batches = itertools.islice(batches, self._max_batches)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                batch = next(batches, _SENTINEL)
                if batch is not _SENTINEL:
                    batch = self._to_host(batch)
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
        """``(columns, raw)`` host tensors → ``(device batch, ready event)``;
        the event is None when there is no copy to wait for (CPU device).
        The raw image fields go through the device stage, timed apart as
        ``raw_stage_s`` (their copy) and ``device_decode_s`` (its ops)."""
        columns, raw = host_batch
        cuda = self._device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self._device)
        s = self._stats
        with torch.cuda.stream(self._copy_stream) if cuda else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = {name: t.to(self._device, non_blocking=True) if torch.is_tensor(t) else t
                   for name, t in columns.items()}
            s["device_put_s"] += time.perf_counter() - t0
            if cuda:
                s["h2d_bytes"] += sum(t.nbytes for t in columns.values() if torch.is_tensor(t))
            if raw:
                step, self._stage_step = self._stage_step, self._stage_step + 1
                t0 = time.perf_counter()
                raw_dev = {name: t.to(self._device, non_blocking=True)
                           for name, t in raw.items()}
                s["raw_stage_s"] += time.perf_counter() - t0
                if cuda:
                    raw_bytes = sum(t.nbytes for t in raw.values())
                    s["h2d_bytes"] += raw_bytes
                    self._device_stage.h2d_bytes += raw_bytes
                t0 = time.perf_counter()
                out.update(self._device_stage.apply(raw_dev, step))
                raw_dev = None  # the outputs exist: drop the raw bytes now
                s["device_decode_s"] += time.perf_counter() - t0
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return out, ready

    def _hand_over(self, batch, ready):
        if ready is None:
            return batch
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(ready)
        for t in batch.values():
            if torch.is_tensor(t):
                # Allocated on the copy stream: tell the allocator the
                # consumer's stream uses it too.
                t.record_stream(consumer)
        return batch

    @staticmethod
    def _batch_rows(batch):
        for name, col in batch.items():
            if name != PAD_MASK_KEY:
                return int(col.shape[0])
        return 0

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
                rows = self._batch_rows(batch)
                self._stats["batches"] += 1
                self._stats["rows"] += rows
                mask = batch.get(PAD_MASK_KEY)
                # Resume accounting counts real rows only (a padded final
                # batch's mask is read once, at the end of a stream).
                self._rows_yielded += rows if mask is None else int(mask.sum())
                t0 = time.perf_counter()
                yield batch
                batch = None
                self._stats["consumer_s"] += time.perf_counter() - t0
        finally:
            self._iter_end = time.perf_counter()
            self.stop()

    # -- checkpoint ----------------------------------------------------------

    def state_dict(self):
        """The input pipeline's checkpoint at what this loader has yielded:
        the reader's ``state_dict(yielded_rows=...)``, so rows pulled into
        the batcher, the host queue or the device prefetch but not yet
        yielded are re-read on resume (at-least-once). Call it between
        steps from the training thread; pass the result as
        ``resume_state=`` to the reader factory feeding a fresh loader.

        Refused with a custom ``batch_source`` (the packed loader: repacked
        batches cannot be attributed to deliveries) and with a shuffle
        buffer (it reorders rows, so buffered rows are not the newest
        deliveries).
        """
        source = self._batch_source
        if not isinstance(source, ReaderBatchSource):
            raise ValueError(
                "state_dict is not supported with a custom batch_source "
                "(e.g. the packed loader): yielded-row accounting cannot "
                "attribute repacked batches to reader deliveries. Checkpoint "
                "at an epoch boundary with the reader's state_dict()")
        if source.shuffle_buffer_size:
            raise ValueError(
                "state_dict is not supported with shuffle_buffer_size > 0: "
                "the shuffle buffer reorders rows, so buffered rows cannot "
                "be attributed to recent deliveries. Shuffle with "
                "shuffle_row_groups/shard_seed instead, or checkpoint at "
                "an epoch boundary with the reader's state_dict()")
        if not hasattr(self.reader, "state_dict"):
            raise TypeError("state_dict requires a petastorm_tpu_torch Reader "
                            f"(got {type(self.reader).__name__})")
        return self.reader.state_dict(yielded_rows=self._rows_yielded)

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
