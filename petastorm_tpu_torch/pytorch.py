"""The classic petastorm PyTorch loaders: a reader → batches of torch
tensors on a device (the port's own copy of ``petastorm_tpu/pytorch.py``).

- :class:`DataLoader` (``make_reader`` rows): an optional row shuffling
  buffer, then ``collate_fn`` over ``batch_size`` rows;
- :class:`BatchedDataLoader` (``make_batch_reader`` column batches): a
  vectorized shuffling buffer whose store lives on the device;
- :class:`InMemBatchedDataLoader`: every row read once into tensors on the
  device, then ``num_epochs`` of shuffled batches without re-reading.

Each loader takes ``device="cuda"`` by default and raises without a card;
``device="cpu"`` runs on the host. Torch has no uint16/uint32/uint64, so
those promote to int32/int64/int64; Decimals collate to lists of strings.
Every random draw comes from the JAX package's generators with the JAX
package's seeds (``random.Random`` for the row buffer, CPU
``torch.Generator`` s for the batch buffer and the in-memory permutation),
so on ``device="cpu"`` each loader yields the JAX package's tensors in the
JAX package's order, and on the card the same rows in the same order.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import torch

from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.reader_impl.pytorch_shuffling_buffer import (
    BatchedNoopShufflingBuffer,
    BatchedRandomShufflingBuffer,
)
from petastorm_tpu_torch.reader_impl.shuffling_buffer import RandomShufflingBuffer

_UNSIGNED_PROMOTIONS = {"uint16": np.int32, "uint32": np.int64, "uint64": np.int64}


def _sanitize_pytorch_types(row_as_dict):
    """In place: promote the dtypes torch lacks; strings and Decimals stay."""
    for name, value in row_as_dict.items():
        if isinstance(value, (np.ndarray, np.generic)):
            promoted = _UNSIGNED_PROMOTIONS.get(value.dtype.name)
            if promoted is not None:
                row_as_dict[name] = (value.astype(promoted) if isinstance(value, np.ndarray)
                                     else promoted(value))
    return row_as_dict


def decimal_friendly_collate(batch):
    """torch's ``default_collate``, except that ``Decimal`` values collate
    to a list of strings and strings/bytes to a list."""
    from torch.utils.data._utils.collate import default_collate

    first = batch[0]
    if isinstance(first, Decimal):
        return [str(value) for value in batch]
    if isinstance(first, (str, bytes)):
        return list(batch)
    if isinstance(first, dict):
        return {key: decimal_friendly_collate([row[key] for row in batch]) for key in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):  # a namedtuple
        return type(first)(*(decimal_friendly_collate(col) for col in zip(*batch)))
    if isinstance(first, (list, tuple)):
        return [decimal_friendly_collate(col) for col in zip(*batch)]
    if first is None:
        raise TypeError("Cannot collate None values; filter nullable fields or use a "
                        "TransformSpec to fill them")
    return default_collate(batch)


def _to_device(obj, device):
    """``obj`` with every tensor in it (in dicts, lists, namedtuples) on
    ``device``; anything else as it is."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _column_tensor(name, column):
    """A reader's numpy column → a CPU tensor (unsigned types promoted);
    columns torch cannot hold raise."""
    arr = np.asarray(column)
    promoted = _UNSIGNED_PROMOTIONS.get(arr.dtype.name)
    if promoted is not None:
        arr = arr.astype(promoted)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        raise TypeError(f"Column {name!r} (dtype {arr.dtype}) cannot become a torch tensor; "
                        "select numeric schema_fields or drop it with a TransformSpec")
    if not arr.flags.writeable:
        arr = arr.copy()  # Arrow-backed buffers are read-only
    return torch.as_tensor(arr)


class _LoaderBase:
    """The iterator/context-manager shell of the three loaders."""

    def __init__(self, reader, device):
        self.reader = reader
        self.device = resolve_device(device)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

    def stop(self):
        self.reader.stop()
        self.reader.join()

    def __iter__(self):
        raise NotImplementedError


class DataLoader(_LoaderBase):
    """Row loader for ``make_reader``: rows → an optional shuffling buffer
    (``shuffling_queue_capacity`` rows, seeded by ``shuffling_queue_seed``)
    → ``collate_fn`` over ``batch_size`` rows → tensors on ``device``.
    Iterating yields what ``collate_fn`` makes (dicts of tensors by
    default)."""

    def __init__(self, reader, batch_size=1, collate_fn=decimal_friendly_collate,
                 shuffling_queue_capacity=0, shuffling_queue_seed=None, device="cuda"):
        super().__init__(reader, device)
        if getattr(reader, "batched_output", False):
            raise ValueError("DataLoader expects a row reader (make_reader); use "
                             "BatchedDataLoader with make_batch_reader")
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._shuffling_queue_seed = shuffling_queue_seed

    def _row_source(self):
        if not self.shuffling_queue_capacity:
            yield from self.reader
            return
        sbuf = RandomShufflingBuffer(
            self.shuffling_queue_capacity,
            min_after_retrieve=self.shuffling_queue_capacity // 2,
            extra_capacity=max(self.shuffling_queue_capacity, 1000),
            random_seed=self._shuffling_queue_seed)
        for row in self.reader:
            sbuf.add_many([row])
            while not sbuf.can_add() and sbuf.can_retrieve():
                yield sbuf.retrieve()
        sbuf.finish()
        while sbuf.can_retrieve():
            yield sbuf.retrieve()

    def __iter__(self):
        batch = []
        for row in self._row_source():
            batch.append(_sanitize_pytorch_types(row._asdict()))
            if len(batch) == self.batch_size:
                yield _to_device(self.collate_fn(batch), self.device)
                batch = []
        if batch:
            yield _to_device(self.collate_fn(batch), self.device)


class BatchedDataLoader(_LoaderBase):
    """Column-batch loader for ``make_batch_reader``: column batches →
    a shuffling buffer on ``device`` → dicts of ``batch_size``-row tensors
    there. ``transform_fn`` (if given) maps each yielded batch. String,
    Decimal and other object columns cannot become tensors and raise:
    select numeric fields or drop them with a TransformSpec."""

    def __init__(self, reader, batch_size=1, transform_fn=None, shuffling_queue_capacity=0,
                 shuffling_queue_seed=None, device="cuda"):
        super().__init__(reader, device)
        if not getattr(reader, "batched_output", False):
            raise ValueError("BatchedDataLoader expects a batch reader "
                             "(make_batch_reader); use DataLoader with make_reader")
        self.batch_size = batch_size
        self.transform_fn = transform_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._shuffling_queue_seed = shuffling_queue_seed

    def _make_buffer(self):
        if self.shuffling_queue_capacity:
            return BatchedRandomShufflingBuffer(
                self.shuffling_queue_capacity,
                min_after_retrieve=self.shuffling_queue_capacity // 2,
                extra_capacity=max(self.shuffling_queue_capacity, 100000),
                batch_size=self.batch_size, random_seed=self._shuffling_queue_seed,
                device=self.device)
        return BatchedNoopShufflingBuffer(batch_size=self.batch_size, device=self.device)

    def __iter__(self):
        buffer = self._make_buffer()
        for col_batch in self.reader:
            buffer.add_many({name: _column_tensor(name, col)
                             for name, col in col_batch._asdict().items()})
            # The FIFO buffer streams every retrievable batch (an infinite
            # reader would otherwise accumulate forever); the random one
            # holds until capacity to keep its whole shuffle window.
            while buffer.should_drain():
                yield self._emit(buffer.retrieve())
        buffer.finish()
        while buffer.can_retrieve():
            yield self._emit(buffer.retrieve())

    def _emit(self, batch):
        return self.transform_fn(batch) if self.transform_fn else batch


class InMemBatchedDataLoader(_LoaderBase):
    """Reads every row once (up to ``rows_capacity``) into tensors on
    ``device``, then serves ``num_epochs`` of ``batch_size``-row batches,
    each epoch in a fresh ``randperm`` order (from a CPU generator seeded
    by ``random_seed``) when ``shuffle``, without re-reading Parquet.
    Unsigned columns of a batch reader are promoted as the other loaders
    promote them (the JAX package keeps them, and torch cannot
    ``index_select`` a uint16 tensor)."""

    def __init__(self, reader, batch_size=1, num_epochs=1, rows_capacity=None, shuffle=True,
                 random_seed=None, device="cuda"):
        super().__init__(reader, device)
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self._rows_capacity = rows_capacity
        self._random_seed = random_seed
        self._cache = None  # name -> tensor [N, ...] on the device

    def _fill_cache(self):
        if getattr(self.reader, "batched_output", False):
            chunks, cached_rows = {}, 0
            for col_batch in self.reader:
                for name, col in col_batch._asdict().items():
                    chunks.setdefault(name, []).append(_column_tensor(name, col))
                cached_rows += len(next(iter(col_batch)))
                # The capacity bounds the read itself: with num_epochs=None
                # the stream never ends on its own.
                if self._rows_capacity and cached_rows >= self._rows_capacity:
                    break
            cache = {k: torch.cat(v) for k, v in chunks.items()}
        else:
            rows = []
            for row in self.reader:
                rows.append(_sanitize_pytorch_types(row._asdict()))
                if self._rows_capacity and len(rows) >= self._rows_capacity:
                    break
            cache = ({name: torch.as_tensor(np.stack([np.asarray(r[name]) for r in rows]))
                      for name in rows[0]} if rows else {})
        if self._rows_capacity:
            cache = {k: v[:self._rows_capacity] for k, v in cache.items()}
        self._cache = {k: v.to(self.device) for k, v in cache.items()}

    def __iter__(self):
        if self._cache is None:
            self._fill_cache()
        if not self._cache:
            return
        n = next(iter(self._cache.values())).shape[0]
        generator = torch.Generator()
        if self._random_seed is not None:
            generator.manual_seed(self._random_seed)
        for _ in range(self.num_epochs):
            order = torch.randperm(n, generator=generator) if self.shuffle else torch.arange(n)
            order = order.to(self.device)
            for start in range(0, n, self.batch_size):
                idx = order[start:start + self.batch_size]
                yield {k: v.index_select(0, idx) for k, v in self._cache.items()}
