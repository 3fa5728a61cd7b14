"""Shuffling buffers for batches of torch tensors, on a device (the port's
own copy of ``petastorm_tpu/reader_impl/pytorch_shuffling_buffer.py``).

Items are dicts of equal-length tensors (whole column batches); the store
lives on ``device``, and shuffling permutes rows across the buffered
batches with ``index_select`` instead of a per-row Python reservoir. The
random buffer draws its indices from a CPU ``torch.Generator`` seeded as
the JAX package's is, and moves them to the device, so a seed gives the
same row order on either device and in both packages.
"""

from __future__ import annotations

import torch

from petastorm_tpu_torch.ops.flash_attention import resolve_device


class BatchedShufflingBufferBase:
    """``add_many(dict of tensors)`` → ``retrieve()`` → dict of tensors of
    ``batch_size`` rows, on ``device`` (the card unless the caller asks for
    the CPU; without a card a CUDA request raises)."""

    def __init__(self, batch_size=1, device="cuda"):
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._done = False
        self.size = 0

    def finish(self):
        self._done = True

    def can_add(self):
        raise NotImplementedError

    def can_retrieve(self):
        raise NotImplementedError

    def should_drain(self):
        """True while the producer should keep retrieving between adds:
        whenever a batch is retrievable (the FIFO buffer streams; its
        ``can_add`` goes False only at ``finish()``). Buffers that gain from
        staying full override this."""
        return self.can_retrieve()

    def add_many(self, items):
        raise NotImplementedError

    def retrieve(self):
        raise NotImplementedError

    def _on_device(self, items):
        if self._done:
            raise RuntimeError("Cannot add to a finished buffer")
        return {k: torch.as_tensor(v).to(self.device) for k, v in items.items()}


class BatchedNoopShufflingBuffer(BatchedShufflingBufferBase):
    """FIFO pass-through: concatenates incoming batches, slices fixed ones."""

    def __init__(self, batch_size=1, device="cuda"):
        super().__init__(batch_size, device)
        self._store = None  # name -> list of tensors

    def add_many(self, items):
        items = self._on_device(items)
        if self._store is None:
            self._store = {k: [] for k in items}
        n = None
        for k, v in items.items():
            self._store[k].append(v)
            n = v.shape[0]
        self.size += n or 0

    def can_add(self):
        return not self._done

    def can_retrieve(self):
        if self._done:
            return self.size > 0
        return self.size >= self.batch_size

    def retrieve(self):
        take = min(self.batch_size, self.size)
        out = {}
        for k, chunks in self._store.items():
            joined = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
            out[k] = joined[:take]
            self._store[k] = [joined[take:]] if joined.shape[0] > take else []
        self.size -= take
        return out


class BatchedRandomShufflingBuffer(BatchedShufflingBufferBase):
    """Random reservoir over the rows of buffered column batches.

    ``shuffling_buffer_capacity``: target fill; ``min_after_retrieve``:
    rows kept back for shuffle quality until :meth:`finish`;
    ``extra_capacity``: headroom for whole-batch adds. A retrieval draws
    ``batch_size`` random rows (``randperm`` on the CPU generator) and
    moves rows of the tail into the vacated slots.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve=0,
                 extra_capacity=1000, batch_size=1, random_seed=None, device="cuda"):
        super().__init__(batch_size, device)
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._hard_capacity = shuffling_buffer_capacity + extra_capacity
        self._generator = torch.Generator()
        if random_seed is not None:
            self._generator.manual_seed(random_seed)
        self._store = None  # name -> one concatenated tensor

    def add_many(self, items):
        items = self._on_device(items)
        n = next(iter(items.values())).shape[0] if items else 0
        if self.size + n > self._hard_capacity:
            raise RuntimeError(
                f"Shuffling buffer overflow: {self.size} + {n} > "
                f"{self._hard_capacity}; producers must check can_add()")
        if self._store is None:
            self._store = dict(items)
        else:
            self._store = {k: torch.cat([self._store[k], v]) for k, v in items.items()}
        self.size += n

    def can_add(self):
        return self.size < self._capacity and not self._done

    def can_retrieve(self):
        if self._done:
            return self.size > 0
        return self.size > self._min_after_retrieve

    def should_drain(self):
        # Hold batches until the buffer is at capacity: draining whenever
        # can_retrieve() allows would keep it at min_after_retrieve and
        # halve the shuffle window. can_add() goes False at capacity, so
        # the producer never waits here.
        return not self.can_add() and self.can_retrieve()

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError("retrieve() when can_retrieve() is False")
        take = min(self.batch_size, self.size)
        chosen = torch.randperm(self.size, generator=self._generator)[:take]
        last = self.size - take
        slots = chosen[chosen < last]
        tail_mask = torch.ones(take, dtype=torch.bool)
        tail_mask[chosen[chosen >= last] - last] = False
        tail_keep = torch.arange(last, self.size)[tail_mask]
        chosen, slots, tail_keep = (t.to(self.device) for t in (chosen, slots, tail_keep))
        out = {k: v.index_select(0, chosen) for k, v in self._store.items()}
        # Fill the vacated slots from the tail, then truncate: O(take) rows
        # move instead of the whole buffer.
        for k, v in self._store.items():
            if slots.numel():
                v[slots] = v.index_select(0, tail_keep)
            self._store[k] = v[:last]
        self.size = last
        return out
