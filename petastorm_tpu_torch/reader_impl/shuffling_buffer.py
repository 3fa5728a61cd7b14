"""Bounded buffers between a row reader and the batcher (the port's own copy
of ``petastorm_tpu/reader_impl/shuffling_buffer.py``).

``RandomShufflingBuffer`` decorrelates the rows of a row group with
O(capacity) memory: retrieval swaps a random element with the tail. It makes
the same ``random.Random(seed)`` calls as the JAX package's, so a seeded
buffer yields the same order in both.
"""

from __future__ import annotations

import random
from collections import deque


class NoopShufflingBuffer:
    """Pass-through FIFO (shuffling off)."""

    def __init__(self):
        self._queue = deque()
        self._done = False

    def add_many(self, items):
        self._queue.extend(items)

    def retrieve(self):
        return self._queue.popleft()

    def can_add(self):
        return not self._done

    def can_retrieve(self):
        return len(self._queue) > 0

    @property
    def size(self):
        return len(self._queue)

    def finish(self):
        self._done = True


class RandomShufflingBuffer:
    """Random-eviction reservoir.

    ``shuffling_buffer_capacity``: :meth:`can_add` is False at or above it.
    ``min_after_retrieve``: retrieval waits until more than this many items
    are buffered, until :meth:`finish`. ``extra_capacity``: headroom above
    capacity for producers that add a whole row group at once.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve=0,
                 extra_capacity=1000, random_seed=None):
        if min_after_retrieve > shuffling_buffer_capacity:
            raise ValueError("min_after_retrieve cannot exceed capacity")
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._hard_capacity = shuffling_buffer_capacity + extra_capacity
        self._random = random.Random(random_seed)
        self._items = []
        self._done = False

    def add_many(self, items):
        if self._done:
            raise RuntimeError("Cannot add to a finished shuffling buffer")
        items = list(items)
        if len(self._items) + len(items) > self._hard_capacity:
            raise RuntimeError(
                f"Shuffling buffer overflow: {len(self._items)} + {len(items)} "
                f"> hard capacity {self._hard_capacity}. Producers must check "
                "can_add() between row groups.")
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve():
            raise RuntimeError("retrieve() called when can_retrieve() is False")
        index = self._random.randrange(len(self._items))
        self._items[index], self._items[-1] = self._items[-1], self._items[index]
        return self._items.pop()

    def can_add(self):
        return len(self._items) < self._capacity and not self._done

    def can_retrieve(self):
        if self._done:
            return len(self._items) > 0
        return len(self._items) > self._min_after_retrieve

    @property
    def size(self):
        return len(self._items)

    def finish(self):
        self._done = True
