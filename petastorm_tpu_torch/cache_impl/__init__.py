"""The decoded-batch cache (the port's own copy of
``petastorm_tpu/cache_impl``): collated batches kept under a content key in
a memory-budgeted LRU with an optional disk tier, so every loader epoch
after the first skips Parquet read, decode and collation.

- :mod:`~petastorm_tpu_torch.cache_impl.fingerprint`: content keys;
- :mod:`~petastorm_tpu_torch.cache_impl.batch_cache`: :class:`BatchCache`
  and :class:`CacheConfig`;
- :mod:`~petastorm_tpu_torch.cache_impl.eviction`: the size-budget LRU
  policy of on-disk caches.

Every directory a cache creates is registered here until its
``cleanup()``: :func:`live_cache_dirs` lets tests fail one that leaks.
"""

from __future__ import annotations

import threading

from petastorm_tpu_torch.cache_impl.batch_cache import BatchCache, CacheConfig
from petastorm_tpu_torch.cache_impl.fingerprint import batch_fingerprint, predicate_ingredient

__all__ = [
    "BatchCache",
    "CacheConfig",
    "batch_fingerprint",
    "predicate_ingredient",
    "register_cache_dir",
    "deregister_cache_dir",
    "live_cache_dirs",
]

_DIRS_LOCK = threading.Lock()
_LIVE_CACHE_DIRS = set()


def register_cache_dir(path):
    """Record that a cache created ``path`` and has not cleaned it up."""
    with _DIRS_LOCK:
        _LIVE_CACHE_DIRS.add(str(path))


def deregister_cache_dir(path):
    with _DIRS_LOCK:
        _LIVE_CACHE_DIRS.discard(str(path))


def live_cache_dirs():
    """Snapshot of cache-created directories not yet cleaned up."""
    with _DIRS_LOCK:
        return set(_LIVE_CACHE_DIRS)
