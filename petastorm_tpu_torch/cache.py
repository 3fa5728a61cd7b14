"""Row-group result caches (the port's own copy of
``petastorm_tpu/cache.py``): a worker asks ``cache.get(key, fill)`` for a
work item's decoded payload, and a cache either returns what it stored
under ``key`` or calls ``fill()`` and stores the result."""

from __future__ import annotations

from abc import ABC, abstractmethod


class CacheBase(ABC):
    @abstractmethod
    def get(self, key, fill_cache_func):
        """The value cached for ``key``; on a miss, ``fill_cache_func()``,
        stored and returned."""

    def cleanup(self):
        """Release what the cache holds (optional)."""


class NullCache(CacheBase):
    """No caching: every ``get`` computes (the default)."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()
