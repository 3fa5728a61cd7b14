"""Local-disk row-group cache with a size limit and LRU eviction (the
port's own copy of ``petastorm_tpu/local_disk_cache.py``, which needs no
``diskcache`` package).

One file per key, named by the sha256 of ``repr(key)``; a value is written
to a temporary file and renamed into place, so readers on one host may
share a directory. After each store the least recently used entries (by
access or modification time; a hit touches its entry) are deleted until
the directory's entries fit ``size_limit`` bytes
(:mod:`petastorm_tpu_torch.cache_impl.eviction`).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tempfile

from petastorm_tpu_torch.cache import CacheBase
from petastorm_tpu_torch.cache_impl.eviction import dir_size, evict_dir_to_limit


class LocalDiskCache(CacheBase):
    _SUFFIX = ".cache"

    def __init__(self, path, size_limit, expected_row_size_estimate=None,
                 shards=None, cleanup=False, **settings):
        """``size_limit`` in bytes. ``expected_row_size_estimate`` and
        ``shards`` are taken for the JAX package's signature and unused:
        eviction measures the files. ``cleanup=True``: :meth:`cleanup`
        removes the directory."""
        self._path = path
        self._size_limit = size_limit
        self._cleanup_on_exit = cleanup
        os.makedirs(path, exist_ok=True)

    def _key_path(self, key):
        digest = hashlib.sha256(repr(key).encode("utf-8")).hexdigest()
        return os.path.join(self._path, digest + self._SUFFIX)

    def get(self, key, fill_cache_func):
        file_path = self._key_path(key)
        try:
            with open(file_path, "rb") as f:
                value = self._deserialize(f.read())
        except Exception:  # noqa: BLE001 - a missing or unreadable entry is a miss
            pass
        else:
            try:
                os.utime(file_path)  # the LRU touch
            except OSError:  # a read-only directory: the value is still good
                pass
            return value
        value = fill_cache_func()
        self._store(file_path, self._serialize(value))
        return value

    def _serialize(self, value):
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def _deserialize(self, payload):
        return pickle.loads(payload)  # noqa: S301 - entries this class wrote

    def _store(self, file_path, payload):
        tmp_path = None
        try:
            # Inside the guard: the directory may vanish under a concurrent
            # cleanup(); a failed store is a skipped cache write.
            fd, tmp_path = tempfile.mkstemp(dir=self._path, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp_path, file_path)
        except OSError:
            if tmp_path is not None:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
            return
        evict_dir_to_limit(self._path, self._size_limit, self._SUFFIX)

    def size_on_disk(self):
        """Bytes of the entries in the directory."""
        return dir_size(self._path, self._SUFFIX)

    def cleanup(self):
        if self._cleanup_on_exit:
            shutil.rmtree(self._path, ignore_errors=True)
