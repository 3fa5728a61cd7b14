"""Size-budget LRU eviction for on-disk cache directories (the port's own
copy of ``petastorm_tpu/cache_impl/eviction.py``), shared by the
:class:`~petastorm_tpu_torch.cache_impl.batch_cache.BatchCache` disk tier
and :class:`~petastorm_tpu_torch.local_disk_cache.LocalDiskCache`.

Sizes are measured (``stat``), and recency is the later of access and
modification time (the caches ``utime`` an entry on every hit, so either
clock moves on mounts without atime). Entries are one file per key written
by temp file and atomic rename, so a file deleted by another process during
the scan is skipped, and processes evicting one directory converge on the
same budget.
"""

from __future__ import annotations

import os


def _entries(path, suffix):
    """``(recency, size, path)`` of every ``suffix`` entry under ``path``."""
    try:
        names = os.listdir(path)
    except OSError:
        return []
    out = []
    for name in names:
        if not name.endswith(suffix):
            continue
        full = os.path.join(path, name)
        try:
            stat = os.stat(full)
        except OSError:  # deleted by another process meanwhile
            continue
        out.append((max(stat.st_atime, stat.st_mtime), stat.st_size, full))
    return out


def dir_size(path, suffix):
    """Total bytes of ``suffix``-named entries under ``path``."""
    return sum(size for _, size, _ in _entries(path, suffix))


def evict_dir_to_limit(path, size_limit, suffix):
    """Delete the least recently used ``suffix`` entries under ``path``
    until the directory fits ``size_limit`` bytes; ``None`` deletes
    nothing. Returns ``(files_deleted, bytes_deleted)``."""
    if size_limit is None:
        return 0, 0
    entries = sorted(_entries(path, suffix))  # least recently used first
    total = sum(size for _, size, _ in entries)
    deleted = freed = 0
    for _, size, full in entries:
        if total <= size_limit:
            break
        try:
            os.unlink(full)
        except OSError:
            continue
        total -= size
        deleted += 1
        freed += size
    return deleted, freed
