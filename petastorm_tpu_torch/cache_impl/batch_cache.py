"""Memory-budgeted, disk-spilling cache of collated batches.

The port's own copy of ``petastorm_tpu/cache_impl/batch_cache.py``. An
entry is one batch sequence (every collated batch of one loader epoch,
under one content key, :mod:`.fingerprint`), stored as the payload codec's
frames (:mod:`petastorm_tpu_torch.reader_impl.framed_socket`) packed back
to back into one contiguous buffer, with a per-batch frame index:

- the loader's hit path rebuilds each ``{field: ndarray}`` batch from its
  frames, columnar batches as read-only views over the entry's bytes;
- the disk tier writes the entry as a magic line, a JSON meta header (frame
  lengths, per-batch offsets, crc32 of the payload) and the payload: the
  on-disk format version 3 of the JAX package, so either package's cache
  serves the other's entries.

Tiers: a memory LRU under ``mem_budget_bytes`` (an eviction drops the
memory copy; entries are written through to disk at fill time) and an
optional disk tier under ``disk_budget_bytes``
(:mod:`~petastorm_tpu_torch.cache_impl.eviction`). A corrupt or torn disk
entry is counted, deleted and served as a miss; an entry under an older
format's magic is counted and deleted as a version mismatch.

Thread-safe: lookups, fills and evictions share one lock, file I/O runs
outside it. Entry files are temp-written and renamed, so processes may
share a directory. Every cache feeds the registry's eleven ``CACHE_*``
families as the JAX cache does (summed over the caches of the process),
and :meth:`BatchCache.stats` keeps its own counts. The failpoints
``cache.write`` (``oserror``: the entry's disk write is skipped;
``partial``: a torn entry is published, which the load detects and
deletes) and ``cache.read`` (``oserror``: the load is a miss) live here.
The fleet cache tier (:mod:`~petastorm_tpu_torch.cache_impl.fleet_tier`)
wraps a cache through :meth:`BatchCache.peek`, :meth:`BatchCache.put_entry`,
:meth:`BatchCache.hot_entries` and a deferred :meth:`BatchCache.note_miss`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import tempfile
import threading
import time
import zlib
from collections import OrderedDict

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.telemetry.metrics import (
    CACHE_BYTES,
    CACHE_CORRUPT,
    CACHE_DISK_WRITE_ERRORS,
    CACHE_ENTRIES,
    CACHE_EVICTIONS,
    CACHE_FILL_SECONDS,
    CACHE_HITS,
    CACHE_MISSES,
    CACHE_PERMUTED_SERVES,
    CACHE_SERVE_SECONDS,
    CACHE_VERSION_EVICTED,
)

#: On-disk entry format version, in the magic line and the meta header.
ENTRY_FORMAT_VERSION = 3
_MAGIC = b"PTBCACHE3\n"
#: Magics of older formats: such an entry is a version mismatch (deleted,
#: refilled by the next decode), not corruption.
_OLD_MAGICS = (b"PTBCACHE1\n", b"PTBCACHE2\n")
_LEN = struct.Struct("!Q")

logger = logging.getLogger(__name__)

#: Disk-tier entry suffix (the eviction policy scopes to it).
ENTRY_SUFFIX = ".ptbc"

CACHE_MODES = ("off", "mem", "mem+disk")


class CacheConfig:
    """The cache's three settings (mode, memory MiB, directory; plus the
    disk budget) as a value object; :meth:`build` makes the
    :class:`BatchCache`, or ``None`` for ``"off"``."""

    def __init__(self, mode="off", mem_mb=256, cache_dir=None, disk_mb=None):
        if mode not in CACHE_MODES:
            raise ValueError(f"cache mode must be one of {CACHE_MODES}, got {mode!r}")
        if mode != "mem+disk" and (cache_dir is not None or disk_mb is not None):
            # Dropping them would run a caller who asked for persistence
            # with a cold, memory-only cache.
            raise ValueError(
                f"cache_dir/disk_mb only apply to mode='mem+disk' "
                f"(got mode={mode!r} with cache_dir={cache_dir!r}, "
                f"disk_mb={disk_mb!r})")
        self.mode = mode
        self.mem_mb = mem_mb
        self.cache_dir = cache_dir
        self.disk_mb = disk_mb

    def build(self):
        if self.mode == "off":
            return None
        return BatchCache(
            mem_budget_bytes=int(self.mem_mb * (1 << 20)),
            cache_dir=self.cache_dir if self.mode == "mem+disk" else None,
            spill_to_disk=self.mode == "mem+disk",
            disk_budget_bytes=int(self.disk_mb * (1 << 20)) if self.disk_mb else None)


class CachedBatch:
    """One batch of an entry: its row count, format and frames (views into
    the entry's buffer)."""

    __slots__ = ("rows", "fmt", "frames")

    def __init__(self, rows, fmt, frames):
        self.rows = rows
        self.fmt = fmt
        self.frames = frames

    def to_dict(self):
        """The ``{field: ndarray}`` batch. Columnar batches are read-only
        views over the entry's immutable bytes (a consumer writing to one
        gets a ``ValueError``, never a corrupted cache). Pickle batches get
        their out-of-band frames copied first: protocol-5 reconstruction
        would alias them into writable arrays."""
        from petastorm_tpu_torch.reader_impl.framed_socket import (
            PAYLOAD_COLUMNAR,
            decode_payload,
        )

        if self.fmt == PAYLOAD_COLUMNAR:
            return decode_payload(self.fmt,
                                  [memoryview(f).toreadonly() for f in self.frames])
        return decode_payload(self.fmt,
                              [self.frames[0]] + [bytearray(f) for f in self.frames[1:]])


class CachedEntry:
    """One key's batch sequence: per-batch meta ``[(rows, fmt,
    [frame_len, ...]), ...]``, one contiguous buffer, and the frame index
    (each batch's payload offset), so :meth:`batch_at` seeks any batch
    without touching the ones before it: serve-time permutation's
    primitive."""

    __slots__ = ("meta", "buf", "nbytes", "_offsets")

    def __init__(self, meta, buf):
        self.meta = meta
        self.buf = buf
        self.nbytes = len(buf)
        offsets, offset = [], 0
        for _, _, frame_lens in meta:
            offsets.append(offset)
            offset += sum(frame_lens)
        self._offsets = offsets

    @property
    def rows(self):
        return sum(rows for rows, _, _ in self.meta)

    @property
    def num_batches(self):
        return len(self.meta)

    def batch_at(self, index):
        """The ``index``-th batch as zero-copy views into the buffer."""
        rows, fmt, frame_lens = self.meta[index]
        view = memoryview(self.buf)
        offset = self._offsets[index]
        frames = []
        for length in frame_lens:
            frames.append(view[offset:offset + length])
            offset += length
        return CachedBatch(rows, fmt, frames)

    def batches(self):
        for index in range(len(self.meta)):
            yield self.batch_at(index)

    def to_dicts(self):
        return [batch.to_dict() for batch in self.batches()]


class EntryBuilder:
    """One entry's batches during a fill. :meth:`commit` publishes it at
    once; an abandoned builder publishes nothing, so a partial epoch is
    never served as a whole one."""

    def __init__(self, cache, key):
        self._cache = cache
        self._key = key
        self._meta = []
        self._chunks = []
        self._committed = False
        self._spent_s = 0.0  # encode + copy time, the fill histogram's share

    def add_batch(self, batch, rows=None):
        """Encode ``batch`` and append its frames; ``(rows, fmt, frames)``,
        the frames just encoded, so a worker sends what it cached.
        ``rows``: the batch's row count when the caller knows it."""
        from petastorm_tpu_torch.reader_impl.framed_socket import encode_payload

        t0 = time.perf_counter()
        fmt, frames = encode_payload(batch)
        if rows is None:
            rows = batch_rows(batch)
        self._append(rows, fmt, frames)
        self._spent_s += time.perf_counter() - t0
        return rows, fmt, frames

    def add_frames(self, rows, fmt, frames):
        """Append a batch the caller already encoded (the streaming piece
        engine sends the same frames)."""
        t0 = time.perf_counter()
        self._append(rows, fmt, frames)
        self._spent_s += time.perf_counter() - t0

    def _append(self, rows, fmt, frames):
        views = [memoryview(f) for f in frames]
        self._meta.append((int(rows), int(fmt), [v.nbytes for v in views]))
        # Copied now: out-of-band frames alias the batch's arrays, which the
        # producer hands on and the consumer may overwrite.
        self._chunks.extend(bytes(v) for v in views)

    def commit(self):
        """Freeze into a :class:`CachedEntry`, publish it to the tiers and
        return it (one ``CACHE_FILL_SECONDS`` observation per entry)."""
        if self._committed:
            raise RuntimeError("EntryBuilder.commit() called twice")
        self._committed = True
        t0 = time.perf_counter()
        entry = CachedEntry(self._meta, self._cache._materialize(b"".join(self._chunks)))
        self._chunks = None
        self._cache._publish(self._key, entry)
        CACHE_FILL_SECONDS.observe(self._spent_s + (time.perf_counter() - t0))
        return entry


def batch_rows(batch):
    """Row count of a collated ``{field: array}`` batch (0 for ``{}``)."""
    for value in batch.values():
        return int(len(value))
    return 0


class BatchCache:
    """See the module docstring. ``spill_to_disk=True`` with
    ``cache_dir=None`` makes a private temporary directory that
    :meth:`cleanup` removes; a caller's directory persists (a later cache
    on it serves its entries), and ``cleanup()`` only stops tracking it."""

    def __init__(self, mem_budget_bytes=256 << 20, cache_dir=None, spill_to_disk=False,
                 disk_budget_bytes=None):
        if mem_budget_bytes <= 0:
            raise ValueError("mem_budget_bytes must be positive")
        self._mem_budget = int(mem_budget_bytes)
        self._disk_budget = disk_budget_bytes
        self._disk = bool(spill_to_disk)
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # key -> CachedEntry, LRU first
        self._mem_bytes = 0
        self._owns_dir = False
        self._dir = None
        if self._disk:
            from petastorm_tpu_torch import cache_impl as tracking

            if cache_dir is None:
                self._dir = tempfile.mkdtemp(prefix="petastorm_batch_cache_")
                self._owns_dir = True
                tracking.register_cache_dir(self._dir)
            else:
                self._dir = str(cache_dir)
                if not os.path.isdir(self._dir):
                    os.makedirs(self._dir, exist_ok=True)
                    tracking.register_cache_dir(self._dir)
        self.hits_mem = 0
        self.hits_disk = 0
        self.misses = 0
        self.evictions_mem = 0
        self.evictions_disk = 0
        self.corrupt_entries = 0
        self.version_evicted = 0
        self.permuted_serves = 0
        self.disk_write_errors = 0
        self._m_hits_mem = CACHE_HITS.labels("mem")
        self._m_hits_disk = CACHE_HITS.labels("disk")
        self._m_bytes_mem = CACHE_BYTES.labels("mem")
        self._m_entries_mem = CACHE_ENTRIES.labels("mem")
        self._m_bytes_disk = CACHE_BYTES.labels("disk")
        self._m_entries_disk = CACHE_ENTRIES.labels("disk")
        self._m_evict_mem = CACHE_EVICTIONS.labels("mem")
        self._m_evict_disk = CACHE_EVICTIONS.labels("disk")
        # This instance's share of the disk tier: the bytes and entries it
        # wrote, less what its evictions freed (clamped at zero); the
        # gauges carry it and cleanup() retracts it.
        self._disk_bytes_acct = 0
        self._disk_entries_acct = 0
        # The shm transport's frame pool, when armed: entry buffers are
        # placed in it, so warm serves travel as (offset, len) references.
        self._frame_allocator = None

    def set_frame_allocator(self, allocate):
        """Arm (``None``: disarm) an entry-buffer allocator,
        ``allocate(nbytes) -> writable buffer or None``. The shm transport
        points it at its frame pool so cached frames live in memory a
        client on the host can map; ``None`` from the allocator (the pool
        is full) keeps the entry on the heap, served by copy."""
        self._frame_allocator = allocate

    def _materialize(self, blob):
        """One entry's contiguous payload, through the armed allocator
        (itself when disarmed, empty, or the pool is full)."""
        allocate = self._frame_allocator
        if allocate is None or not len(blob):
            return blob
        view = allocate(len(blob))
        if view is None:
            return blob
        view[:] = blob
        return view

    @property
    def cache_dir(self):
        return self._dir

    # -- lookup ------------------------------------------------------------

    def get(self, key):
        """The :class:`CachedEntry` for ``key`` or ``None``: memory first,
        then disk (a disk hit is promoted into memory)."""
        return self.get_tiered(key)[0]

    def get_tiered(self, key, count_miss=True):
        """``(entry, tier)`` with ``tier`` ``"mem"`` or ``"disk"``, or
        ``(None, None)`` on a miss, counted unless ``count_miss=False`` (the
        fleet tier counts it only once its remote probe missed too)."""
        t0 = time.perf_counter()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits_mem += 1
        if entry is not None:
            self._m_hits_mem.inc()
            CACHE_SERVE_SECONDS.observe(time.perf_counter() - t0)
            return entry, "mem"
        if self._disk:
            entry = self._load_disk(key)
            if entry is not None:
                with self._lock:
                    self.hits_disk += 1
                    self._insert_locked(key, entry)
                self._m_hits_disk.inc()
                CACHE_SERVE_SECONDS.observe(time.perf_counter() - t0)
                return entry, "disk"
        if count_miss:
            self.note_miss()
        return None, None

    def note_miss(self):
        """Count one lookup no tier answered."""
        with self._lock:
            self.misses += 1
        CACHE_MISSES.inc()

    def note_permuted_serve(self, tier):
        """Count one entry served through a serve-time permutation (called
        by the loader, which alone knows the order; ``tier`` is where the
        entry was found, the registry series' label)."""
        with self._lock:
            self.permuted_serves += 1
        CACHE_PERMUTED_SERVES.labels(tier or "mem").inc()

    def peek(self, key):
        """The memory tier's entry for ``key`` or ``None``, without an LRU
        touch or a hit / miss count (a peer's fetch must not perturb this
        cache's statistics or eviction order)."""
        with self._lock:
            return self._entries.get(key)

    def get_batches(self, key):
        """The decoded ``[{field: ndarray}, ...]`` sequence, or ``None``."""
        entry = self.get(key)
        return None if entry is None else entry.to_dicts()

    def contains(self, key):
        with self._lock:
            if key in self._entries:
                return True
        return self._disk and os.path.exists(self._entry_path(key))

    #: ``contains`` without counting: whether a just-committed entry was
    #: kept by any tier (one larger than every budget is kept nowhere).
    retained = contains

    # -- fill --------------------------------------------------------------

    def begin_fill(self, key):
        return EntryBuilder(self, key)

    def put_batches(self, key, batches):
        """Cache a complete batch sequence in one call."""
        builder = self.begin_fill(key)
        for batch in batches:
            builder.add_batch(batch)
        return builder.commit()

    def put_entry(self, key, meta, blob):
        """Adopt an entry framed elsewhere (a peer's remote serve or drain
        hand-off): ``meta`` is ``[(rows, fmt, [frame_len, ...]), ...]`` and
        ``blob`` the contiguous payload, placed through the frame allocator
        like a local fill. Raises ``ValueError`` when the frame lengths do
        not sum to the payload's: a torn transfer is never published."""
        meta = [(int(rows), int(fmt), [int(length) for length in lens])
                for rows, fmt, lens in meta]
        expected = sum(length for _, _, lens in meta for length in lens)
        if expected != len(blob):
            raise ValueError(f"entry payload is {len(blob)} bytes but meta frames sum to "
                             f"{expected}")
        entry = CachedEntry(meta, self._materialize(bytes(blob)))
        self._publish(key, entry)
        return entry

    def hot_entries(self):
        """The memory tier as ``[(key, entry), ...]``, most recently used
        first (what a draining worker ships). Entries are immutable, so the
        list stays valid while eviction races it."""
        with self._lock:
            return [(key, entry) for key, entry in reversed(self._entries.items())]

    def _publish(self, key, entry):
        if self._disk:
            self._store_disk(key, entry)
        with self._lock:
            self._insert_locked(key, entry)

    def _insert_locked(self, key, entry):
        old = self._entries.pop(key, None)
        if old is not None:
            self._account_mem_locked(-old.nbytes, -1)
        if entry.nbytes <= self._mem_budget:
            self._entries[key] = entry
            self._account_mem_locked(entry.nbytes, 1)
        # else: an entry larger than the whole budget lives on disk only
        # (memory-only: it is not retained).
        while self._mem_bytes > self._mem_budget and self._entries:
            _, evicted = self._entries.popitem(last=False)
            self._account_mem_locked(-evicted.nbytes, -1)
            self.evictions_mem += 1
            self._m_evict_mem.inc()

    def _account_mem_locked(self, bytes_delta, entries_delta):
        self._mem_bytes += bytes_delta
        self._m_bytes_mem.inc(bytes_delta)
        self._m_entries_mem.inc(entries_delta)

    # -- disk tier ---------------------------------------------------------

    def _entry_path(self, key):
        digest = hashlib.sha256(str(key).encode("utf-8")).hexdigest()
        return os.path.join(self._dir, digest + ENTRY_SUFFIX)

    def _store_disk(self, key, entry):
        meta = json.dumps({
            "format": ENTRY_FORMAT_VERSION,
            "crc32": zlib.crc32(entry.buf) & 0xFFFFFFFF,
            # The frame index rides along: on load, an offset that disagrees
            # with the running sum of frame lengths marks the file bad.
            "batches": [{"rows": rows, "fmt": fmt, "frame_lens": lens, "offset": offset}
                        for (rows, fmt, lens), offset in zip(entry.meta, entry._offsets)],
        }).encode("utf-8")
        path = self._entry_path(key)
        try:
            old_size = os.path.getsize(path)
        except OSError:
            old_size = None
        tmp_path = None
        fp = failpoints.ACTIVE
        try:
            # "oserror" raises into the skip below; "partial" publishes a
            # torn entry, which the load must detect and never serve.
            partial = fp is not None and fp.fire("cache.write") == "partial"
            # mkstemp inside the guard: an unwritable or vanished directory
            # degrades the cache for this entry, it does not fail the stream.
            fd, tmp_path = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(_MAGIC)
                f.write(_LEN.pack(len(meta)))
                f.write(meta)
                f.write(entry.buf[:entry.nbytes // 2] if partial else entry.buf)
            os.replace(tmp_path, path)
        except OSError:  # disk full, directory removed, fd exhaustion
            with self._lock:
                self.disk_write_errors += 1
            CACHE_DISK_WRITE_ERRORS.inc()
            logger.warning("disk-tier cache entry write failed; skipping the entry",
                           exc_info=True)
            if tmp_path is not None:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
            return
        new_size = len(_MAGIC) + _LEN.size + len(meta) + entry.nbytes
        self._account_disk(new_size - (old_size or 0), 0 if old_size is not None else 1)
        if self._disk_budget is not None:
            from petastorm_tpu_torch.cache_impl.eviction import evict_dir_to_limit

            deleted, freed = evict_dir_to_limit(self._dir, self._disk_budget, ENTRY_SUFFIX)
            if deleted:
                with self._lock:
                    self.evictions_disk += deleted
                self._m_evict_disk.inc(deleted)
                self._account_disk(-freed, -deleted)

    def _account_disk(self, bytes_delta, entries_delta):
        with self._lock:
            bytes_delta = max(bytes_delta, -self._disk_bytes_acct)
            entries_delta = max(entries_delta, -self._disk_entries_acct)
            self._disk_bytes_acct += bytes_delta
            self._disk_entries_acct += entries_delta
        self._m_bytes_disk.inc(bytes_delta)
        self._m_entries_disk.inc(entries_delta)

    def _drop_bad_entry(self, path):
        try:
            os.unlink(path)
        except OSError:
            pass

    def _load_disk(self, key):
        path = self._entry_path(key)
        try:
            fp = failpoints.ACTIVE
            if fp is not None:
                fp.fire("cache.read")  # "oserror": a miss, never a stream error
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        if any(blob.startswith(magic) for magic in _OLD_MAGICS):
            with self._lock:
                self.version_evicted += 1
            CACHE_VERSION_EVICTED.inc()
            logger.warning("disk-tier cache entry %s has an older format; deleting it", path)
            self._drop_bad_entry(path)
            return None
        try:
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic")
            meta_off = len(_MAGIC)
            meta_len = _LEN.unpack_from(blob, meta_off)[0]
            payload_off = meta_off + _LEN.size + meta_len
            meta = json.loads(blob[meta_off + _LEN.size:payload_off].decode("utf-8"))
            if int(meta.get("format", 0)) != ENTRY_FORMAT_VERSION:
                raise ValueError("meta format/magic version disagree")
            payload = blob[payload_off:]
            entry = CachedEntry([(m["rows"], m["fmt"], list(m["frame_lens"]))
                                 for m in meta["batches"]], payload)
            if sum(length for _, _, lens in entry.meta for length in lens) != entry.nbytes:
                raise ValueError("truncated payload")
            if [m["offset"] for m in meta["batches"]] != entry._offsets:
                raise ValueError("frame index disagrees with frame lengths")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != int(meta["crc32"]):
                raise ValueError("payload checksum mismatch")
        except (ValueError, KeyError, TypeError, struct.error):
            # Corrupt or torn: counted, deleted so it cannot fail every
            # epoch, and a miss, so the caller decodes afresh.
            with self._lock:
                self.corrupt_entries += 1
            CACHE_CORRUPT.inc()
            logger.warning("disk-tier cache entry %s failed validation; deleting it", path)
            self._drop_bad_entry(path)
            return None
        try:
            os.utime(path)  # the LRU touch
        except OSError:
            pass
        # Into the frame pool only after validation: a corrupt entry must
        # not take pool bytes it will never serve from.
        pooled = self._materialize(payload)
        if pooled is not payload:
            entry = CachedEntry(entry.meta, pooled)
        return entry

    # -- observability / lifecycle -----------------------------------------

    def stats(self):
        """The counts, under the JAX cache's keys."""
        with self._lock:
            hits = self.hits_mem + self.hits_disk
            return {
                "mode": "mem+disk" if self._disk else "mem",
                "hits": hits,
                "hits_mem": self.hits_mem,
                "hits_disk": self.hits_disk,
                "misses": self.misses,
                "hit_rate": round(hits / max(1, hits + self.misses), 4),
                "entries_mem": len(self._entries),
                "bytes_mem": self._mem_bytes,
                "entries_disk": self._disk_entries_acct,
                "bytes_disk": self._disk_bytes_acct,
                "mem_budget_bytes": self._mem_budget,
                "evictions_mem": self.evictions_mem,
                "evictions_disk": self.evictions_disk,
                "corrupt_entries": self.corrupt_entries,
                "version_evicted": self.version_evicted,
                "permuted_serves": self.permuted_serves,
                "disk_write_errors": self.disk_write_errors,
                "cache_dir": self._dir,
            }

    def cleanup(self):
        """Drop the memory tier; remove the disk directory only when this
        cache made it; always stop tracking the directory."""
        with self._lock:
            while self._entries:
                _, entry = self._entries.popitem(last=False)
                self._account_mem_locked(-entry.nbytes, -1)
        self._account_disk(-self._disk_bytes_acct, -self._disk_entries_acct)
        if self._dir is not None:
            from petastorm_tpu_torch import cache_impl as tracking

            if self._owns_dir:
                import shutil

                shutil.rmtree(self._dir, ignore_errors=True)
            tracking.deregister_cache_dir(self._dir)
