"""The fleet cache tier: consistent-hash placement and remote warm serves
(the port's own copy of ``petastorm_tpu/cache_impl/fleet_tier.py``).

Wraps one worker's :class:`~petastorm_tpu_torch.cache_impl.batch_cache.
BatchCache` into a tier shared by the fleet's workers:

- **placement**: each entry key has one owner on a consistent-hash ring
  over the serving cache peers (:mod:`~petastorm_tpu_torch.cache_impl.
  hash_ring`). A fresh fill is written through to its owner by a push
  thread (``cache-peer-push-<worker id>``); a local miss asks the owner
  before the worker decodes;
- **remote warm serves**: a peer answers ``cache_fetch`` with the entry's
  per-batch meta and its one contiguous buffer as a columnar payload (the
  cached bytes are the wire bytes), and the fetcher adopts it through its
  cache's frame allocator, so a client on its host maps the frames;
- **warm hand-off**: a draining worker ships its memory tier to the peers
  that inherit its keys (the ring without it), so a drain decodes nothing
  again;
- **degradation**: a dead peer, a torn transfer or a protocol error feeds
  a per-peer circuit breaker and becomes a local fill. The tier makes a
  stream faster and never breaks it. The ``cache-peer-gone`` and
  ``handoff-torn`` failpoints live here.

The tier answers the cache's interface (``get_tiered``, ``begin_fill``,
``note_permuted_serve``, ``stats``, ``cleanup``, the rest by delegation),
so the piece engine uses it unchanged; a remote hit is the tier
``"remote"``. ``entry_wire_meta`` / ``entry_wire_payload`` give the JAX
tier's bytes, so workers of both packages serve each other. Imports
neither torch nor JAX.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch.cache_impl.hash_ring import HashRing
from petastorm_tpu_torch.telemetry.metrics import (
    CACHE_HITS,
    CACHE_PEER_FETCHES,
    CACHE_PEER_HANDOFF_ENTRIES,
    CACHE_PEER_PUSHES,
    CACHE_PEER_SERVES,
)

logger = logging.getLogger(__name__)

#: The write-through queue's bound: placement is best effort (the remote
#: fetch covers what is dropped), so a slow peer turns into drops, never
#: into back-pressure on the decode path.
PUSH_QUEUE_DEPTH = 64

#: Dial and request timeout of a peer request: a peer slower than this is
#: slower than the decode it would save.
PEER_TIMEOUT_S = 5.0


class PeerError(ValueError):
    """A peer answered with an error or an unintelligible reply (a
    ``ValueError``, so it degrades through the same local fill as every
    malformed reply)."""


def entry_wire_meta(entry):
    """``[[rows, fmt, frame_lens], ...]`` of a cache entry: the JSON half
    of the peer wire format."""
    return [[rows, fmt, list(lens)] for rows, fmt, lens in entry.meta]


def entry_wire_payload(entry):
    """The entry's contiguous buffer as a uint8 array view (no copy), sent
    as a columnar payload."""
    import numpy as np

    return {"buf": np.frombuffer(entry.buf, dtype=np.uint8)}


class _FleetEntryBuilder:
    """The local cache's entry builder, whose ``commit`` also hands the
    entry to the tier for write-through placement."""

    def __init__(self, tier, key, builder):
        self._tier = tier
        self._key = key
        self._builder = builder

    def add_batch(self, batch):
        return self._builder.add_batch(batch)

    def add_frames(self, rows, fmt, frames):
        return self._builder.add_frames(rows, fmt, frames)

    def commit(self):
        entry = self._builder.commit()
        self._tier._note_fill(self._key, entry)
        return entry


class FleetCacheTier:
    """See the module docstring.

    :param local: the worker's :class:`BatchCache` (it owns the tiers).
    :param worker_id: this worker's id, its name on the ring.
    :param clock: the monotonic clock of the per-peer breakers.
    :param peer_timeout_s: each peer request's timeout.
    """

    def __init__(self, local, worker_id, clock=time.monotonic, peer_timeout_s=PEER_TIMEOUT_S):
        self._local = local
        self._worker_id = str(worker_id)
        self._clock = clock
        self._peer_timeout_s = peer_timeout_s
        self._ring = HashRing()
        self._lock = threading.Lock()
        self._addresses = {}  # peer id -> (host, port)
        self._breakers = {}   # peer id -> CircuitBreaker
        # The tier's own counts (stats() merges them over the local ones).
        self.remote_hits = 0
        self.remote_misses = 0
        self.remote_errors = 0
        self.breaker_skips = 0
        self.fills = 0
        self.pushes_sent = 0
        self.pushes_dropped = 0
        self.handoff_entries_sent = 0
        self.handoff_bytes_sent = 0
        self.handoff_entries_received = 0
        self._m_hits_remote = CACHE_HITS.labels("remote")
        self._stop = threading.Event()
        self._push_queue = queue.Queue(maxsize=PUSH_QUEUE_DEPTH)
        self._push_thread = threading.Thread(target=self._push_loop, daemon=True,
                                             name=f"cache-peer-push-{self._worker_id}")
        self._push_thread.start()

    def __getattr__(self, name):
        # Whatever the tier does not override (contains, retained, peek,
        # set_frame_allocator, put_entry, the counts) is the local cache's.
        return getattr(self._local, name)

    @property
    def local(self):
        return self._local

    @property
    def worker_id(self):
        return self._worker_id

    # -- membership --------------------------------------------------------

    def update_peers(self, peers):
        """Take the dispatcher's peer list, ``[[peer_id, host, port], ...]``
        (this worker included while it serves). Breakers persist across
        updates, so a flapping peer keeps its history."""
        addresses = {str(p): (str(h), int(port)) for p, h, port in peers}
        with self._lock:
            self._addresses = addresses
            for gone in [p for p in self._breakers if p not in addresses]:
                del self._breakers[gone]
        self._ring.replace(addresses)

    def ring_peers(self):
        return list(self._ring.peers)

    def _breaker(self, peer_id):
        from petastorm_tpu_torch.service.resilience import CircuitBreaker

        with self._lock:
            breaker = self._breakers.get(peer_id)
            if breaker is None:
                breaker = self._breakers[peer_id] = CircuitBreaker()
            return breaker

    def _address(self, peer_id):
        with self._lock:
            return self._addresses.get(peer_id)

    # -- lookup ------------------------------------------------------------

    def get(self, key):
        return self.get_tiered(key)[0]

    def get_tiered(self, key, count_miss=True):
        """The local tiers, then the ring owner. A remote hit is adopted
        into the local memory tier and reported as tier ``"remote"``; a
        fleet-wide miss counts as one miss."""
        entry, tier = self._local.get_tiered(key, count_miss=False)
        if entry is not None:
            return entry, tier
        entry = self._fetch_remote(key)
        if entry is not None:
            return entry, "remote"
        if count_miss:
            self._local.note_miss()
        return None, None

    def _fetch_remote(self, key):
        owner = self._ring.owner(key)
        if owner is None or owner == self._worker_id:
            return None
        breaker = self._breaker(owner)
        if not breaker.allow(self._clock()):
            with self._lock:
                self.breaker_skips += 1
            CACHE_PEER_FETCHES.labels("breaker_open").inc()
            return None
        try:
            header, payload = self._peer_request(
                owner, {"type": "cache_fetch", "key": str(key), "peer": self._worker_id})
            if header.get("type") == "error":
                raise PeerError(header.get("error", "peer error"))
            if not header.get("hit"):
                breaker.record_success()
                with self._lock:
                    self.remote_misses += 1
                CACHE_PEER_FETCHES.labels("miss").inc()
                return None
            entry = self._local.put_entry(key, header["meta"], payload["buf"])
        except (OSError, ValueError, KeyError, TypeError) as exc:
            if breaker.record_failure(self._clock()):
                logger.warning("cache peer %s breaker opened after repeated fetch failures — "
                               "its keys degrade to local fills", owner)
            with self._lock:
                self.remote_errors += 1
            CACHE_PEER_FETCHES.labels("error").inc()
            logger.debug("cache peer %s fetch failed (%s) — local fill", owner, exc)
            return None
        breaker.record_success()
        with self._lock:
            self.remote_hits += 1
        self._m_hits_remote.inc()
        CACHE_PEER_FETCHES.labels("hit").inc()
        return entry

    def _peer_request(self, peer_id, header, payload=None):
        """One request / reply with a peer over a fresh connection (a
        vanished peer costs one failed dial, never a held socket)."""
        from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

        fp = failpoints.ACTIVE
        if fp is not None and fp.fire("cache-peer-gone") == "gone":
            raise ConnectionRefusedError("failpoint cache-peer-gone: peer dial refused")
        address = self._address(peer_id)
        if address is None:
            raise ConnectionRefusedError(f"cache peer {peer_id!r} has no published address")
        with FramedConnection.connect(address, timeout=self._peer_timeout_s) as conn:
            return conn.request(header, payload)

    # -- fill and write-through placement ----------------------------------

    def begin_fill(self, key):
        return _FleetEntryBuilder(self, key, self._local.begin_fill(key))

    def put_batches(self, key, batches):
        builder = self.begin_fill(key)
        for batch in batches:
            builder.add_batch(batch)
        return builder.commit()

    def _note_fill(self, key, entry):
        with self._lock:
            self.fills += 1
        owner = self._ring.owner(key)
        if owner is None or owner == self._worker_id or self._stop.is_set():
            return
        try:
            self._push_queue.put_nowait((key, entry, owner))
        except queue.Full:
            with self._lock:
                self.pushes_dropped += 1
            CACHE_PEER_PUSHES.labels("dropped").inc()

    def _push_loop(self):
        while not self._stop.is_set():
            try:
                item = self._push_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                return
            key, entry, owner = item
            self._push_entry(key, entry, owner, origin="placement")

    def _push_entry(self, key, entry, owner, origin):
        """Ship one entry to ``owner`` with ``cache_put``: best effort, a
        failure is counted and feeds the breaker, and the remote fetch
        misses that key."""
        breaker = self._breaker(owner)
        if not breaker.allow(self._clock()):
            CACHE_PEER_PUSHES.labels("dropped").inc()
            with self._lock:
                self.pushes_dropped += 1
            return False
        try:
            header, _ = self._peer_request(
                owner, {"type": "cache_put", "key": str(key), "meta": entry_wire_meta(entry),
                        "peer": self._worker_id, "origin": origin},
                entry_wire_payload(entry))
            if header.get("type") != "ok":
                raise PeerError(header.get("error", "peer refused put"))
        except (OSError, ValueError, KeyError, TypeError) as exc:
            breaker.record_failure(self._clock())
            with self._lock:
                self.remote_errors += 1
            CACHE_PEER_PUSHES.labels("error").inc()
            logger.debug("cache peer %s put failed (%s)", owner, exc)
            return False
        breaker.record_success()
        with self._lock:
            self.pushes_sent += 1
        CACHE_PEER_PUSHES.labels("sent").inc()
        return True

    # -- the serving side (the worker's request handlers) ------------------

    def serve_fetch(self, key):
        """A peer's ``cache_fetch`` → ``(header, payload)``: the memory tier
        only, without touching this cache's counts or LRU order."""
        entry = self._local.peek(key)
        if entry is None:
            CACHE_PEER_SERVES.labels("miss").inc()
            return {"type": "cache_entry", "hit": False, "key": key}, None
        CACHE_PEER_SERVES.labels("hit").inc()
        return ({"type": "cache_entry", "hit": True, "key": key,
                 "meta": entry_wire_meta(entry)}, entry_wire_payload(entry))

    def adopt(self, key, meta, blob, origin="placement"):
        """A peer's ``cache_put``: adopt its entry. ``ValueError`` when the
        meta and the payload disagree (a torn transfer)."""
        entry = self._local.put_entry(key, meta, blob)
        if origin == "handoff":
            with self._lock:
                self.handoff_entries_received += 1
            CACHE_PEER_HANDOFF_ENTRIES.labels("received").inc()
        return entry

    # -- warm hand-off -----------------------------------------------------

    def handoff(self):
        """Ship the memory tier to the peers that inherit this worker's keys
        (the ring without it), hottest first; returns the summary the worker
        reports to the dispatcher (``entries``, ``bytes``, ``peers``,
        ``errors``, ``torn``). The ``handoff-torn`` failpoint stops it
        midway: the shipped entries stay shipped and the survivors decode
        the rest."""
        survivors = [p for p in self.ring_peers() if p != self._worker_id]
        summary = {"entries": 0, "bytes": 0, "peers": {}, "errors": 0, "torn": False}
        if not survivors:
            return summary
        ring = HashRing(survivors, vnodes=self._ring.vnodes)
        fp = failpoints.ACTIVE
        for key, entry in self._local.hot_entries():
            if fp is not None and fp.fire("handoff-torn") == "torn":
                summary["torn"] = True
                logger.warning("failpoint handoff-torn: warm hand-off stopped after %d entries "
                               "— the survivors decode the rest", summary["entries"])
                break
            owner = ring.owner(key)
            if not self._push_entry(key, entry, owner, origin="handoff"):
                summary["errors"] += 1
                continue
            summary["entries"] += 1
            summary["bytes"] += entry.nbytes
            summary["peers"][owner] = summary["peers"].get(owner, 0) + 1
            with self._lock:
                self.handoff_entries_sent += 1
                self.handoff_bytes_sent += entry.nbytes
            CACHE_PEER_HANDOFF_ENTRIES.labels("sent").inc()
        return summary

    # -- observability and lifecycle ---------------------------------------

    def note_permuted_serve(self, tier):
        self._local.note_permuted_serve(tier)

    def stats(self):
        stats = self._local.stats()
        with self._lock:
            remote_hits = self.remote_hits
            stats.update({
                "tier": "fleet",
                "peers": len(self._addresses),
                "remote_hits": remote_hits,
                "remote_misses": self.remote_misses,
                "remote_errors": self.remote_errors,
                "breaker_skips": self.breaker_skips,
                "breakers_open": sum(1 for b in self._breakers.values()
                                     if b.state != "closed"),
                "fills": self.fills,
                "pushes_sent": self.pushes_sent,
                "pushes_dropped": self.pushes_dropped,
                "handoff_entries_sent": self.handoff_entries_sent,
                "handoff_bytes_sent": self.handoff_bytes_sent,
                "handoff_entries_received": self.handoff_entries_received,
            })
        stats["hits"] = stats["hits"] + remote_hits
        stats["hit_rate"] = round(stats["hits"] / max(1, stats["hits"] + stats["misses"]), 4)
        return stats

    def cleanup(self):
        # Stop, drop the pending pushes (best effort by contract), then the
        # sentinel: a full queue must never block the stop.
        self._stop.set()
        try:
            while True:
                self._push_queue.get_nowait()
        except queue.Empty:
            pass
        try:
            self._push_queue.put_nowait(None)
        except queue.Full:
            pass
        self._push_thread.join(timeout=5)
        self._local.cleanup()
