"""Consistent-hash ring for the fleet cache tier's entry placement (the
port's own copy of ``petastorm_tpu/cache_impl/hash_ring.py``).

Each decoded-batch cache key (a fingerprint from
:mod:`petastorm_tpu_torch.cache_impl.fingerprint`) maps to one *owner*
peer, the worker that holds (or should hold) the warm entry:

- **stable**: placement is a pure function of ``(peers, vnodes, key)``
  (no process state, clock or RNG), and equal to the JAX ring's, so a
  fleet mixing workers of both packages agrees on every owner;
- **minimal churn**: adding or removing one peer moves at most ``~1/N`` of
  the keyspace, and no key moves both ways in one rebalance;
- **the same everywhere**: every worker builds the same ring from the
  dispatcher's published peer list.

Points are blake2b digests of 8 bytes, read big-endian (Python's ``hash``
is salted per process).
"""

import bisect
import hashlib

DEFAULT_VNODES = 64


def _point(data):
    """The 64-bit ring coordinate of ``data`` (bytes)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring over peer ids with ``vnodes`` virtual nodes each.

    Membership changes go through :meth:`replace`, which swaps the point
    table as one attribute, so a concurrent :meth:`owner` sees the old ring
    or the new one, never a half-built one.
    """

    def __init__(self, peers=(), vnodes=DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes!r}")
        self._vnodes = int(vnodes)
        self._peers = ()
        self._table = ([], [])  # (sorted points, owner of each point)
        self.replace(peers)

    @property
    def peers(self):
        """The members, sorted."""
        return self._peers

    @property
    def vnodes(self):
        return self._vnodes

    def __len__(self):
        return len(self._peers)

    def __contains__(self, peer_id):
        return peer_id in self._peers

    def replace(self, peers):
        """Swap the membership to ``peers`` (idempotent, order-insensitive)."""
        members = tuple(sorted(set(str(p) for p in peers)))
        if members == self._peers:
            return
        pairs = sorted((_point(f"{peer}#{vnode}".encode()), peer)
                       for peer in members for vnode in range(self._vnodes))
        self._peers = members
        self._table = ([p for p, _ in pairs], [w for _, w in pairs])

    def _start(self, key):
        points, owners = self._table
        h = _point(key.encode() if isinstance(key, str) else key)
        return points, owners, bisect.bisect_right(points, h)

    def owner(self, key):
        """The owner of ``key`` (a fingerprint string or bytes), or None on
        an empty ring."""
        points, owners, idx = self._start(key)
        if not points:
            return None
        return owners[idx % len(points)]

    def owners(self, key, n=2):
        """The first ``n`` distinct peers clockwise from ``key``: the owner,
        then its successors (fallback fetch targets)."""
        points, owners, idx = self._start(key)
        out = []
        for step in range(len(points)):
            peer = owners[(idx + step) % len(points)]
            if peer not in out:
                out.append(peer)
                if len(out) >= n:
                    break
        return out


def placement(keys, peers, vnodes=DEFAULT_VNODES):
    """``{key: owner}`` under ``peers``: the golden placement vectors, and
    where a draining worker's entries land on the ring without it."""
    ring = HashRing(peers, vnodes=vnodes)
    return {key: ring.owner(key) for key in keys}
