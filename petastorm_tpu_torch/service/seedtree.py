"""Seed-tree deterministic order (the port's own copy of
``petastorm_tpu/service/seedtree.py``).

An order is a pure function of ``(seed, epoch, piece identity)``: every
piece gets its own key by folding its identity into an ``(seed, epoch)``
node of a seed tree, as ``jax.random.fold_in`` derives keys, and an epoch's
order is the pieces sorted by their keys. Any subset of pieces sorts into
the same relative order. :func:`permutation` applies the same idea to the
ordinals of a cached batch sequence, which is how the decoded-batch cache
serves one canonical entry in a fresh order every pass.

Pure stdlib (blake2b), no RNG state: every function gives the JAX package's
integers for the same arguments, so both packages replay the same orders.
"""

from __future__ import annotations

import hashlib

_KEY_BYTES = 8
_KEY_MASK = (1 << (8 * _KEY_BYTES)) - 1


def fold_in(key, data):
    """A child key of ``key`` and ``data``: the first 8 bytes of
    ``blake2b(key_bytes || repr(data))``. ``data`` is anything with a
    stable ``repr`` (ints, strings, tuples of those); ``key`` is reduced
    mod 2**64 first, so any integer seed derives an order."""
    h = hashlib.blake2b(digest_size=_KEY_BYTES)
    h.update((int(key) & _KEY_MASK).to_bytes(_KEY_BYTES, "big", signed=False))
    h.update(repr(data).encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


def piece_key(seed, epoch, piece):
    """The sort key of one piece in one epoch: ``fold_in(fold_in(seed,
    ("epoch", epoch)), ("piece", piece))``."""
    return fold_in(fold_in(int(seed), ("epoch", int(epoch))), ("piece", int(piece)))


def piece_order(seed, epoch, pieces):
    """The epoch's order of ``pieces``: ascending for ``seed=None``, else
    sorted by their seed-tree keys (ties by the piece). Subset-stable: the
    order of a subset is the restriction of the order of the whole."""
    pieces = [int(p) for p in pieces]
    if seed is None:
        return sorted(pieces)
    return sorted(pieces, key=lambda p: (piece_key(seed, epoch, p), p))


def permutation(key, n):
    """A permutation of ``range(n)`` derived from the seed-tree node
    ``key``: ordinal ``i`` sorts by ``fold_in(key, ("ordinal", i))``."""
    return sorted(range(int(n)), key=lambda i: (fold_in(key, ("ordinal", i)), i))


def batch_permutation(seed, epoch, piece, n):
    """The order of one piece's ``n`` batches in one epoch, keyed off the
    piece's own leaf; ``seed=None`` is the identity."""
    if seed is None:
        return list(range(int(n)))
    return permutation(piece_key(seed, epoch, piece), n)
