"""Content fingerprints for decoded-batch cache keys (the port's own copy
of ``petastorm_tpu/cache_impl/fingerprint.py``: the same key for the same
ingredients, so both packages find each other's disk entries).

A cached batch sequence is reusable only when everything that shaped it
matches: the dataset, the row-group pieces read, the selected fields, the
batch size and last-batch policy, and any transform. The fingerprint
canonicalizes all of that into one hex digest; changing an ingredient
changes the key, so a stale entry is never found rather than served.

Keys are order-independent by contract: what is cached (decoded bytes in
canonical piece order) is kept apart from how it is served (a seed-tree
permutation composed at serve time, :mod:`petastorm_tpu_torch.service.
seedtree`). Shuffle seeds, epoch numbers and shuffle flags are refused as
ingredients (``_ORDER_DEPENDENT_KEYS``): epoch 1's fill must hit on every
later epoch, and jobs with different seeds must share one fill.
"""

from __future__ import annotations

import hashlib
import json

#: Bump when the cached entry layout changes: old entries become misses.
FINGERPRINT_VERSION = 1

#: ``extra`` key names (exact, case-insensitive) that name an
#: order-dependent ingredient. Exact names, not substrings: content-shaping
#: ingredients such as ``num_epochs`` (how many passes an entry holds) stay
#: usable.
_ORDER_DEPENDENT_KEYS = frozenset((
    "seed", "shuffle_seed", "shard_seed", "random_seed",
    "shuffle", "shuffle_row_groups", "shuffle_buffer_size",
    "epoch", "cache_epoch", "fill_epoch",
    "order", "item_order", "row_order", "piece_order", "serve_order",
))


def _reject_order_dependent(value, path="extra"):
    if isinstance(value, dict):
        for key, child in value.items():
            if str(key).lower() in _ORDER_DEPENDENT_KEYS:
                raise ValueError(
                    f"batch_fingerprint ingredient {path}[{key!r}] is "
                    f"order-dependent: cache keys must exclude "
                    f"serve-order inputs (seed, epoch, shuffle flags) — "
                    f"serve order is composed at serve time")
            _reject_order_dependent(child, f"{path}[{key!r}]")
    elif isinstance(value, (list, tuple)):
        for index, child in enumerate(value):
            _reject_order_dependent(child, f"{path}[{index}]")


def _canonical(value):
    """JSON-stable canonical form; other leaves fall back to ``repr``
    (transform specs, predicates, NGram objects)."""
    if isinstance(value, dict):
        return {str(k): _canonical(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_canonical(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def predicate_ingredient(predicate):
    """A row predicate's key ingredient: its wire dict where it has one
    (``ColumnPredicate.to_wire``, stable across processes), else its
    ``repr``."""
    if predicate is None:
        return None
    to_wire = getattr(predicate, "to_wire", None)
    if callable(to_wire):
        return to_wire()
    return repr(predicate)


def batch_fingerprint(dataset_url, pieces, batch_size, fields=None,
                      transform=None, factory=None, extra=None):
    """Hex digest keying a cached batch sequence.

    :param dataset_url: the dataset the batches were decoded from.
    :param pieces: piece identity: ``(path, row_group)`` pairs of a reader
        plan, or indices into the canonical row-group list.
    :param batch_size: rows per collated batch.
    :param fields: the selected fields (anything with a stable repr).
    :param transform: transform config (a TransformSpec or its repr).
    :param factory: which reader family decoded the batches.
    :param extra: further invalidation inputs (predicate, last-batch
        policy, ...); keys naming order-dependent ingredients are refused.
    """
    _reject_order_dependent(extra)
    payload = json.dumps({
        "v": FINGERPRINT_VERSION,
        "url": str(dataset_url),
        "pieces": _canonical(list(pieces)),
        "batch_size": int(batch_size),
        "fields": _canonical(fields),
        "transform": _canonical(transform),
        "factory": _canonical(getattr(factory, "__qualname__", factory)),
        "extra": _canonical(extra),
    }, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()
