"""What the LM's loader must deliver, worked out from the store's documents.

The store holds documents in row groups of ``docs_per_row_group``; the
reader hands over whole row groups, each in store order, in an order of
its own. First-fit packing (the documented rule) then places each
document, in arrival order, into the first slot of the open batch with
room, and emits the batch when none has room. Padding carries token 0,
position 0 and segment id -1; a document's positions count from 0 and its
segment id is its index among its slot's documents.

:func:`check_stream` identifies every delivered document in the store,
rebuilds the arrival order (row groups whole, in store order within),
packs that order again and compares the result with what was delivered,
so an altered token, a dropped, repeated or reordered document, and a
wrong position or segment id all count as mismatches.
"""

from __future__ import annotations

import numpy as np

_KEY_TOKENS = 8


def _key(tokens):
    return (len(tokens),) + tuple(int(x) for x in tokens[:_KEY_TOKENS])


def first_fit(docs, slots, slot_len):
    """``docs`` (token arrays, arrival order) → list of
    ``(tokens, positions, segment_ids)`` int32 ``[slots, slot_len]``."""
    batches = []
    state = None

    def fresh():
        return {"tok": np.zeros((slots, slot_len), np.int32),
                "pos": np.zeros((slots, slot_len), np.int32),
                "seg": np.full((slots, slot_len), -1, np.int32),
                "used": [0] * slots, "count": [0] * slots}

    for doc in docs:
        length = len(doc)
        if length == 0:
            continue
        if length > slot_len:
            raise ValueError(f"a document of {length} tokens exceeds the slot")
        if state is None:
            state = fresh()
        fit = [b for b in range(slots) if state["used"][b] + length <= slot_len]
        if not fit:
            batches.append((state["tok"], state["pos"], state["seg"]))
            state = fresh()
            fit = [0]
        b, start = fit[0], state["used"][fit[0]]
        state["tok"][b, start:start + length] = doc
        state["pos"][b, start:start + length] = np.arange(length)
        state["seg"][b, start:start + length] = state["count"][b]
        state["used"][b] += length
        state["count"][b] += 1
    if state is not None:
        batches.append((state["tok"], state["pos"], state["seg"]))
    return batches


def _segments(tokens, seg):
    """The delivered documents of one batch, slot by slot, each as
    ``(slot, start, tokens)``, and the count of malformed slots (segment
    ids not 0, 1, ... in contiguous runs followed by padding)."""
    out, malformed = [], 0
    for b in range(seg.shape[0]):
        row = seg[b]
        expect, t = 0, 0
        while t < row.size and row[t] >= 0:
            if row[t] != expect:
                malformed += 1
                break
            end = t
            while end < row.size and row[end] == expect:
                end += 1
            out.append((b, t, tokens[b, t:end]))
            expect, t = expect + 1, end
        if np.any(row[t:] >= 0):
            malformed += 1
    return out, malformed


def check_stream(docs, docs_per_row_group, delivered, slots, slot_len):
    """Compare ``delivered`` (``(tokens, positions, segment_ids)`` numpy
    batches in delivery order, from the first batch the loader gave) with
    the store's ``docs``. Returns ``(mismatches, expected)``: the number of
    positions, documents and slots that differ, and the batches the
    reference packs (None when the arrival order cannot be rebuilt)."""
    index = {_key(doc): i for i, doc in enumerate(docs)}
    mismatches, per_batch = 0, []
    for tokens, _, seg in delivered:
        found, malformed = _segments(tokens, seg)
        mismatches += malformed
        ids = []
        for _, _, toks in found:
            i = index.get(_key(toks))
            if i is None or not np.array_equal(docs[i], toks):
                mismatches += len(toks)
                continue
            ids.append(i)
        per_batch.append(ids)
    # Arrival order: row groups whole and in store order, one after another
    # (a group may follow itself across an epoch boundary), so within a
    # batch the documents continuing the open group come first.
    def group_size(group):
        return min(docs_per_row_group, len(docs) - group * docs_per_row_group)

    order, current, last = [], None, -1
    for ids in per_batch:
        left = sorted(ids)
        while left:
            open_group = current is not None and last + 1 < group_size(current)
            if open_group and current * docs_per_row_group + last + 1 in left:
                pick = current * docs_per_row_group + last + 1
            else:
                # A new group starts at its first document, and only once the
                # open one is whole: anything else lost or reordered one.
                starts = [i for i in left if i % docs_per_row_group == 0]
                pick = starts[0] if starts else left[0]
                mismatches += int(not starts) + int(open_group)
            left.remove(pick)
            current, last = divmod(pick, docs_per_row_group)
            order.append(pick)
    expected = first_fit([docs[i] for i in order], slots, slot_len)
    if len(expected) < len(delivered):
        return mismatches + len(delivered) - len(expected), None
    for (et, ep, es), (dt, dp, ds) in zip(expected, delivered):
        mismatches += int(np.sum(et != dt) + np.sum(ep != dp) + np.sum(es != ds))
    return mismatches, expected[:len(delivered)]
