"""What the tabular loader must deliver, worked out from the store's rows.

The store's row groups hold a whole number of batches, and the loader
re-slices whole row groups in store order, so every delivered batch is
``batch`` consecutive rows that start at a multiple of ``batch``.
:func:`check_batches` finds each delivered batch's start from its first
row and compares every value of every row.
"""

from __future__ import annotations

import numpy as np


def _row_key(label, dense, cat):
    return (int(label), np.asarray(dense, np.float32).tobytes(),
            np.asarray(cat, np.int64).tobytes())


def check_batches(label, dense, cat, delivered, batch):
    """``delivered``: ``(label [B], dense [B, 13], cat [B, 26])`` numpy
    batches. Returns ``(mismatched rows, starts)``, ``starts[k]`` the store
    row where batch ``k`` begins (None where it matches no start)."""
    index = {_row_key(label[s], dense[s], cat[s]): s for s in range(0, len(label), batch)}
    mismatches, starts = 0, []
    for lab, den, ids in delivered:
        start = index.get(_row_key(lab[0], den[0], ids[0]))
        if start is None or len(lab) != batch:
            mismatches += len(lab)
            starts.append(None)
            continue
        rows = slice(start, start + batch)
        bad = ((lab != label[rows]) | np.any(den != dense[rows], axis=1)
               | np.any(ids != cat[rows], axis=1))
        mismatches += int(bad.sum())
        starts.append(start)
    return mismatches, starts
