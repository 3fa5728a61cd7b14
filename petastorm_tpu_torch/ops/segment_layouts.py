"""Segment-id layouts that would trip a tile-skipping attention kernel built
on sorted ids. ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
flash kernels against their plain versions on each of them."""

from __future__ import annotations

import numpy as np

SEGMENT_KINDS = ("unsorted", "tail_pad", "single_token", "one_segment", "mid_tile_edges")


def segment_ids(kind, B, T, seed=0):
    """``[B, T]`` int32 numpy segment ids of one of ``SEGMENT_KINDS``:
    random ids in any order; packed rows (sorted runs) whose tails the packer
    pads with -1; single-token segments (three in four; the others run 2 to 8
    tokens, so dQ and dK are not zero up to rounding, which a check relative
    to the largest gradient could not hold); one segment over all of T; runs
    of 1 to 149 tokens, so most edges fall inside a K tile."""
    rng = np.random.RandomState(seed)
    if kind == "unsorted":
        return rng.randint(0, 8, (B, T)).astype(np.int32)
    if kind == "tail_pad":
        ids = np.sort(rng.randint(0, 6, (B, T)), axis=1).astype(np.int32)
        for row in ids:
            row[T - rng.randint(1, T // 3 + 2):] = -1
        return ids
    if kind == "single_token":
        return np.stack([np.repeat(np.arange(T), np.where(rng.rand(T) < 0.75, 1,
                                                          rng.randint(2, 9, T)))[:T]
                         for _ in range(B)]).astype(np.int32)
    if kind == "one_segment":
        return np.zeros((B, T), np.int32)
    if kind == "mid_tile_edges":
        return np.stack([np.repeat(np.arange(T), rng.randint(1, 150, T))[:T]
                         for _ in range(B)]).astype(np.int32)
    raise ValueError(f"unknown segment id kind {kind!r}")
