"""Shuffle quality as one number (the port's own copy of
``petastorm_tpu/test_util/shuffling_analysis.py``), so tests can assert that
shuffling shuffles without pinning an exact order."""

from __future__ import annotations

import numpy as np


def compute_correlation_distance_metric(observed_ids):
    """Mean rank displacement of ``observed_ids`` (a permutation of
    distinct ids) from their sorted order, over ``n / 2``: near 0 for the
    source order, near 1 for a thorough shuffle."""
    observed = np.asarray(list(observed_ids))
    n = len(observed)
    if n < 2:
        return 0.0
    source_positions = {value: index for index, value in enumerate(sorted(observed))}
    displacement = np.abs(np.arange(n) - np.array([source_positions[v] for v in observed]))
    return float(displacement.mean() / (n / 2.0))
