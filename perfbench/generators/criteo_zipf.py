"""Criteo-shaped rows in a plain Parquet store: ``label`` (int32),
``dense_0..12`` (float32) and ``cat_0..25`` (int64).

The store is ``files`` files of whole row groups, snappy-compressed.
Each categorical column draws Zipf-distributed ranks over its table's
published cardinality (capped), spread over the id range by a
multiplicative hash. The run's seed draws every value; the sizes are the
mix's, the same for every seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_SPREAD = 0x9E3779B1


@dataclass
class TabularStore:
    url: str
    label: np.ndarray     # [N] int32
    dense: np.ndarray     # [N, num_dense] float32
    cat: np.ndarray       # [N, num_sparse] int64
    rows_per_row_group: int


def zipf_ids(gen, n, cardinality, exponent, device):
    """``n`` ids below ``cardinality``: ranks of a bounded power law of
    the given exponent (continuous inverse CDF in float64, floored),
    hashed."""
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    top = float(cardinality + 1) ** (1.0 - exponent)
    x = (1.0 - u * (1.0 - top)) ** (1.0 / (1.0 - exponent))
    rank = torch.clamp(torch.floor(x).long() - 1, 0, cardinality - 1)
    return (rank * _SPREAD) % cardinality


def make_rows(mix, seed, device="cpu"):
    """``(label [N] int32, dense [N, 13] float32, cat [N, 26] int64)`` as
    numpy arrays, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = mix["rows"]
    label = (torch.rand(n, generator=gen, device=device) < mix["click_rate"]).int()
    rate = torch.empty((n, mix["num_dense"]), dtype=torch.float64, device=device)
    counts = torch.floor(rate.exponential_(1.0 / mix["dense_count_scale"], generator=gen))
    dense = torch.log1p(counts).float()
    cards = [min(c, mix["max_ind_range"]) for c in mix["cardinalities"]]
    cat = torch.stack([zipf_ids(gen, n, card, mix["zipf_exponent"], device)
                       for card in cards], dim=1)
    return label.cpu().numpy(), dense.cpu().numpy(), cat.cpu().numpy()


def make_store(mix, cfg, seed, workdir, device="cpu"):
    """Write the rows under ``workdir``, ``files`` Parquet files written
    in parallel, and return them with the store."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    label, dense, cat = make_rows(mix, seed, device)
    path = os.path.join(os.path.abspath(workdir), "criteo")
    os.makedirs(path, exist_ok=True)
    per_file = len(label) // mix["files"]

    def write(i):
        rows = slice(i * per_file, (i + 1) * per_file)
        columns = {"label": label[rows]}
        columns.update({f"dense_{j}": dense[rows, j] for j in range(dense.shape[1])})
        columns.update({f"cat_{j}": cat[rows, j] for j in range(cat.shape[1])})
        pq.write_table(pa.table(columns), os.path.join(path, f"part-{i:05d}.parquet"),
                       row_group_size=mix["rows_per_row_group"], compression="snappy")

    with ThreadPoolExecutor(mix["files"]) as pool:
        list(pool.map(write, range(mix["files"])))
    return TabularStore("file://" + path, label, dense, cat, mix["rows_per_row_group"])
