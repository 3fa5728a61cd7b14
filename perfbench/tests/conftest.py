"""Fixtures of the benchmark's tests: a copy of the benchmark at a size the
CPU runs in seconds, and the card (decided inside a fixture, never at
import). Run them with ``python -m pytest perfbench/tests``; the tests
marked ``cuda`` run on the card: ``python -m pytest -m cuda perfbench/tests``."""

from __future__ import annotations

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Each configuration and mix cut to a tiny size: widths, depth, vocabulary,
#: rows and documents only; everything else is the cell's own file.
TINY = {
    "configs": {
        "capstone-lm-d2048": dict(d_model=64, num_heads=2, head_dim=32, num_layers=2,
                                  vocab_size=97, max_positions=128),
        "dlrm-criteo1tb": dict(embed_dim=16, table_rows=1000, bottom_hidden=32,
                               top_hidden=32, warm_steps=2),
    },
    "traffic": {
        "longdoc-8k": dict(median=40, min_len=8, max_len=128, docs=256,
                           docs_per_row_group=32, slot_len=128),
        "criteo-zipf-b8192": dict(rows=8192, rows_per_row_group=1024, files=2, batch=256),
    },
}


def make_tiny_root(dest):
    """A copy of the benchmark's data files under ``dest`` with the tiny
    sizes above: ``BENCHMARK.json``, the configurations, the mixes and the
    metric readers (the code is the package's own)."""
    for sub in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(dest, "perfbench", sub), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for entry in spec["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        cfg.update(TINY["configs"][entry["name"]])
        with open(os.path.join(dest, entry["file"]), "w") as f:
            json.dump(cfg, f)
    for cell in spec["workloads"]:
        name = cell["traffic"]
        with open(os.path.join(ROOT, "perfbench", "traffic", name + ".json")) as f:
            mix = json.load(f)
        mix.update(TINY["traffic"][name])
        with open(os.path.join(dest, "perfbench", "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    metrics = os.path.join(ROOT, "perfbench", "metrics")
    for name in os.listdir(metrics):
        if name.endswith(".py"):
            shutil.copy(os.path.join(metrics, name), os.path.join(dest, "perfbench", "metrics"))
    return str(dest)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "bench")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
