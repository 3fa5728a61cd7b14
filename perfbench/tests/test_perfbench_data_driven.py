"""A mix, a configuration and a metric are files found by name: a new cell
comes from new files and entries alone."""

from __future__ import annotations

import json
import os

from perfbench import runner

DUMMY_METRIC = '''"""Steps of the window (a dummy reader)."""


def read(ctx):
    return float(ctx.steps)
'''


def test_a_dummy_mix_and_metric_run_from_files_alone(tiny_root):
    before = {}
    for dirpath, _, files in os.walk(tiny_root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                before[path] = f.read()
    mix = os.path.join(tiny_root, "perfbench", "traffic", "dummy-short-docs.json")
    with open(os.path.join(tiny_root, "perfbench", "traffic", "longdoc-8k.json")) as f:
        params = json.load(f)
    params.update(median=12, min_len=4, max_len=32, docs=128)
    with open(mix, "w") as f:
        json.dump(params, f)
    with open(os.path.join(tiny_root, "perfbench", "metrics", "dummy_steps.py"), "w") as f:
        f.write(DUMMY_METRIC)
    # The entries a later change would add to BENCHMARK.json.
    spec_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "dummy-cell", "config": "capstone-lm-d2048",
                              "traffic": "dummy-short-docs", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"][0].setdefault("workloads", []).append("dummy-cell")
    spec["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "tokens_per_s", "workloads": ["dummy-cell"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    result, code = runner.run_cell(tiny_root, "dummy-cell", 2**31 + 3, 0.5, True, device="cpu")
    assert code == 0 and result["correct"] is True
    assert result["metrics"]["dummy_steps"]["value"] == result["attempted"] > 0
    assert "pack_fill_pct" not in result["metrics"]  # listed for its own cell only
    result, code = runner.run_cell(tiny_root, "dummy-cell", 2**31 + 3, 0.5, False, device="cpu")
    assert set(result["metrics"]) == {"tokens_per_s", "setup_s"}
    for path, data in before.items():
        if not path.endswith("BENCHMARK.json"):
            with open(path, "rb") as f:
                assert f.read() == data, path


def test_each_cell_reports_its_own_metrics():
    with open(os.path.join(os.path.dirname(__file__), "..", "..", "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in runner.cell_metrics(spec, cell, False)}
        layer = runner.cell_metrics(spec, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)
