"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: ``petastorm_tpu_torch`` begins with ``petastorm_tpu``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "petastorm_tpu"}

_RUN_CELL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import runner
result, code = runner.run_cell({bench!r}, {cell!r}, 2**31 + 5, 0.5, True, device="cpu")
print(json.dumps({{"code": code, "correct": result and result["correct"],
                   "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("cell", ["lm-longdoc-8k", "dlrm-criteo-b8192"])
def test_a_run_loads_no_jax(tiny_root, cell):
    out = subprocess.run([sys.executable, "-c", _RUN_CELL.format(root=ROOT, bench=tiny_root,
                                                                 cell=cell)],
                         capture_output=True, text=True, timeout=600, env=_clean_env(),
                         cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["code"] == 0 and line["correct"] is True
    assert "petastorm_tpu_torch" in line["modules"]
    assert not FORBIDDEN.intersection(line["modules"])


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_the_harness_sources_import_no_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "perfbench")):
        for name in files:
            if name.endswith(".py"):
                tops = _imported_tops(os.path.join(dirpath, name))
                assert not FORBIDDEN.intersection(tops), (name, tops)


def test_the_reference_imports_nothing_of_the_program():
    reference = os.path.join(ROOT, "perfbench", "reference")
    for name in os.listdir(reference):
        if name.endswith(".py"):
            tops = _imported_tops(os.path.join(reference, name))
            assert "petastorm_tpu_torch" not in tops, name
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.lm, perfbench.reference.dlrm, "
            "perfbench.reference.packing, perfbench.reference.rows, "
            "perfbench.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=_clean_env())
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "petastorm_tpu_torch" not in tops and not FORBIDDEN.intersection(tops)


def test_a_run_refuses_to_print_after_jax_loaded(tiny_root, monkeypatch):
    from perfbench import runner

    monkeypatch.setattr(runner, "forbidden_loaded", lambda: ["jax"])
    result, code = runner.run_cell(tiny_root, "dlrm-criteo-b8192", 9, 0.3, False, device="cpu")
    assert result is None and code != 0
