"""``correct`` must come out false when the timed path is broken, and the
control (the reference in the precision below the stated one) must read
worse than the program. On the CPU the harness's look for a card is
skipped and the rest of a run is driven at a tiny size; the control's test
marked ``cuda`` runs at the cells' own sizes on the card."""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench import calibrate, runner
from perfbench.tests.conftest import ROOT

CELLS = ["lm-longdoc-8k", "dlrm-criteo-b8192"]


def _unchanged_state(run):
    """A step that computes the loss and leaves every parameter as it was."""
    build = run.setup

    def setup():
        build()
        step = run.train_step

        def frozen(*args):
            saved = [p.detach().clone() for p in run.leaves.values()]
            loss = step(*args)
            with torch.no_grad():
                for p, s in zip(run.leaves.values(), saved):
                    p.copy_(s)
            return loss

        run.train_step = frozen

    run.setup = setup


def _half_batch(run):
    """A step on the first half of the batch alone, its mean over that half."""
    build = run.setup

    def setup():
        build()
        step = run.train_step

        def half(*args):
            n = args[0].shape[0] // 2
            return step(*(a[:n] for a in args))

        run.train_step = half

    run.setup = setup


def _altered_token(run):
    """One value of every delivered batch altered where the loader produces it."""
    build = run.setup

    def setup():
        build()
        loader = run.loader
        iterate = loader._iterate

        def altered():
            for batch in iterate():
                key = "tokens" if "tokens" in batch else "cat_3"
                col = batch[key].clone()
                col.view(-1)[1] += 1
                batch[key] = col
                yield batch

        loader._iterate = altered

    run.setup = setup


#: Each fault and a number that must catch it.
FAULTS = {"unchanged_state": (_unchanged_state, "change_norm_gap"),
          "half_batch": (_half_batch, "grad_norm_gap"),
          "altered_token": (_altered_token, "data_mismatches")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    plant, catcher = FAULTS[fault]
    result, code = runner.run_cell(tiny_root, cell, 2**31 + 11, 0.3, False, device="cpu",
                                   patch=plant)
    assert code == 0
    assert result["correct"] is False, result["checks"]
    check = result["checks"][catcher]
    assert check["value"] is None or check["value"] > check["limit"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    result, code = runner.run_cell(tiny_root, cell, 2**31 + 11, 0.3, False, device="cpu")
    assert code == 0 and result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_worse_than_the_program(tiny_root, cell, capsys):
    line = calibrate.readings(tiny_root, cell, 2**31 + 13, control=True, device="cpu")
    program = max(line[k] for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"))
    control = max(line[f"control.{k}"] for k in ("loss_gap", "grad_norm_gap",
                                                  "change_norm_gap"))
    assert control >= 3 * max(program, 1e-9), line
    assert line["half_batch.grad_norm_gap"] >= 100 * max(program, 1e-9), line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits_on_the_card(cuda_device, cell, capsys):
    """At the cell's own size, on three seeds: the program passes every
    limit and the control fails at least one."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entry = next(c for c in spec["workloads"] if c["name"] == cell)
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, config["file"])) as f:
        limits = json.load(f)["limits"]
    for seed in (8000000001, 8000000002, 8000000003):
        line = calibrate.readings(ROOT, cell, seed, control=True, device=str(cuda_device))
        assert all(line[k] <= v for k, v in limits.items()), line
        model = {k: v for k, v in limits.items() if k != "data_mismatches"}
        assert any(line[f"control.{k}"] > v for k, v in model.items()), line
