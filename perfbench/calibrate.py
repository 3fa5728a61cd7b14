"""Read the numbers the correctness limits of a cell are set from.

``python -m perfbench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds 3,4,5]``

For every seed, in one process: the cell's set-up and checked steps,
exactly as a run makes them (no window), then the reference, and the
program's numbers against it (the lower readings). For each control seed
also the control, the reference computed in the precision below the one
the configuration states (its ``"control_precision"``), and the planted
fault of half of each batch left out, each against the float32 reference
(the upper readings). One JSON line a seed, then the largest and smallest
of each, on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile

from perfbench import compare
from perfbench.runner import cache_dirs, load_cell


def readings(root, workload, seed, control, device="cuda", out=sys.stdout):
    spec, cell, cfg, mix = load_cell(root, workload)
    cache_dirs(root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    trainer = importlib.import_module(f"perfbench.trainers.{cfg['trainer']}")
    generator = importlib.import_module(f"perfbench.generators.{mix['generator']}")
    workdir = tempfile.mkdtemp(prefix="perfbench-calibrate-")
    try:
        run = trainer.Cell(cfg, mix, seed, device, workdir, generator)
        run.setup()
        batches = iter(run.loader)
        try:
            run.checked_steps(batches)
        finally:
            batches.close()
            run.close()
        run.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        line = {"workload": workload, "seed": seed,
                "data_mismatches": float(run.data_check()[0])}
        ref = run.reference()
        line.update(compare.gaps(compare.Readings(*run.program), ref))
        if control:
            for name, (precision, fault) in {"control": (cfg["control_precision"], None),
                                             "half_batch": ("f32", "half_batch")}.items():
                other = run.reference(precision, fault)
                line.update({f"{name}.{k}": v for k, v in compare.gaps(other, ref).items()})
        print(json.dumps(line), file=out, flush=True)
        return line
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m perfbench.calibrate", description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--control-seeds", default="", help="comma-separated seeds")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    lines = [readings(os.getcwd(), args.workload, seed, seed in control)
             for seed in seeds + sorted(control - set(seeds))]
    keys = sorted({k for line in lines for k in line if k not in ("workload", "seed")})
    summary = {}
    for key in keys:
        values = [line[key] for line in lines if key in line]
        summary[key] = {"max": max(values), "min": min(values), "n": len(values)}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
