"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything about a cell is found by name: the configuration is the file
its entry names, the traffic mix is ``perfbench/traffic/<mix>.json`` and
its ``"generator"`` names a module of :mod:`perfbench.generators`, the
configuration's ``"trainer"`` names a module of :mod:`perfbench.trainers`,
and each metric is read by ``perfbench/metrics/<metric>.py``.

A run: set-up (the store, the weights on the card, the loader, the
checked steps and the warm-up steps, all through the window's own calls),
then a closed-loop window of ``--seconds`` that opens and closes on a
synchronise, then the checks against the reference once the program's
state is freed. With ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "petastorm_tpu")


class RunContext:
    """What the metric readers read (times in seconds)."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)


def load_cell(root, workload):
    """``(spec, cell, config, mix)`` of ``workload`` under ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return spec, cell, config, mix


def cell_metrics(spec, cell, trace):
    """The metric entries this cell reports: end-to-end without a trace,
    per-layer with one, each where its ``workloads`` (all cells without
    that key) take in the cell."""
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if cell["name"] in m.get("workloads", (cell["name"],))]


def load_metric(root, name):
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    module_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def forbidden_loaded():
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def cache_dirs(root):
    """Point every build and kernel cache the program or torch could write
    at fixed directories inside the checkout (before torch is imported), so
    that only a checkout's first run builds."""
    base = os.path.join(os.path.abspath(root), "perfbench", "_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def run_cell(root, workload, seed, seconds, trace, device="cuda", t_start=None, patch=None):
    """One run. Returns the result dict (None when no result may be
    printed) and the exit code. ``device="cpu"`` and ``patch`` (called
    with the cell object before set-up) serve the tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, cfg, mix = load_cell(root, workload)
    cache_dirs(root)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: {workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None, 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = importlib.import_module(f"perfbench.trainers.{cfg['trainer']}")
    generator = importlib.import_module(f"perfbench.generators.{mix['generator']}")
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(root, spec, cell, cfg, mix, trainer, generator, workdir, seed, seconds,
                    trace, torch.device(device), t_start, patch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(root, spec, cell, cfg, mix, trainer, generator, workdir, seed, seconds, trace,
         device, t_start, patch):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    run = trainer.Cell(cfg, mix, seed, device, workdir, generator)
    if patch is not None:
        patch(run)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup()
    batches = iter(run.loader)
    try:
        run.checked_steps(batches)
        for _ in range(cfg["warm_steps"]):
            run.step(next(batches))
        _sync(torch, device)
        setup_s = time.perf_counter() - t_start

        # The window: closed loop, opened and closed on a synchronise.
        run.mark_window()
        cuda = device.type == "cuda"
        prof = None
        if trace:
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=activities)
            prof.__enter__()
        starts, host_starts, units, steps = [], [], None, 0
        with record_function("perfbench.window"):
            t0 = time.perf_counter()
            while True:
                with record_function("perfbench.next_batch"):
                    batch = next(batches)
                if cuda:
                    event = torch.cuda.Event(enable_timing=True)
                    event.record()
                    starts.append(event)
                host_starts.append(time.perf_counter())
                with record_function("perfbench.step"):
                    _, done = run.step(batch)
                batch = None
                units = done if units is None else units + done
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            with record_function("perfbench.sync"):
                _sync(torch, device)
            window_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        if cuda:
            marks = starts + [end]
            intervals_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            intervals_ms = list(np.diff(host_starts + [host_starts[0] + window_s]) * 1e3)
    finally:
        batches.close()
        run.close()
    units = int(units)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    summary = None
    if trace:
        from perfbench.trace import TraceSummary, load_events

        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        prof = None
        summary = TraceSummary(load_events(path), trainer.HOST_OPS)
        os.remove(path)

    # The reference, once the program's state is freed.
    run.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from perfbench.compare import judge

    t_check = time.perf_counter()
    values = run.check()
    print(f"perfbench reference and checks: {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct, checks = judge(values, cfg["limits"])
    leftover = forbidden_loaded()
    if leftover:
        print(f"perfbench: the run loaded {', '.join(leftover)}; no result", file=sys.stderr)
        return None, 3

    ctx = RunContext(setup_s=setup_s, window_s=window_s, steps=steps, units=units,
                     unit=trainer.UNIT, step_intervals_ms=intervals_ms,
                     trace=summary, work=run.work(), config=cfg, mix=mix,
                     power_limit=power_limit() if device.type == "cuda" else None)
    metrics = {}
    for entry in cell_metrics(spec, cell, trace):
        value = load_metric(root, entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": memory_peak,
               "power_limit": ctx.power_limit}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": steps, "failed": 0, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    for name, check in checks.items():
        print(f"perfbench check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    return result, 0


def main(argv=None, t_start=None):
    parser = argparse.ArgumentParser(prog="python -m perfbench", description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    result, code = run_cell(os.getcwd(), args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=t_start)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code

