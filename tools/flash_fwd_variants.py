#!/usr/bin/env python3
"""Time the forward flash kernel against builds of its own source with its
build-time switches set (``flash_fwd.cu``'s ``PTT_FWD_*``) on one CUDA card:
K/V tiles of 64 keys, and two ablations that show where its time goes.

Run from the root of a checkout: ``python3 tools/flash_fwd_variants.py
[NAME ...]`` (default: every variant in ``VARIANTS``). Each variant is
compiled with ``nvcc`` (its ``ptxas`` registers and spills are printed), run
at ``chip_smoke.py``'s timed case (causal + sorted segment ids) at the LM and
bench shapes in f32 and at the bench shape in bf16, compared with the plain
version, and timed with ``chip_smoke.cuda_ms``. All variants are timed in
turns (a, b, ..., b, a). The card's name and power limit come first, then
the lines of ``tools/mma_sync_rate.cu`` (the card's mma.sync rates), then one
JSON line per variant. The ablations compute something else on purpose:
their errors are printed, not checked.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from petastorm_tpu_torch.ops import _build  # noqa: E402
from petastorm_tpu_torch.ops import flash_attention as fa  # noqa: E402

#: name -> flash_fwd.cu's build-time switches (``-D`` defines)
VARIANTS = {
    "kernel": (),
    "bk64": ("PTT_FWD_BK=64",),
    # Ablations.
    "one_pass": ("PTT_FWD_ONE_PASS=1",),               # products in plain TF32
    "no_segment_skip": ("PTT_FWD_NO_SEGMENT_SKIP=1",),  # every tile below the bound
}


def start_build(name, out_dir):
    """Start ``nvcc`` on variant ``name``; return ``(library path, process)``."""
    lib = os.path.join(out_dir, f"lib{name}.so")
    return lib, _build.compile_source("flash_fwd.cu", lib, defines=VARIANTS[name],
                                      flags=("-Xptxas", "-v"))


def finish_build(name, lib, proc):
    """Wait for a variant's build; return its ctypes ``ptt_flash_fwd`` and
    ptxas's registers and spills for each instantiation of the kernel."""
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{out}")
    ptxas, label = {}, None  # "f32 D=128" -> "171 registers ... | 0 bytes spill stores ..."
    for line in out.splitlines():
        m = re.search(r"flash_fwd_kernelI(\w+?)Li(\d+)E", line)
        if m and "Compiling entry function" in line:
            label = f"{'f32' if m.group(1) == 'f' else 'bf16'} D={m.group(2)}"
        elif label and ("spill" in line or "Used" in line):
            ptxas[label] = (ptxas.get(label, "") + " | " + line.split(":")[-1].strip()).strip(" |")
    return _build.load(lib, "ptt_flash_fwd"), ptxas


def mma_sync_rate(out_dir):
    """Build and run ``tools/mma_sync_rate.cu``; return its output lines."""
    exe = os.path.join(out_dir, "mma_sync_rate")
    src = os.path.join(REPO, "tools", "mma_sync_rate.cu")
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", exe, src], check=True, capture_output=True)
    return subprocess.run([exe], check=True, capture_output=True,
                          text=True).stdout.splitlines()


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]), flush=True)
    out_dir = tempfile.mkdtemp(prefix="fwd_variants_")
    procs = {}
    try:
        procs.update({name: start_build(name, out_dir) for name in names})  # in parallel
        for line in mma_sync_rate(out_dir):
            print(line, flush=True)
        built = {name: finish_build(name, *procs[name]) for name in names}
        cases = {}
        for label, shape, dtype in (("lm", chip_smoke.LM, torch.float32),
                                    ("bench", chip_smoke.BENCH, torch.float32),
                                    ("bench_bf16", chip_smoke.BENCH, torch.bfloat16)):
            (q, k, v, _), kw = chip_smoke.make_case(shape["B"], shape["T"], shape["H"],
                                                    shape["D"], dtype, seg=True, seed=1)
            o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
            cases[label] = (q, k, v, kw, o_p.float(), lse_p)
        results = {name: {} for name in names}
        for name in names + names[::-1]:
            fn = built[name][0]
            for label, (q, k, v, kw, o_p, lse_p) in cases.items():
                o, lse = chip_smoke.forward_with(fn, q, k, v, kw)
                torch.cuda.synchronize()
                fin = torch.isfinite(lse_p)
                err = max((o.float() - o_p).abs().max().item(),
                          (lse[fin] - lse_p[fin]).abs().max().item())
                ms, _ = chip_smoke.cuda_ms(
                    f"{name} {label}", lambda: chip_smoke.forward_with(fn, q, k, v, kw),
                    50 if label == "lm" else 10)
                entry = results[name].setdefault(label, {"max_abs_err": err, "ms": []})
                entry["ms"].append(ms)
        for name in names:
            print(json.dumps({"variant": name, "defines": VARIANTS[name],
                              "ptxas": built[name][1], **results[name]}), flush=True)
    finally:
        for _, proc in procs.values():
            proc.kill()  # a no-op once finish_build has waited for it
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
