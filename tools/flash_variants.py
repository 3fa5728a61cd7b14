#!/usr/bin/env python3
"""Time the flash kernels against builds of their own sources with their
build-time switches set, on one CUDA card: the forward (``flash_fwd.cu``'s
``PTT_FWD_*``: K/V tiles of 64 keys, two ablations), the dQ kernel
(``flash_bwd_dq.cu``'s ``PTT_DQ_*``: K/V tiles of 32 keys, three ablations)
and the dK/dV kernel (``flash_bwd_dkv.cu``'s ``PTT_DKV_*``: Q tiles of 32
rows, three ablations).

Run from the root of a checkout: ``python3 tools/flash_variants.py [--parent
DIR] [NAME ...]`` (default: every variant in ``VARIANTS``). ``--parent DIR``
adds ``dq_parent`` and ``dkv_parent``: ``flash_bwd_dq.cu`` and
``flash_bwd_dkv.cu`` of the checkout at ``DIR`` (the same C interfaces, or
for dQ the one from before its ``dlse`` pointer, called with a null one),
timed in turns with the rest. Each variant is compiled with ``nvcc`` (its
``ptxas`` registers and spills are printed), run at ``chip_smoke.py``'s timed
case (causal + sorted segment ids) at the LM and bench shapes in f32 and at
the bench shape in bf16, and causal without segment ids at the bench shape
in f32 (every row or key then sums over up to 4,096 others, which shows how
errors grow with them), compared with the plain version (the largest
absolute error; for dQ and dK/dV relative to the largest gradient, as
``chip_smoke.py`` checks it, and for dQ also delta's absolute error), and
timed with ``chip_smoke.cuda_ms``. The backward variants take the forward
kernel's o and lse, and dK/dV the dQ kernel's delta, as the backward does.
All variants are timed in turns (a, b, ..., b, a).
The card's name and power limit come first, then the lines of
``tools/mma_sync_rate.cu`` (the card's mma.sync rates), then one JSON line
per variant. The ablations compute something else on purpose: their errors
are printed, not checked.
"""

from __future__ import annotations

import argparse
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

#: name -> (source in ops/csrc, its build-time switches as ``-D`` defines)
VARIANTS = {
    "fwd": ("flash_fwd.cu", ()),
    "fwd_bk64": ("flash_fwd.cu", ("PTT_FWD_BK=64",)),
    "fwd_one_pass": ("flash_fwd.cu", ("PTT_FWD_ONE_PASS=1",)),  # plain TF32
    "fwd_no_segment_skip": ("flash_fwd.cu", ("PTT_FWD_NO_SEGMENT_SKIP=1",)),
    "dq": ("flash_bwd_dq.cu", ()),
    "dq_bk32": ("flash_bwd_dq.cu", ("PTT_DQ_BK=32",)),
    "dq_one_pass": ("flash_bwd_dq.cu", ("PTT_DQ_ONE_PASS=1",)),  # plain TF32
    "dq_no_segment_skip": ("flash_bwd_dq.cu", ("PTT_DQ_NO_SEGMENT_SKIP=1",)),
    # dQ products added into the truncating mma accumulators
    "dq_acc_in_mma": ("flash_bwd_dq.cu", ("PTT_DQ_ACC_IN_MMA=1",)),
    "dkv": ("flash_bwd_dkv.cu", ()),
    "dkv_bq32": ("flash_bwd_dkv.cu", ("PTT_DKV_BQ=32",)),
    "dkv_one_pass": ("flash_bwd_dkv.cu", ("PTT_DKV_ONE_PASS=1",)),  # plain TF32
    "dkv_no_segment_skip": ("flash_bwd_dkv.cu", ("PTT_DKV_NO_SEGMENT_SKIP=1",)),
    # dK/dV products added into the truncating mma accumulators
    "dkv_acc_in_mma": ("flash_bwd_dkv.cu", ("PTT_DKV_ACC_IN_MMA=1",)),
}
SYMBOLS = {"flash_fwd.cu": "ptt_flash_fwd", "flash_bwd_dq.cu": "ptt_flash_bwd_dq",
           "flash_bwd_dkv.cu": "ptt_flash_bwd_dkv"}


def start_build(name, out_dir, variants):
    """Start ``nvcc`` on variant ``name``; return ``(library path, process)``."""
    src, defines, csrc = variants[name]
    lib = os.path.join(out_dir, f"lib{name}.so")
    return lib, _build.compile_source(src, lib, defines=defines, flags=("-Xptxas", "-v"),
                                      csrc=csrc)


def _without_dlse(fn):
    """A ``ptt_flash_bwd_dq`` of a checkout from before the ``dlse`` pointer
    (its interface has no 7th pointer), called with this checkout's
    arguments: the dlse pointer, which must be null, is dropped. Only a
    ``--parent`` older than that pointer needs this."""
    fn.argtypes = fn.argtypes[:6] + fn.argtypes[7:]

    def call(*args):
        if args[6] is not None:
            raise ValueError("this build of flash_bwd_dq.cu takes no dlse")
        return fn(*args[:6], *args[7:])
    return call


def finish_build(name, lib, proc, variants):
    """Wait for a variant's build; return its ctypes entry point and ptxas's
    registers and spills for each instantiation of the kernel."""
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{out}")
    ptxas, label = {}, None  # "f32 D=128" -> "171 registers ... | 0 bytes spill stores ..."
    for line in out.splitlines():
        m = re.search(r"flash_\w+?_kernelI(\w+?)Li(\d+)E", line)
        if m and "Compiling entry function" in line:
            label = f"{'f32' if m.group(1) == 'f' else 'bf16'} D={m.group(2)}"
        elif label and ("spill" in line or "Used" in line):
            ptxas[label] = (ptxas.get(label, "") + " | " + line.split(":")[-1].strip()).strip(" |")
    symbol = SYMBOLS[variants[name][0]]
    fn = _build.load(lib, symbol)
    if symbol == "ptt_flash_bwd_dq" and not _takes_dlse(variants[name][2]):
        return _without_dlse(fn), ptxas
    return fn, ptxas


def _takes_dlse(csrc):
    """Whether the ``flash_bwd_dq.cu`` under ``csrc`` has the dlse pointer."""
    with open(os.path.join(csrc, "flash_bwd_dq.cu")) as f:
        return "const void* dlse" in f.read()


def mma_sync_rate(out_dir):
    """Build and run ``tools/mma_sync_rate.cu``; return its output lines."""
    exe = os.path.join(out_dir, "mma_sync_rate")
    src = os.path.join(REPO, "tools", "mma_sync_rate.cu")
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", exe, src], check=True, capture_output=True)
    return subprocess.run([exe], check=True, capture_output=True,
                          text=True).stdout.splitlines()


def make_cases():
    """label -> (inputs, kw, plain forward (o, lse), the kernels' o, lse and
    delta, plain (dq, delta) and (dk, dv) from them)."""
    import torch

    cases = {}
    for label, shape, dtype, seg in (("lm", chip_smoke.LM, torch.float32, True),
                                     ("bench", chip_smoke.BENCH, torch.float32, True),
                                     ("bench_bf16", chip_smoke.BENCH, torch.bfloat16, True),
                                     ("bench_no_seg", chip_smoke.BENCH, torch.float32, None)):
        (q, k, v, do), kw = chip_smoke.make_case(shape["B"], shape["T"], shape["H"],
                                                 shape["D"], dtype, seg=seg, seed=1)
        o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
        o, lse = fa.flash_forward_kernel(q, k, v, **kw)
        _, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw)
        dq_p = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, **kw)
        dkv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        cases[label] = ((q, k, v, do), kw, (o_p.float(), lse_p), (o, lse, delta), dq_p, dkv_p)
    return cases


def rel_err(pairs):
    """The largest absolute error over ``(got, want)`` pairs, each relative
    to the largest magnitude of its ``want``."""
    return max((got.float() - want.float()).abs().max().item()
               / (want.float().abs().max().item() or 1.0) for got, want in pairs)


def run(src, fn, case):
    """One launch of ``fn`` (a build of ``src``) on ``case``; return
    ``(its errors against the plain version, a callable that launches it)``."""
    import torch

    (q, k, v, do), kw, (o_p, lse_p), (o, lse, delta), (dq_p, delta_p), (dk_p, dv_p) = case
    if src == "flash_fwd.cu":
        call = lambda: chip_smoke.forward_with(fn, q, k, v, kw)  # noqa: E731
        o_k, lse_k = call()
        torch.cuda.synchronize()
        fin = torch.isfinite(lse_p)
        return {"max_err": max((o_k.float() - o_p).abs().max().item(),
                               (lse_k[fin] - lse_p[fin]).abs().max().item())}, call
    if src == "flash_bwd_dq.cu":
        call = lambda: chip_smoke.dq_with(fn, q, k, v, o, lse, do, kw)  # noqa: E731
        dq, delta_k = call()
        torch.cuda.synchronize()
        return {"max_err": rel_err([(dq, dq_p)]),
                "delta_err": (delta_k - delta_p).abs().max().item()}, call
    call = lambda: chip_smoke.dkv_with(fn, q, k, v, do, lse, delta, kw)  # noqa: E731
    dk, dv = call()
    torch.cuda.synchronize()
    return {"max_err": rel_err([(dk, dk_p), (dv, dv_p)])}, call


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent",
                        help="root of another checkout: adds dq_parent and dkv_parent")
    parser.add_argument("names", nargs="*", help="variants to build and time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {name: (src, defines, _build.CSRC) for name, (src, defines) in VARIANTS.items()}
    if args.parent:
        parent_csrc = os.path.join(os.path.abspath(args.parent), "petastorm_tpu_torch", "ops",
                                   "csrc")
        variants["dq_parent"] = ("flash_bwd_dq.cu", (), parent_csrc)
        variants["dkv_parent"] = ("flash_bwd_dkv.cu", (), parent_csrc)
    names = args.names or list(variants)
    print(chip_smoke.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]), flush=True)
    out_dir = tempfile.mkdtemp(prefix="flash_variants_")
    procs = {}
    try:
        procs.update({name: start_build(name, out_dir, variants) for name in names})
        for line in mma_sync_rate(out_dir):
            print(line, flush=True)
        built = {name: finish_build(name, *procs[name], variants) for name in names}
        cases = make_cases()
        results = {name: {} for name in names}
        for name in names + names[::-1]:
            src, fn = variants[name][0], built[name][0]
            for label, case in cases.items():
                errs, call = run(src, fn, case)
                ms, _ = chip_smoke.cuda_ms(f"{name} {label}", call, 50 if label == "lm" else 10)
                entry = results[name].setdefault(label, {**errs, "ms": []})
                entry["ms"].append(ms)
        for name in names:
            print(json.dumps({"variant": name, "source": variants[name][0],
                              "defines": variants[name][1], "ptxas": built[name][1],
                              **results[name]}), flush=True)
        for name in names:  # a build against the same source of the --parent checkout
            parent = name + "_parent"
            if parent in built:
                src = variants[name][0]
                same = {label: all(torch.equal(a, b) for a, b in zip(
                    run(src, built[name][0], case)[1](), run(src, built[parent][0], case)[1]()))
                    for label, case in cases.items()}
                print(json.dumps({"bit_identical": f"{name} vs {parent}", **same}), flush=True)
        print(json.dumps({"timing batches still short of spin": chip_smoke.SPIN_SHORT}))
    finally:
        for _, proc in procs.values():
            proc.kill()  # a no-op once finish_build has waited for it
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
