#!/usr/bin/env python3
"""Smoke test of petastorm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and nothing else
of the network or disk beyond the checkout and a temporary directory.

Phases, one line of output each (a phase that fails stops the run with a
non-zero exit code):

1. ``env``: the card's name and power limit, torch / CUDA / nvcc versions,
   whether Triton and CUTLASS headers are present; then the build of the
   three flash-attention kernels (``petastorm_tpu_torch/ops/csrc``) and its
   seconds.
2. ``kernels``: every kernel against its plain PyTorch version on the card,
   at the attention benchmark's shape (B=2, H=4, D=128, T=4096: causal +
   segment ids f32, causal bf16, causal GQA with 2 K/V heads, kv_lengths)
   and at the LM's shape (B=4, T=128, H=4, D=16). Then, on causal +
   segment ids f32 cases at both shapes, each kernel's device time (CUDA
   events around calls queued back to back behind a spin kernel, so the card
   never waits on the host; see ``cuda_ms``) and the host time of its
   wrapper, its plain version's time, the bound (the larger of bytes over
   3.35 TB/s and the visible-pair operations over the card's f32 peak) and ``torch.nn.functional.scaled_dot_product_attention`` on the
   same inputs as a yardstick (the port never calls it).
3. ``train``: the packed long-context LM at its full configuration (d_model
   64, 4 heads, 2 layers, vocab 64, slot_len 128, 4 slots, f32) for 12 SGD
   steps from a generated Parquet corpus: every batch arrives on the card,
   the loss is finite and falls, all three kernels were launched on this
   path, and flash logits match the dense oracle on the last batch.

The last three lines are the kernels' JSON record (times at the LM's
shape, the shape the training path launches them at), the ``nvidia-smi`` name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BENCH = dict(B=2, T=4096, H=4, D=128)  # the attention benchmark's flash shape
LM = dict(B=4, T=128, H=4, D=16)       # one LM layer's attention shape
F32_FWD_ABS, F32_GRAD_REL, BF16_GRAD_REL = 1e-4, 1e-3, 1e-2
# bf16 outputs: kernel and plain version round f32 results that agree to
# ~1e-6 to bf16, so they may differ by one bf16 step, at most 2^-7 of the
# larger magnitude (plus 1e-5 absolute near zero).
BF16_STEP, BF16_ABS = 2.0 ** -7, 1e-5
PARITY_TOL = 2e-4
HBM_BYTES_PER_S = 3.35e12
F32_PEAK_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
TRAIN_STEPS = 12
SPIN_CYCLES_PER_S = 2.0e9  # above the H100's top SM clock: spins last at least as asked
SPIN_SHORT = {}  # label -> timing batches whose spin ended before the last call was queued


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def sh(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    return (out.stdout or out.stderr).strip()


def cuda_ms(label, fn, calls, batches=3):
    """``(device ms, host ms)`` of one ``fn()`` on the current stream.

    The host's time to queue ``calls`` calls is measured first (after one
    warm-up call): that is the host ms per call, the wrapper's checks,
    allocations and launch. Then, per batch, a spin kernel holds the stream
    for twice that time, the ``calls`` calls are queued behind it between two
    CUDA events, and the events' span over ``calls`` is the device time per
    call: the card runs them back to back and never waits on the host. The
    device ms is the median over ``batches``. A batch whose spin had ended
    before the host queued its last call is run again with twice the spin
    (up to 4 times); ``label`` and the batches still short then go into
    ``SPIN_SHORT``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s, retries, times = 2 * host_s + 1e-3, 0, []
    while len(times) < batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        short = start.query()
        torch.cuda.synchronize()
        if short and retries < 4:
            spin_s, retries = 2 * spin_s, retries + 1
            continue
        if short:
            SPIN_SHORT[label] = SPIN_SHORT.get(label, 0) + 1
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), host_s * 1e3 / calls


def make_case(B, T, H, D, dtype, Hkv=None, seg=False, lens=False, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    Hkv = Hkv or H

    def rnd(h):
        return torch.randn(B, T, h, D, device="cuda", generator=g).to(dtype)

    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    kw = dict(causal=True, causal_offset=0, kv_lengths=None, q_seg=None,
              kv_seg=None)
    if seg:
        ids = torch.randint(0, 8, (B, T), device="cuda", generator=g)
        kw["q_seg"] = kw["kv_seg"] = torch.sort(ids, dim=1).values.int().contiguous()
    if lens:
        kw["causal"] = False
        kw["kv_lengths"] = torch.randint(T // 4, T + 1, (B,), device="cuda",
                                         generator=g).int()
    return (q, k, v, do), kw


def check_case(name, tensors, kw):
    """Run all three kernels and their plain versions on the same inputs;
    return the error line and each kernel's max absolute error, and raise on
    a tolerance miss: the forward absolute in f32 and within one bf16 step
    elementwise in bf16 (``fwd_steps`` ≤ 1); lse absolute (it is f32 for
    both dtypes); gradients relative to the largest gradient."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = tensors
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw)
    torch.cuda.synchronize()
    bf16 = q.dtype == torch.bfloat16
    abs_err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    errs = {"fwd": abs_err(o, o_p)}
    max_abs = {"fwd": errs["fwd"], "dq": abs_err(dq, dq_p),
               "dkv": max(abs_err(dk, dk_p), abs_err(dv, dv_p))}
    finite = torch.isfinite(lse_p)
    if not torch.equal(finite, torch.isfinite(lse)):
        raise AssertionError(f"{name}: lse empty-row pattern differs")
    errs["lse"] = (lse[finite] - lse_p[finite]).abs().max().item()
    for key, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        scale = want.float().abs().max().item() or 1.0
        errs[key] = abs_err(got, want) / scale
    limits = {"fwd": F32_FWD_ABS, "lse": F32_FWD_ABS}
    if bf16:
        del errs["fwd"]
        g, w = o.float(), o_p.float()
        errs["fwd_steps"] = ((g - w).abs() / (
            BF16_STEP * torch.maximum(g.abs(), w.abs()) + BF16_ABS)).max().item()
        limits["fwd_steps"] = 1.0
    limits.update({g: BF16_GRAD_REL if bf16 else F32_GRAD_REL
                   for g in ("dq", "dk", "dv")})
    for key, err in errs.items():
        if not err <= limits[key]:
            raise AssertionError(
                f"{name}: {key} error {err:.3e} above {limits[key]:.0e}")
    return name + " " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()), max_abs


def visible_pairs(kw, B, T, H):
    """Visible (query, key) pairs of this run's masks, over all heads."""
    import torch

    rows = torch.arange(T, device="cuda")
    total = 0
    for b in range(B):
        for r0 in range(0, T, 1024):
            r = rows[r0:r0 + 1024]
            ok = rows[None, :] <= r[:, None] if kw["causal"] else \
                torch.ones(len(r), T, dtype=torch.bool, device="cuda")
            if kw["q_seg"] is not None:
                ok = ok & (kw["q_seg"][b, r0:r0 + 1024, None]
                           == kw["kv_seg"][b, None, :])
            if kw["kv_lengths"] is not None:
                ok = ok & (rows[None, :] < kw["kv_lengths"][b])
            total += int(ok.sum())
    return total * H


def measure(shape):
    """Times and bounds of the three kernels on a causal + segment-ids f32
    case of ``shape``."""
    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch.ops import flash_attention as fa

    B, T, H, D = shape["B"], shape["T"], shape["H"], shape["D"]
    (q, k, v, do), kw = make_case(B, T, H, D, torch.float32, seg=True, seed=1)
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    _, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    _, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, **kw)

    calls = 50 if T <= 1024 else 10  # kernel calls per timing batch
    tag = f"T={T}"
    times = {
        "fwd": (cuda_ms(f"fwd {tag}", lambda: fa.flash_forward_kernel(q, k, v, **kw),
                        calls),
                cuda_ms(f"fwd plain {tag}",
                        lambda: fa.flash_forward_plain(q, k, v, **kw), 3)),
        "dq": (cuda_ms(f"dq {tag}",
                       lambda: fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw), calls),
               cuda_ms(f"dq plain {tag}",
                       lambda: fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, **kw), 3)),
        "dkv": (cuda_ms(f"dkv {tag}",
                        lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw),
                        calls),
                cuda_ms(f"dkv plain {tag}",
                        lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw),
                        3)),
    }

    # Yardstick: SDPA on the same inputs with the same mask (materialized
    # once, outside the timing). Its backward yields dq, dk, dv together.
    mask = (torch.ones(T, T, dtype=torch.bool, device="cuda").tril()[None]
            & (kw["q_seg"][:, :, None] == kw["kv_seg"][:, None, :]))[:, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_fwd, _ = cuda_ms(
        f"sdpa fwd {tag}",
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), calls)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)
    sdpa_bwd, _ = cuda_ms(f"sdpa bwd {tag}",
                          lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                      retain_graph=True), calls)

    pairs = visible_pairs(kw, B, T, H)
    elt = 4
    act = B * T * H * D * elt      # one [B, T, H, D] f32 tensor
    row = B * H * T * 4            # one f32 per (b, h, row): lse or delta
    seg = 2 * B * T * 4
    work = {  # (bytes each input read once / each output written once, FLOPs)
        "fwd": (3 * act + act + row + seg, 4 * D * pairs),
        "dq": (5 * act + row + act + row + seg, 6 * D * pairs),
        "dkv": (4 * act + 2 * row + 2 * act + seg, 8 * D * pairs),
    }
    out = {}
    for name, ((ms, host_ms), (plain_ms, _)) in times.items():
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_PEAK_FLOPS * 1e3
        out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations",
                     "library_ms": sdpa_fwd if name == "fwd" else None}
    return out, sdpa_bwd, pairs


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "petastorm_tpu_torch", "ops", "csrc")):
        fail(f"{REPO} holds no petastorm_tpu_torch package: run this script "
             "from the root of a checkout")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from petastorm_tpu_torch.models.long_context_lm import generate_corpus, train_lm
    from petastorm_tpu_torch.ops import _build
    from petastorm_tpu_torch.ops import flash_attention as fa

    # -- 1. env ------------------------------------------------------------
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    try:
        nvcc = _build.find_nvcc()
        nvcc_version = sh([nvcc, "--version"]).splitlines()[-1]
    except RuntimeError as exc:
        fail(str(exc))
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    cutlass = os.path.isdir("/usr/local/cutlass/include/cutlass")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"env: gpu={smi!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"nvcc={nvcc_version!r} triton={triton_version} cutlass_headers={cutlass} "
          f"kernels_built_in_s={build_s:.2f}", flush=True)

    # -- 2. kernels ----------------------------------------------------------
    B, T, H, D = BENCH["B"], BENCH["T"], BENCH["H"], BENCH["D"]
    cases = [
        ("bench causal+seg f32", make_case(B, T, H, D, torch.float32, seg=True)),
        ("bench causal bf16", make_case(B, T, H, D, torch.bfloat16)),
        ("bench causal gqa(hkv=2) f32", make_case(B, T, H, D, torch.float32, Hkv=2)),
        ("bench kv_lengths f32", make_case(B, T, H, D, torch.float32, lens=True)),
        ("lm D=16 causal+seg f32", make_case(LM["B"], LM["T"], LM["H"], LM["D"],
                                             torch.float32, seg=True)),
    ]
    checked = [check_case(name, tensors, kw) for name, (tensors, kw) in cases]
    errs = [line for line, _ in checked]
    max_err = checked[-1][1]  # the main path's shape: the LM case
    del cases
    timed = {}
    for label, shape in (("lm", LM), ("bench", BENCH)):
        timing, sdpa_bwd_ms, pairs = measure(shape)
        timed[label] = timing
        errs.append(
            f"| {label} causal+seg f32 {shape}: "
            + "; ".join(f"{n} ms={t['ms']:.4f} host_ms={t['host_ms']:.4f} "
                        f"plain_ms={t['plain_ms']:.4f} "
                        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})"
                        for n, t in timing.items())
            + f"; sdpa fwd ms={timing['fwd']['library_ms']:.4f} "
            f"sdpa bwd (dq+dk+dv) ms={sdpa_bwd_ms:.4f}; visible pairs={pairs}")
    errs.append(f"| timing batches still short of spin: {SPIN_SHORT}")
    print("kernels: " + "; ".join(errs), flush=True)

    # -- 3. train ------------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        url = f"file://{tmp}/corpus"
        generate_corpus(url)
        fa.reset_launch_counts()
        result = train_lm(url, slot_len=128, slots=4, steps=TRAIN_STEPS,
                          num_heads=4, d_model=64, epochs=8, device="cuda")
        launches = dict(fa.LAUNCHES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = result["losses"]
    if len(losses) < TRAIN_STEPS:
        fail(f"trained {len(losses)} steps, expected {TRAIN_STEPS}")
    if result["batch_devices"] != ["cuda:0"]:
        fail(f"loader batches arrived on {result['batch_devices']}, not the card")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"loss not finite and falling: {losses}")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the training path: {launches}")
    if not result["logit_parity"] <= PARITY_TOL:
        fail(f"flash vs dense logits differ by {result['logit_parity']:.3e}")
    diag = result["diagnostics"]
    print(f"train: steps={len(losses)} losses={[round(x, 4) for x in losses]} "
          f"steps_per_s={result['steps_per_s']:.2f} "
          f"input_stall_pct={diag['input_stall_pct']} h2d_bytes={diag['h2d_bytes']} "
          f"peak_mem_mb={result['peak_memory_bytes'] / 2**20:.1f} "
          f"logit_parity={result['logit_parity']:.2e} launches={launches}",
          flush=True)

    source = "petastorm_tpu_torch/ops/csrc/"
    replaces = {"fwd": "petastorm_tpu/ops/flash_attention.py:96",
                "dq": "petastorm_tpu/ops/flash_attention.py:522",
                "dkv": "petastorm_tpu/ops/flash_attention.py:593"}
    files = {"fwd": "flash_fwd.cu", "dq": "flash_bwd_dq.cu", "dkv": "flash_bwd_dkv.cu"}
    record = {"kernels": [
        {"name": f"flash_{name}", "route": "cuda", "source": source + files[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max_err[name], **timed["lm"][name]}
        for name in ("fwd", "dq", "dkv")]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
