#!/usr/bin/env python3
"""Smoke test of petastorm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and nothing else
of the network or disk beyond the checkout and a temporary directory.

Phases, one line of output each (a phase that fails stops the run with a
non-zero exit code):

1. ``env``: the card's name and power limit, torch / CUDA / nvcc versions,
   whether Triton and CUTLASS headers are present; then the build of the
   three flash-attention kernels (``petastorm_tpu_torch/ops/csrc``), and of
   the counting builds of the forward (``PTT_FWD_COUNT_TILES``), dQ
   (``PTT_DQ_COUNT_TILES``) and dK/dV (``PTT_DKV_COUNT_TILES``) kernels, all
   in parallel, and its seconds.
2. ``kernels``: every kernel against its plain PyTorch version on the card,
   at the attention benchmark's shape (B=2, H=4, D=128, T=4096: causal +
   segment ids f32, causal bf16, causal GQA with 2 K/V heads, kv_lengths),
   at the LM's shape (B=4, T=128, H=4, D=16), on segment ids built to trip
   a tile-skipping kernel (``segment_layouts``: unsorted, -1 padded tails,
   single-token segments, one segment over all of T, edges inside tiles) in
   f32 and bf16, at head dims 16, 32 and 64, at head dim 8 (run as 16,
   zero-padded), under strict causal (``causal_offset`` -1, the striped
   ring's blocks) and with an lse cotangent through the dQ kernel (at the
   ring's block shapes, D=16 and D=8, f32 and bf16; delta must equal
   ``rowsum(dout * o) - dlse`` on the kernel's own o), and at the shapes
   and dtypes the sequence trainers of phases 5 and 6 give the kernels
   (``trainer_cases``: 5-frame windows, ragged ``kv_lengths``, packed
   segment ids, and the sp = 2 ring's blocks of the last two). Head dims
   the kernels are not instantiated for are laid out as the autograd
   functions lay them out (``kernel_layout``). In every case the counting
   builds count on the card the K tiles the forward's and the dQ kernel's
   blocks load and the tiles their warps compute, and the Q tiles the dK/dV
   kernel's blocks load and the tiles its warps compute; these must equal
   ``visited_k_tiles``'s (with each kernel's tiles) and ``visited_q_tiles``'s
   (the plain mirrors of the skip rules), and each counting build's output
   must equal its kernel's bit for bit. Two launches of the dQ kernel must
   give bit-identical dq/delta, and two of the dK/dV kernel bit-identical
   dk/dv. Then, on causal +
   segment ids f32 cases at both shapes, each kernel's device time (CUDA
   events around calls queued back to back behind a spin kernel, so the card
   never waits on the host; see ``cuda_ms``) and the host time of its
   wrapper, its plain version's time, the bound (the larger of bytes over
   3.35 TB/s and the visible-pair operations over the card's f32-grade
   tensor-core rate, ``F32_TC_FLOPS``), the (query, key) pairs each kernel
   computed and the tiles it loaded (counted) beside the visible pairs, and
   ``torch.nn.functional.scaled_dot_product_attention`` on the same inputs
   as a yardstick (the port never calls it): its forward beside the
   forward, its backward beside dQ + dK/dV together.
3. ``train``: the packed long-context LM at its full configuration (d_model
   64, 4 heads, 2 layers, vocab 64, slot_len 128, 4 slots, f32) for
   ``TRAIN_STEPS`` SGD steps from a generated Parquet corpus: every batch
   arrives on the card, the loss is finite and falls, all three kernels
   were launched on this path, and flash logits match the dense oracle on
   the last batch. Reported: steps/s over every step, warm steps/s (from a
   sync at step 3 to a sync at the end) and the median host interval
   between warm steps, and the card's busy share in the warm window of a
   second, identical run traced by ``torch.profiler``.
4. ``image``: the row/image path at ``bench.py``'s image configuration
   (``IMAGE``: 1,536 rows of 64x64x3 uint8 png images with the benchmark's
   schema, row groups of 128, batch 128, 10 classes, conv 64, hidden 2048,
   SGD at lr 0.01, bf16 compute), labels made learnable (pixel mean set by
   the label plus seeded noise): ``make_reader`` (thread pool) →
   ``make_torch_dataloader(last_batch="pad", device_stage=DeviceStage(
   normalize=(127.5, 127.5), crop=(56, 56), flip=True))`` →
   ``train_image_classifier`` for 6 epochs, the first a warm-up (the
   reader may decode up to one epoch ahead of the loader, so the timed
   window is long enough to hold the decode rate, not that buffer). The crop
   makes the model's input 56x56, so dense1 takes 28*28*64 = 50,176
   features. Checked: the stage's card output for a fixed raw batch and
   step equals its CPU output bit for bit (f32 and bf16) and the numpy
   selection of its recorded draws; f32 logits on the card match the CPU
   module with the same weights within ``LOGIT_REL`` of the largest logit
   (TF32 off); every batch lands on ``cuda:0``; the loss is finite and its
   last epoch's mean is below its first's; the H2D bytes per row are the
   raw image's 12,288 plus the label's 4. Reported on the ``image:`` line:
   steady-state images/s and step ms (after the warm-up epoch), the model
   step alone on a resident batch (device ms and host ms per step, by
   ``cuda_ms``), the host's decode ceiling (the same reader and collation
   with no device, timed the same way), the stage's device ms per batch,
   the training loop's ms per step between batches (``consumer_s``), the
   card's busy share in the timed window of a second, identical run traced
   by ``torch.profiler`` (``device_busy_pct``) and that run's images/s,
   input stall, dispatch overlap, H2D bytes per image, peak memory and the
   codec.

5. ``seq``: the sequence-model family's three trainers
   (``models/sequence_training.py``: NGram windows of 5 frames, ragged
   causal with ``lengths``, packed causal with ``segment_ids``; d_model 32,
   4 heads, so head dim 8) for ``SEQ_STEPS`` steps each through the
   kernels: losses finite, the ragged and packed losses' last-quarter mean
   below their first-quarter mean, every kernel launched.
6. ``sp``: ``SP`` = 2 spawned ranks on the one card, in a gloo group over a
   ``FileStore``; the collectives stage CUDA tensors through pinned host
   memory (gloo takes host tensors only, and NCCL refuses two ranks on one
   device); the kernels run on the card in both ranks, built by the parent
   beforehand. Each rank checks, and fails the run on a miss: ring
   (striped and contiguous) and Ulysses attention with flash local blocks
   and segment ids against the dense oracle (outputs and q/k/v
   gradients, D=16 and D=8); the LM at its full configuration for 12
   steps at sp = 2 (loss falls, ring-vs-dense logit parity within
   ``PARITY_TOL``, parameter gradients equal to one process's); the
   sequence encoder at sp = 2, ring and Ulysses (gradients equal to one
   process's, then ragged training), and the packed trainer over the ring,
   the trainers with their default local attention (``"auto"``: the kernels
   for CUDA tensors), each run launching every kernel. The second line
   reports step times of this transport, not claims.

7. ``tabular``: the DLRM tabular path (``models/tabular_dlrm.py``) at the
   repo's own widths: the JAX tabular scenario's Criteo-shaped store
   (``TABULAR``: 40,000 rows, 8 day row groups of 5,000, 41 columns) →
   ``make_batch_reader`` → ``make_torch_dataloader`` → the DLRM at
   ``init_dlrm_params``' defaults (13 dense, 26 tables of 1024 x 16, hidden
   64, bf16 compute), batch 256, ``last_batch="drop"``, 2 epochs (312
   steps), SGD at lr 0.05. (a) A full scan and a ``filters=[("day", "=",
   3)]`` scan plan 8 and 1 row groups and read 40,000 and 5,000 rows. (b)
   The uninterrupted run: losses finite, the last quarter's mean below the
   first's, every batch on ``cuda:0``, every row trained twice bar the 128
   the final partial batch drops; warm steps/s and rows/s (steps 10 to the
   end), stall, peak memory, and the busy share of a traced second run.
   (c) Preempted at step 100 and checkpointed (``save_training_state``);
   every object dropped; ``restore_training_state`` gives the parameters
   bit for bit, and a fresh reader with ``resume_state`` finishes the run:
   every row trained at least twice over the two runs bar under 256 rows;
   re-read rows and the save and restore ms. (d) ``DP`` = 2 ranks on card 0
   (gloo, as phase 6), each reading its shard: the loader's derived
   ``max_batches`` equals ``global_step_count``, both ranks take exactly
   that many steps and end with bit-equal parameters; at f32 compute the
   first step's all-reduced gradients equal the mean of the two batches'
   one-process gradients within ``DP_GRAD_REL``; ``agree_max_batches``
   gives the minimum of two unequal counts; each rank's steps/s (transport
   on one card, not a claim). No flash kernel runs on this path (counted).
8. ``reader``: the petastorm reader API at the MNIST example's size
   (``READER``; see ``reader_phase``): a row-group index and a selector,
   the example's predicate / drop-partition / local-disk-cache path into
   its ``DataLoader`` and MLP for two epochs (the second all cache hits),
   the batch loaders on phase 7's store, and a seeded
   ``WeightedSamplingReader`` against its host replay.
9. ``loader``: the loader's own features on phase 4's store (``IMAGE``),
   after phase 8 in the same process. (a) ``bench.py``'s
   ``leg_cached_epochs`` on the card: ``make_columnar_reader`` (one
   worker) → ``make_torch_dataloader(batch_cache=BatchCache(1 GiB))``,
   two passes, unseeded and at ``shuffle_seed`` 7: the same rows both
   passes, every warm lookup a hit, the unseeded replay bit-equal in order,
   each seeded pass the canonical batches in the order
   ``permutation(fold_in(7, ("cache-epoch", k)), 12)`` by per-batch image
   digests; cold and warm images/s, the warm hit rate, the cache's bytes.
   (b) Phase 4's image path on a cached, producer-staged loader
   (``make_reader`` → ``make_torch_dataloader(last_batch="pad",
   device_stage, batch_cache=CacheConfig("mem+disk", 256 MiB, a directory),
   shuffle_seed=7, stage_in_producer=True, trace_path)``) training the
   full-width CNN for 6 passes, the first filling the cache: every batch
   on ``cuda:0``, losses finite and falling, 1 fill then 5 hits, the same
   labels every pass, a ``loader.device_put`` and a ``loader.wait`` span
   per batch of the last pass in the trace file; pass 1 and warm images/s,
   stall, dispatch overlap, consumer ms per step, the cache's ``stats()``,
   and the card's busy share in the warm passes of a second, identical run
   under ``torch.profiler``, beside phase 4's images/s from this call. (c)
   The first 12 batches with and without ``stage_in_producer``, at
   ``device_prefetch`` 1 and 4: bit-equal card tensors. (d) The seeded
   loader of (b) without the model, with one decode worker (so an
   uninterrupted run fills the same canonical order), and with a stage that draws nothing
   (normalize only: a resumed loader restarts the production ordinal the
   crop and flip draws follow), stopped after 5 batches of pass 3: a
   ``cache_replay`` state at cache epoch 2; a fresh cache on the same
   directory and a fresh reader with ``cache_resume`` serve the rest of
   pass 3 bit-equal to an uninterrupted run, from the disk tier, with no
   fill. No flash kernel runs on this path (counted).

Each phase's wall seconds are on the ``phases:`` line. The last three lines
are the kernels' JSON record (times at the LM's
shape, the shape the training path launches them at; ``backward`` is dQ +
dK/dV together beside SDPA's backward), the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
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
# f32-grade products on the H100 SXM's tensor cores: 495 TFLOP/s TF32 over
# the three passes (hi*hi + hi*lo + lo*hi) that keep f32 precision, as the
# reference's Precision.HIGHEST takes three MXU passes. The same yardstick
# for all three kernels, whatever each one runs on.
F32_TC_FLOPS = 495e12 / 3
TRAIN_STEPS = 40  # phase 3: enough warm steps for a median step time
SP_TRAIN_STEPS = 12  # the LM at sp = 2 in phase 6
SEQ_STEPS = 48  # steps of each sequence trainer: losses fall over quarters of the run
SP = 2  # sequence-parallel ranks of phase 6, all on card 0
SP_TIMEOUT_S = 600
# bench.py's image workload (bench.py:77-123): schema, rows, row groups,
# batch, classes and model width; the crop is the device stage's.
IMAGE = dict(rows=1536, rows_per_row_group=128, image_shape=(64, 64, 3), batch=128,
             classes=10, conv_features=64, hidden=2048, lr=0.01, crop=(56, 56), epochs=6)
# Phase 4 writes png, as bench.py does (the codec needs cv2 or Pillow).
IMAGE_CODEC = "png"
# f32 logits, card vs CPU: 50,176-term sums in another order (TF32 off).
LOGIT_REL = 1e-4
# The JAX tabular scenario's store (benchmark/scenarios.py:37-38) and the
# Criteo example's trainer (examples/criteo_dlrm/train_dlrm.py:40-78).
TABULAR = dict(rows=40_000, days=8, batch=256, epochs=2, interrupt_after=100)
DP = 2  # data-parallel ranks of phase 7, on card 0
# Phase 8: the MNIST example's path (examples/mnist/generate_petastorm_mnist.py,
# pytorch_example.py) at the size of MNIST's training split, and the batch
# loaders on phase 7's store.
READER = dict(rows=60_000, rows_per_row_group=200, seed=0, batch=64, shuffle=512, lr=0.01,
              epochs=2, split=[0.8, 0.2], drop_partitions=2, cache_bytes=512 * 2**20,
              selected_groups=10, tab_days=(2, 5), tab_batch=256, tab_shuffle=4096,
              inmem_epochs=3, dlrm_steps=20, mix=[0.75, 0.25], mix_draws=3000, warm_batches=10)
DP_GRAD_REL = 1e-6
# Phase 9: bench.py's leg_cached_epochs (bench.py:355-431: a 1 GiB memory
# cache, shuffle seed 7) and the image path through the cached,
# producer-staged loader (a 256 MiB memory tier over a disk tier).
LOADER = dict(leg_cache_bytes=1 << 30, seed=7, passes=6, mem_mb=256, stage_batches=12,
              stage_prefetch=(1, 4), resume_passes=2, resume_after=5)
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


def make_case(B, T, H, D, dtype, Hkv=None, seg=None, lens=False, seed=0):
    """Random ``(q, k, v, do)`` on the card and the kernels' keywords:
    causal unless ``lens``; ``seg`` True for sorted ids of 8 segments, or a
    ``segment_ids`` kind."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    Hkv = Hkv or H

    def rnd(h):
        return torch.randn(B, T, h, D, device="cuda", generator=g).to(dtype)

    from petastorm_tpu_torch.ops.segment_layouts import segment_ids

    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    kw = dict(causal=True, causal_offset=0, kv_lengths=None, q_seg=None,
              kv_seg=None)
    if seg is True:
        ids = torch.randint(0, 8, (B, T), device="cuda", generator=g)
        kw["q_seg"] = kw["kv_seg"] = torch.sort(ids, dim=1).values.int().contiguous()
    elif seg:
        kw["q_seg"] = kw["kv_seg"] = torch.tensor(segment_ids(seg, B, T, seed),
                                                  device="cuda")
    if lens:
        kw["causal"] = False
        kw["kv_lengths"] = torch.randint(T // 4, T + 1, (B,), device="cuda",
                                         generator=g).int()
    return (q, k, v, do), kw


def kernel_layout(case):
    """``case`` (``make_case``'s) laid out as the autograd functions give
    the kernels their inputs: zero-padded to an instantiated head dim
    (``pad_head_dim``; ``D=8`` runs as ``D=16``, instantiated head dims stay
    as they are) with the true head dim's scale among the keywords."""
    from petastorm_tpu_torch.ops import flash_attention as fa

    tensors, kw = case
    tensors, kw["scale"] = fa.pad_head_dim(*tensors)
    return tuple(tensors), kw


def forward_with(fn, q, k, v, kw):
    """``(o, lse)`` from one launch of ``fn``, the ``ptt_flash_fwd`` of
    another build of ``flash_fwd.cu``, with the arguments the wrapper passes.
    The wrapper's launch counts do not move."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0] * q.shape[2], q.shape[1]), dtype=torch.float32,
                      device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(kw["q_seg"]),
             ptr(kw["kv_seg"]), ptr(kw["kv_lengths"]),
             *fa._dims(q, k, kw["causal"], kw["causal_offset"], kw.get("scale")),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ptt_flash_fwd failed with cudaError {err}")
    return o, lse


def dq_with(fn, q, k, v, o, lse, do, kw, dlse=None):
    """``(dq, delta)`` from one launch of ``fn``, the ``ptt_flash_bwd_dq`` of
    another build of ``flash_bwd_dq.cu``, with the arguments the wrapper
    passes (``dlse``, the lse cotangent, or null). The wrapper's launch
    counts do not move."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    dq = torch.empty_like(q)
    delta = torch.empty((q.shape[0] * q.shape[2], q.shape[1]), dtype=torch.float32,
                        device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dlse), ptr(delta),
             ptr(dq), ptr(kw["q_seg"]), ptr(kw["kv_seg"]), ptr(kw["kv_lengths"]),
             *fa._dims(q, k, kw["causal"], kw["causal_offset"], kw.get("scale")),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ptt_flash_bwd_dq failed with cudaError {err}")
    return dq, delta


def dkv_with(fn, q, k, v, do, lse, delta, kw):
    """``(dk, dv)`` from one launch of ``fn``, the ``ptt_flash_bwd_dkv`` of
    another build of ``flash_bwd_dkv.cu``, with the arguments the wrapper
    passes. The wrapper's launch counts do not move."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk), ptr(dv),
             ptr(kw["q_seg"]), ptr(kw["kv_seg"]), ptr(kw["kv_lengths"]),
             *fa._dims(q, k, kw["causal"], kw["causal_offset"], kw.get("scale")),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ptt_flash_bwd_dkv failed with cudaError {err}")
    return dk, dv


def counted(read_counts, launch):
    """``(launch()'s result, the two tile counts it left)``: a counting
    build's counts are read and cleared (``read_counts``, its
    ``ptt_*_tile_counts``) before and after the launch."""
    import ctypes

    import torch

    counts = (ctypes.c_ulonglong * 2)()

    def read_and_clear():
        torch.cuda.synchronize()
        err = read_counts(ctypes.addressof(counts))
        if err:
            raise RuntimeError(f"reading a kernel's tile counts failed with cudaError {err}")
        return tuple(counts)

    read_and_clear()
    out = launch()
    return out, read_and_clear()


def count_tiles(name, count_libs, tensors, kw, kernel_out, dlse=None):
    """The three tile-skipping kernels' work on these inputs, counted on the
    card by one launch of each counting build (``count_libs``: kernel name
    -> its ``ptt_*`` entry point and ``ptt_*_tile_counts``): ``{"fwd": (K
    tiles its blocks load, FWD_WARP_Q x FWD_BLOCK_K tiles its warps
    compute), "dq": (K tiles its blocks load, DQ_WARP_Q x DQ_BLOCK_K tiles
    its warps compute), "dkv": (Q tiles its blocks load, DKV_WARP_K x
    DKV_BLOCK_Q tiles its warps compute)}`` over all heads. Raises unless the
    counts equal ``visited_k_tiles``'s and ``visited_q_tiles``'s and each
    counting build's output equals the kernel's (``kernel_out``: ``{"fwd":
    (o, lse), "dq": (dq, delta), "dkv": (dk, dv)}``) bit for bit."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = tensors
    (o, lse), delta = kernel_out["fwd"], kernel_out["dq"][1]  # delta less any dlse
    B, Tq, H = q.shape[:3]
    masks = dict(causal=kw["causal"], causal_offset=kw["causal_offset"],
                 kv_lengths=kw["kv_lengths"], q_seg=kw["q_seg"], kv_seg=kw["kv_seg"])
    launches = {
        "fwd": lambda fn: forward_with(fn, q, k, v, kw),
        "dq": lambda fn: dq_with(fn, q, k, v, o, lse, do, kw, dlse),
        "dkv": lambda fn: dkv_with(fn, q, k, v, do, lse, delta, kw),
    }
    want = {
        "fwd": tuple(int(fa.visited_k_tiles(B, Tq, k.shape[1], block_q=rows, **masks).sum())
                     * H for rows in (fa.FWD_BLOCK_Q, fa.FWD_WARP_Q)),
        "dq": tuple(int(fa.visited_k_tiles(B, Tq, k.shape[1], block_q=rows,
                                           block_k=fa.DQ_BLOCK_K, **masks).sum())
                    * H for rows in (fa.DQ_BLOCK_Q, fa.DQ_WARP_Q)),
        "dkv": tuple(int(fa.visited_q_tiles(B, Tq, k.shape[1], block_k=keys, **masks).sum())
                     * H for keys in (fa.DKV_BLOCK_K, fa.DKV_WARP_K)),
    }
    for kernel, (fn, read_counts) in count_libs.items():
        out, got = counted(read_counts, lambda: launches[kernel](fn))
        if got != want[kernel]:
            raise AssertionError(f"{name}: {kernel} loaded / computed {got} tiles on the "
                                 f"card, its mirror says {want[kernel]}")
        if not all(torch.equal(a, b) for a, b in zip(out, kernel_out[kernel])):
            raise AssertionError(f"{name}: {kernel}'s counting build's output differs "
                                 "from the kernel's")
    return want


def check_case(name, tensors, kw, count_libs, dlse=None):
    """Run all three kernels and their plain versions on the same inputs
    (``dlse``: an lse cotangent for the dQ kernel, or None), launch dQ and
    dK/dV twice each (the two results must be bit-identical), and count the
    kernels' tiles (``count_tiles``); return the error and tile line and
    each kernel's max absolute error, and raise on a tolerance miss: the
    forward absolute in f32 and within one bf16 step elementwise in bf16
    (``fwd_steps`` ≤ 1); lse and delta absolute (f32 for both dtypes);
    gradients relative to the largest gradient."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = tensors
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=dlse, **kw)
    dq2, delta2 = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=dlse, **kw)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, dlse=dlse, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError(f"{name}: two launches of the dQ kernel differ")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{name}: two launches of the dK/dV kernel differ")
    tiles = count_tiles(name, count_libs, tensors, kw,
                        {"fwd": (o, lse), "dq": (dq, delta), "dkv": (dk, dv)}, dlse)
    bf16 = q.dtype == torch.bfloat16
    abs_err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    errs = {"fwd": abs_err(o, o_p)}
    max_abs = {"fwd": errs["fwd"], "dq": abs_err(dq, dq_p),
               "dkv": max(abs_err(dk, dk_p), abs_err(dv, dv_p))}
    finite = torch.isfinite(lse_p)
    if not torch.equal(finite, torch.isfinite(lse)):
        raise AssertionError(f"{name}: lse empty-row pattern differs")
    errs["lse"] = (lse[finite] - lse_p[finite]).abs().max().item()
    if dlse is not None:  # delta carries the lse cotangent into both backward kernels
        B, T, H = q.shape[:3]
        want = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, T) - dlse
        errs["delta"] = (delta - want).abs().max().item()
    for key, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        scale = want.float().abs().max().item() or 1.0
        errs[key] = abs_err(got, want) / scale
    # delta against rowsum(dout * o) - dlse on the kernel's own o: f32 sums
    # of exact products (bf16 products are exact in f32) in another order.
    limits = {"fwd": F32_FWD_ABS, "lse": F32_FWD_ABS, "delta": F32_FWD_ABS}
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
    return (name + " " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
            + " tiles fwd={}/{} dq={}/{} dkv={}/{}".format(*tiles["fwd"], *tiles["dq"],
                                                          *tiles["dkv"]), max_abs)


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


def measure(shape, count_libs):
    """Times and bounds of the three kernels, and of dQ + dK/dV together, on
    a causal + segment-ids f32 case of ``shape``; the visible pairs; and the
    tiles each kernel loads and computes, counted on the card."""
    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch.ops import flash_attention as fa

    B, T, H, D = shape["B"], shape["T"], shape["H"], shape["D"]
    (q, k, v, do), kw = make_case(B, T, H, D, torch.float32, seg=True, seed=1)
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    tiles = count_tiles(f"timed T={T}", count_libs, (q, k, v, do), kw,
                        {"fwd": (o, lse), "dq": (dq, delta), "dkv": (dk, dv)})
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
    counts = {  # (query, key) pairs computed and tiles loaded, counted on the card
        "fwd pairs computed": tiles["fwd"][1] * fa.FWD_WARP_Q * fa.FWD_BLOCK_K,
        "fwd K-tile loads": tiles["fwd"][0],
        "dq pairs computed": tiles["dq"][1] * fa.DQ_WARP_Q * fa.DQ_BLOCK_K,
        "dq K-tile loads": tiles["dq"][0],
        "dkv pairs computed": tiles["dkv"][1] * fa.DKV_WARP_K * fa.DKV_BLOCK_Q,
        "dkv Q-tile loads": tiles["dkv"][0],
    }
    elt = 4
    act = B * T * H * D * elt      # one [B, T, H, D] f32 tensor
    row = B * H * T * 4            # one f32 per (b, h, row): lse or delta
    seg = 2 * B * T * 4
    work = {  # (bytes each input read once / each output written once, FLOPs)
        "fwd": (3 * act + act + row + seg, 4 * D * pairs),
        "dq": (5 * act + row + act + row + seg, 6 * D * pairs),
        "dkv": (4 * act + 2 * row + 2 * act + seg, 8 * D * pairs),
        # dq, dk, dv from q, k, v, o, do, lse: s and dp once, then three
        # products (SDPA's backward computes this function).
        "bwd": (5 * act + row + 3 * act + seg, 10 * D * pairs),
    }
    (dq_ms, dq_host), (dq_plain, _) = times["dq"]
    (dkv_ms, dkv_host), (dkv_plain, _) = times["dkv"]
    times["bwd"] = ((dq_ms + dkv_ms, dq_host + dkv_host), (dq_plain + dkv_plain, None))
    library = {"fwd": sdpa_fwd, "bwd": sdpa_bwd}
    out = {}
    for name, ((ms, host_ms), (plain_ms, _)) in times.items():
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_TC_FLOPS * 1e3
        out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations",
                     "library_ms": library.get(name)}
    return out, pairs, counts


def device_busy_pct(trace_path, batch_bytes, first_timed_batch, copies_per_batch=1):
    """The share (%) of a window of a ``torch.profiler`` Chrome trace during
    which the card ran a kernel, a copy or a memset (their union). The
    window opens at the start of the first copy of the ``first_timed_batch``-th
    batch: the copies of ``batch_bytes`` bytes (a batch's raw images, or one
    of its columns) come ``copies_per_batch`` to a batch, in batch order,
    and the window opens at copy ``first_timed_batch * copies_per_batch``.
    It closes at the end of the last device event. "not measured" when the
    trace holds no such copy."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    copies = sorted(e["ts"] for e in events if e.get("cat") == "gpu_memcpy"
                    and e.get("args", {}).get("bytes") == batch_bytes)
    first = first_timed_batch * copies_per_batch
    if len(copies) <= first:
        return "not measured"
    start, end = copies[first], max(e for _, e in device)
    busy, reach = 0.0, start
    for s, e in device:
        s, e = max(s, reach), min(e, end)
        if e > s:
            busy += e - s
            reach = e
    return f"{100.0 * busy / (end - start):.2f}"


def image_phase(smi):
    """Phase 4 (see the module docstring); fails the run on any check."""
    import copy

    import numpy as np
    import torch

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage

    cfg = IMAGE
    stage_kw = dict(normalize=(127.5, 127.5), crop=cfg["crop"], flip=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_img_")
    try:
        url = f"file://{tmp}/images"
        t0 = time.perf_counter()
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=cfg["rows"],
                                  image_shape=cfg["image_shape"], num_classes=cfg["classes"],
                                  rows_per_row_group=cfg["rows_per_row_group"])
        write_s = time.perf_counter() - t0

        # The host's ceiling: the training run's reader and collation with
        # no device, timed as the training run is (after the first epoch).
        warm = -(-cfg["rows"] // cfg["batch"])
        with make_reader(url, schema_fields=["image", "label"], num_epochs=cfg["epochs"],
                         shuffle_row_groups=True, shard_seed=0) as reader:
            raw, n, t0 = None, 0, None
            for i, batch in enumerate(batch_iterator(reader, cfg["batch"])):
                raw = batch["image"] if raw is None else raw
                if i == warm:
                    t0 = time.perf_counter()
                if t0 is not None:
                    n += len(batch["image"])
            ceiling = n / (time.perf_counter() - t0)

        # The stage: card against CPU, and against the selection of its draws.
        raw_cpu = torch.from_numpy(raw)
        raw_dev = raw_cpu.cuda()
        for dtype in (torch.float32, torch.bfloat16):
            stage = DeviceStage(output_dtype=dtype, **stage_kw)
            got = stage.apply({"image": raw_dev}, 5)["image"]
            if not torch.equal(got.cpu(), stage.apply({"image": raw_cpu}, 5)["image"]):
                fail(f"the device stage's card output ({dtype}) differs from its CPU output")
        draws = stage.draws(5, 0, raw.shape)
        (ch, cw), sel = cfg["crop"], []
        for img, (r, c), flip in zip(raw, draws["offsets"], draws["flips"]):
            img = img[r:r + ch, c:c + cw]
            sel.append(img[:, ::-1] if flip else img)
        want = (np.stack(sel).astype(np.float32) - np.float32(127.5)) * (
            np.float32(1.0) / np.float32(127.5))
        got = DeviceStage(**stage_kw).apply({"image": raw_dev}, 5)["image"].cpu().numpy()
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            fail("the device stage's crop / flip is not the selection its draws name")
        stage = DeviceStage(**stage_kw)
        stage_ms, _ = cuda_ms("device stage", lambda: stage.apply({"image": raw_dev}, 0), 20)

        # f32 logits, card against CPU, same weights (TF32 is off).
        in_shape = cfg["crop"] + (cfg["image_shape"][2],)
        cpu_model = ic.init_image_classifier(in_shape, cfg["classes"], hidden=cfg["hidden"],
                                             conv_features=cfg["conv_features"],
                                             compute_dtype=torch.float32, device="cpu")
        card_model = copy.deepcopy(cpu_model).cuda()
        x = stage.apply({"image": raw_cpu[:8]}, 0)["image"]
        with torch.no_grad():
            want = cpu_model(x)
            got = card_model(x.cuda()).cpu()
        logit_err = float((got - want).abs().max() / want.abs().max())
        if not logit_err <= LOGIT_REL:
            fail(f"f32 logits on the card differ from the CPU module's by {logit_err:.2e} "
                 f"of the largest, above {LOGIT_REL:.0e}")
        del cpu_model, card_model

        # The model step alone, on a resident batch (bf16 compute).
        model = ic.init_image_classifier(in_shape, cfg["classes"], hidden=cfg["hidden"],
                                         conv_features=cfg["conv_features"], device="cuda")
        step = ic.make_image_train_step(model, cfg["lr"])
        images = stage.apply({"image": raw_dev}, 0)["image"]
        labels = torch.zeros(cfg["batch"], dtype=torch.int32, device="cuda")
        mask = torch.ones(cfg["batch"], dtype=torch.bool, device="cuda")
        for _ in range(3):
            step(images, labels, mask)
        step_device_ms, step_host_ms = cuda_ms("image model step",
                                               lambda: step(images, labels, mask), 20)
        del model, step, images

        fa.reset_launch_counts()
        result = ic.train_image_classifier(
            url, batch_size=cfg["batch"], epochs=cfg["epochs"], num_classes=cfg["classes"],
            conv_features=cfg["conv_features"], hidden=cfg["hidden"],
            learning_rate=cfg["lr"], device_stage=DeviceStage(**stage_kw), device="cuda")
        launches = dict(fa.LAUNCHES)

        # The card's busy share in the timed window, from a trace of a second,
        # identical run (CUDA activity only): the union of its kernels,
        # copies and memsets from the H2D copy of the first timed batch's raw
        # images to the last device event.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = ic.train_image_classifier(
                url, batch_size=cfg["batch"], epochs=cfg["epochs"],
                num_classes=cfg["classes"], conv_features=cfg["conv_features"],
                hidden=cfg["hidden"], learning_rate=cfg["lr"],
                device_stage=DeviceStage(**stage_kw), device="cuda")
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy_pct = device_busy_pct(trace, cfg["batch"] * int(np.prod(cfg["image_shape"])),
                                   traced["warmup_steps"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses, warm = result["losses"], result["warmup_steps"]
    diag = result["diagnostics"]
    if result["batch_devices"] != ["cuda:0"]:
        fail(f"image batches arrived on {result['batch_devices']}, not cuda:0")
    if not all(math.isfinite(x) for x in losses) or not (
            np.mean(losses[-warm:]) < np.mean(losses[:warm])):
        fail(f"image loss not finite and falling: {losses}")
    per_row = diag["h2d_bytes"] / diag["rows"]
    if per_row != int(np.prod(cfg["image_shape"])) + 4:
        fail(f"{per_row} H2D bytes per row, expected 12,288 (raw image) + 4 (label)")
    print(f"image: gpu={smi!r} codec={IMAGE_CODEC} rows={cfg['rows']} batch={cfg['batch']} "
          f"crop={cfg['crop']} conv={cfg['conv_features']} hidden={cfg['hidden']} "
          f"steps={len(losses)} warmup_steps={warm} "
          f"images_per_s={result['images_per_s']:.1f} step_ms={result['step_ms']:.3f} "
          f"model_step_device_ms={step_device_ms:.3f} model_step_host_ms={step_host_ms:.3f} "
          f"host_decode_ceiling_images_per_s={ceiling:.1f} "
          f"stage_device_ms_per_batch={stage_ms:.4f} "
          f"consumer_ms_per_step={1e3 * diag['consumer_s'] / diag['batches']:.3f} "
          f"traced_images_per_s={traced['images_per_s']:.1f} "
          f"device_busy_pct_traced={busy_pct} "
          f"input_stall_pct={diag['input_stall_pct']} "
          f"dispatch_overlap_pct={diag['dispatch_overlap_pct']} "
          f"h2d_bytes_per_image={per_row:.1f} "
          f"raw_stage_s={diag['raw_stage_s']:.4f} device_decode_s={diag['device_decode_s']:.4f} "
          f"peak_mem_mib={result['peak_memory_bytes'] / 2**20:.1f} "
          f"logit_rel_err_f32={logit_err:.2e} dataset_write_s={write_s:.2f} "
          f"loss_first_epoch={np.mean(losses[:warm]):.4f} "
          f"loss_last_epoch={np.mean(losses[-warm:]):.4f} flash_launches={launches}",
          flush=True)
    return result["images_per_s"]



def quarter_means(losses):
    """Mean loss over the first and the last quarter of a run."""
    n = max(1, len(losses) // 4)
    return sum(losses[:n]) / n, sum(losses[-n:]) / n


def seq_phase():
    """Phase 5 (see the module docstring); fails the run on any check."""
    from petastorm_tpu_torch.models import sequence_training as st
    from petastorm_tpu_torch.ops import flash_attention as fa

    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    try:
        frames_url, ragged_url = f"file://{tmp}/frames", f"file://{tmp}/ragged"
        st.generate_frames_dataset(frames_url)
        st.generate_ragged_dataset(ragged_url)
        runs = {
            "sequence": lambda: st.train_sequence(frames_url, steps=SEQ_STEPS,
                                                  attn_impl="flash", device="cuda"),
            "ragged": lambda: st.train_ragged_causal(ragged_url, steps=SEQ_STEPS,
                                                     device="cuda"),
            "packed": lambda: st.train_packed_causal(ragged_url, steps=SEQ_STEPS,
                                                     device="cuda"),
        }
        out = {}
        for name, run in runs.items():
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            result = run()
            seconds = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)
            losses = result["losses"]
            if len(losses) != SEQ_STEPS or not all(math.isfinite(x) for x in losses):
                fail(f"seq {name}: {len(losses)} losses, finite: {losses}")
            first, last = quarter_means(losses)
            if name != "sequence" and not last < first:
                fail(f"seq {name}: loss did not fall (first quarter {first:.4f}, "
                     f"last {last:.4f}): {losses}")
            if min(launches.values()) < 1:
                fail(f"seq {name}: a kernel was not launched: {launches}")
            out[name] = (first, last, seconds, launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("seq: head_dim=8 (run as 16, zero-padded) steps=" + str(SEQ_STEPS) + " "
          + " ".join(f"{n}: loss_first_quarter={f:.4f} loss_last_quarter={la:.4f} "
                     f"seconds={sec:.2f} launches={lc}"
                     for n, (f, la, sec, lc) in out.items()), flush=True)


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / (
        want.float().abs().max().item() or 1.0)


def _grads(loss_fn, model):
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def sp_rank(rank, store, out_dir, corpus_url, ragged_url):
    """One rank of phase 6: joins a gloo group of ``SP`` ranks on card 0,
    runs every check (raising on a miss) and writes its numbers to
    ``<out_dir>/rank<rank>.json``, or its traceback to ``rank<rank>.err``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=SP)
        group = dist.group.WORLD
        out = sp_checks(group, corpus_url, ragged_url)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sp_checks(group, corpus_url, ragged_url):
    """The checks of one rank of phase 6; returns its numbers."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.models import long_context_lm as lm
    from petastorm_tpu_torch.models import sequence_model as sm
    from petastorm_tpu_torch.models import sequence_training as st
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_POSITION_KEY,
        PACK_SEGMENT_KEY,
        pack_ragged,
    )

    out = {}
    # Ring (both placements) and Ulysses, flash local, against the dense
    # oracle on the card: outputs and q/k/v gradients.
    B, T, H = LM["B"], LM["T"], LM["H"]
    for d in (LM["D"], 8):
        g = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, w = (torch.randn(B, T, H, d, device="cuda", generator=g) for _ in range(4))
        seg = torch.sort(torch.randint(0, 6, (B, T), device="cuda", generator=g),
                         dim=1).values.int()
        ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = sm.attention_reference(*ref_in, causal=True, segment_ids=seg)
        (ref * w).sum().backward()
        for name, attn in (
                ("ring_striped", lambda a, b, c: sm.ring_attention(
                    a, b, c, group, causal=True, placement="striped", segment_ids=seg,
                    local_attn="flash")),
                ("ring_contiguous", lambda a, b, c: sm.ring_attention(
                    a, b, c, group, causal=True, placement="contiguous", segment_ids=seg,
                    local_attn="flash")),
                ("ulysses", lambda a, b, c: sm.ulysses_attention(
                    a, b, c, group, causal=True, segment_ids=seg, local_attn="flash"))):
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.reset_launch_counts()
            got = attn(*x)
            (got * w).sum().backward()
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
            err = (got - ref).abs().max().item()
            grad_err = max(_rel(a.grad, b.grad) for a, b in zip(x, ref_in))
            if not (err <= F32_FWD_ABS and grad_err <= F32_GRAD_REL):
                raise AssertionError(f"{name} D={d}: output error {err:.3e} (limit "
                                     f"{F32_FWD_ABS:.0e}), gradient error {grad_err:.3e} "
                                     f"(limit {F32_GRAD_REL:.0e}) against the dense oracle")
            if min(launches.values()) < 1:
                raise AssertionError(f"{name} D={d}: a kernel was not launched: {launches}")
            out[f"{name}_d{d}"] = {"out_err": err, "grad_rel_err": grad_err,
                                   "launches": launches}

    # The LM capstone at its full configuration over the group.
    fa.reset_launch_counts()
    result = lm.train_lm(corpus_url, slot_len=LM["T"], slots=LM["B"], steps=SP_TRAIN_STEPS,
                         num_heads=4, d_model=64, epochs=8, device="cuda", group=group)
    launches = dict(fa.LAUNCHES)
    losses = result["losses"]
    if len(losses) != SP_TRAIN_STEPS or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"sp LM: loss not finite and falling over {SP_TRAIN_STEPS} "
                             f"steps: {losses}")
    if not result["logit_parity"] <= PARITY_TOL:
        raise AssertionError(f"sp LM: ring vs dense logits differ by "
                             f"{result['logit_parity']:.3e}")
    if min(launches.values()) < 1:
        raise AssertionError(f"sp LM: a kernel was not launched: {launches}")
    # Its parameter gradients on one packed batch, against one process's.
    rng = np.random.RandomState(9)
    rows = [{"tokens": rng.randint(0, 64, int(rng.randint(8, 49))).astype(np.int32)}
            for _ in range(40)]
    packed = next(pack_ragged(iter(rows), slot_len=LM["T"], slots=LM["B"]))
    batch = [torch.from_numpy(packed[key]).cuda()
             for key in ("tokens", PACK_POSITION_KEY, PACK_SEGMENT_KEY)]
    model = lm.init_lm_params(0, d_model=64, num_heads=4, slot_len=LM["T"], device="cuda")
    loss_sp, grads_sp = _grads(lambda: lm.lm_loss(model, *batch, group=group), model)
    loss_one, grads_one = _grads(lambda: lm.lm_loss(model, *batch), model)
    lm_grad_err = max(_rel(grads_sp[n], grads_one[n]) for n in grads_one)
    if not (lm_grad_err <= F32_GRAD_REL and abs(loss_sp - loss_one) <= 1e-5 * abs(loss_one)):
        raise AssertionError(f"sp LM: gradients differ from one process's by "
                             f"{lm_grad_err:.3e} of the largest (loss {loss_sp} vs "
                             f"{loss_one})")
    out["lm"] = {"losses": losses, "steps_per_s": result["steps_per_s"],
                 "logit_parity": result["logit_parity"], "launches": launches,
                 "grad_rel_err": lm_grad_err,
                 "peak_mem_mib": result["peak_memory_bytes"] / 2 ** 20}

    # The sequence encoder over the group, ring and Ulysses, with their
    # default local attention (the kernels, for CUDA tensors): one step's
    # gradients against one process's, then training runs.
    gen = np.random.RandomState(10)
    windows = torch.tensor(gen.randn(16, 24, 6), dtype=torch.float32, device="cuda")
    labels = torch.tensor(gen.randint(0, 3, 16), device="cuda")
    mask = torch.ones(16, dtype=torch.bool, device="cuda")
    lengths = torch.tensor(gen.randint(4, 25, 16), dtype=torch.int32, device="cuda")
    model = sm.init_seq_params(1, feature_dim=6, d_model=32, num_heads=4, num_classes=3,
                               device="cuda")
    kw = dict(causal=True, compute_dtype=torch.float32)
    _, grads_one = _grads(lambda: sm.seq_loss(model, windows, labels, mask, lengths,
                                              attn_impl="flash", **kw), model)
    for impl in ("ring", "ulysses"):
        fa.reset_launch_counts()
        _, grads_sp = _grads(lambda: sm.seq_loss(model, windows, labels, mask, lengths,
                                                 group=group, attn_impl=impl, **kw), model)
        seq_launches = dict(fa.LAUNCHES)
        err = max(_rel(grads_sp[n], grads_one[n]) for n in grads_one)
        if not err <= F32_GRAD_REL or min(seq_launches.values()) < 1:
            raise AssertionError(f"sp seq {impl}: gradients differ from one process's by "
                                 f"{err:.3e}, launches {seq_launches}")
        t0 = time.perf_counter()
        trained = st.train_ragged_causal(ragged_url, steps=SEQ_STEPS, group=group,
                                         attn_impl=impl, device="cuda")
        seconds = time.perf_counter() - t0
        if not all(math.isfinite(x) for x in trained["losses"]):
            raise AssertionError(f"sp seq {impl}: losses not finite: {trained['losses']}")
        out[f"seq_{impl}"] = {"grad_rel_err": err, "launches": seq_launches,
                              "loss_quarters": quarter_means(trained["losses"]),
                              "train_s": seconds}
    fa.reset_launch_counts()
    packed_run = st.train_packed_causal(ragged_url, steps=SEQ_STEPS, group=group,
                                        device="cuda")
    if not all(math.isfinite(x) for x in packed_run["losses"]) \
            or min(fa.LAUNCHES.values()) < 1:
        raise AssertionError(f"sp packed: losses {packed_run['losses']}, "
                             f"launches {fa.LAUNCHES}")
    out["packed_ring"] = {"loss_quarters": quarter_means(packed_run["losses"]),
                          "launches": dict(fa.LAUNCHES)}
    return out


def sp_phase(one_process_steps_per_s):
    """Phase 6 (see the module docstring): ``SP`` spawned ranks on card 0;
    fails the run if a rank fails or does not finish."""
    import multiprocessing

    from petastorm_tpu_torch.models.long_context_lm import generate_corpus
    from petastorm_tpu_torch.models.sequence_training import generate_ragged_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        corpus_url, ragged_url = f"file://{tmp}/corpus", f"file://{tmp}/ragged"
        generate_corpus(corpus_url)
        generate_ragged_dataset(ragged_url)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=sp_rank, args=(r, os.path.join(tmp, "store"), tmp,
                                                   corpus_url, ragged_url))
                 for r in range(SP)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SP_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        seconds = time.perf_counter() - t0
        failed = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if p.exitcode != 0:
                failed.append(f"rank {r} exit {p.exitcode}: "
                              + (open(err).read() if os.path.exists(err) else "no traceback"))
        if failed:
            fail("sp: " + "\n".join(failed))
        ranks = []
        for r in range(SP):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if ranks[0]["lm"]["losses"] != ranks[1]["lm"]["losses"]:
        fail(f"sp: the ranks' LM losses differ: {[r['lm']['losses'] for r in ranks]}")
    r0 = ranks[0]
    attn = " ".join(f"{n}: out_err={v['out_err']:.2e} grad_rel_err={v['grad_rel_err']:.2e}"
                    for n, v in r0.items() if "out_err" in v)
    lm_r = r0["lm"]
    print(f"sp: ranks={SP} on cuda:0, transport=gloo with pinned-host staging "
          f"(NCCL refuses two ranks on one card) | {attn} | lm d_model=64 heads=4 D=16 "
          f"layers=2 slot_len={LM['T']} slots={LM['B']} steps={len(lm_r['losses'])} "
          f"losses={[round(x, 4) for x in lm_r['losses']]} "
          f"logit_parity={lm_r['logit_parity']:.2e} grad_rel_err={lm_r['grad_rel_err']:.2e} "
          f"launches={lm_r['launches']} peak_mem_mib={lm_r['peak_mem_mib']:.1f} | "
          + " ".join(f"{n}: grad_rel_err={r0[n]['grad_rel_err']:.2e} "
                     f"loss_quarters={[round(x, 4) for x in r0[n]['loss_quarters']]} "
                     f"launches={r0[n]['launches']}" for n in ("seq_ring", "seq_ulysses"))
          + f" packed_ring: loss_quarters="
          f"{[round(x, 4) for x in r0['packed_ring']['loss_quarters']]} "
          f"| seconds={seconds:.1f}", flush=True)
    print(f"sp step times (this transport, not a claim): lm sp=2 "
          f"steps_per_s={lm_r['steps_per_s']:.2f} "
          f"(ranks: {[round(r['lm']['steps_per_s'], 2) for r in ranks]}) vs one process "
          f"{one_process_steps_per_s:.2f}; seq ragged {SEQ_STEPS} steps: ring "
          f"{r0['seq_ring']['train_s']:.2f} s, ulysses {r0['seq_ulysses']['train_s']:.2f} s",
          flush=True)


def reader_phase(smi, cfg=READER, device="cuda"):
    """Phase 8 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run on
    the card uses the defaults."""
    import random
    import threading

    import numpy as np
    import torch

    from petastorm_tpu_torch import local_disk_cache
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.models import mnist
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.predicates import in_pseudorandom_split, in_set
    from petastorm_tpu_torch.pytorch import BatchedDataLoader, DataLoader, InMemBatchedDataLoader
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def traced(run, trace_path, batch_bytes):
        """``run()``'s result and the card's busy share over its batches
        from ``cfg["warm_batches"]`` on (``device_busy_pct``)."""
        if not on_card:
            return run(), "not measured"
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = run()
        prof.export_chrome_trace(trace_path)
        return out, device_busy_pct(trace_path, batch_bytes, cfg["warm_batches"])

    # The cache's hits, counted here: every get, and every fill it calls.
    counts, lock = {"get": 0, "fill": 0}, threading.Lock()
    real_get = local_disk_cache.LocalDiskCache.get

    def counting_get(self, key, fill_cache_func):
        def fill():
            with lock:
                counts["fill"] += 1
            return fill_cache_func()
        with lock:
            counts["get"] += 1
        return real_get(self, key, fill)

    fa.reset_launch_counts()
    rows, group = cfg["rows"], cfg["rows_per_row_group"]
    groups = rows // group
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reader_")
    try:
        # (a) The MNIST-shaped store, its idx index, a selector over it.
        url = f"file://{tmp}/mnist"
        t0 = time.perf_counter()
        mnist.generate_mnist_dataset(url, rows, seed=cfg["seed"], rows_per_row_group=group)
        write_s = time.perf_counter() - t0
        store_mb = sum(os.path.getsize(os.path.join(tmp, "mnist", f))
                       for f in os.listdir(os.path.join(tmp, "mnist"))) / 1e6
        t0 = time.perf_counter()
        build_rowgroup_index(url, [SingleFieldIndexer("idx_index", "idx")])
        index_s = time.perf_counter() - t0
        step = groups // cfg["selected_groups"]
        picked = [g * step for g in range(cfg["selected_groups"])]
        values = [g * group + 17 for g in picked]
        with make_reader(url, schema_fields=["idx"],
                         rowgroup_selector=SingleIndexSelector("idx_index", values)) as reader:
            selected = sorted(int(r.idx) for r in reader)
        want = sorted(i for g in picked for i in range(g * group, (g + 1) * group))
        if selected != want:
            fail(f"reader (a): the selector delivered {len(selected)} rows, expected the "
                 f"{len(want)} rows of row groups {picked}")

        # (b) The MNIST example's path on the card, two epochs on one cache.
        split = in_pseudorandom_split(cfg["split"], 0, "idx")
        kept = sorted(i for i in range(rows) if split.do_include({"idx": i}))
        model = mnist.init_mnist_mlp(seed=cfg["seed"], device=device)
        before = [p.detach().clone() for p in model.parameters()]
        opt = torch.optim.SGD(model.parameters(), lr=cfg["lr"])
        cache_dir = os.path.join(tmp, "cache")
        epochs = []

        def mnist_epoch(epoch):
            reader = make_reader(
                url, schema_fields=["idx", "image", "digit"], transform_spec=mnist.MNIST_TRANSFORM,
                predicate=split, shuffle_row_drop_partitions=cfg["drop_partitions"],
                cache_type="local-disk", cache_location=cache_dir,
                cache_size_limit=cfg["cache_bytes"], num_epochs=1, shard_seed=epoch)
            idx, images, losses = [], [], []
            t0 = time.perf_counter()
            with DataLoader(reader, batch_size=cfg["batch"],
                            shuffling_queue_capacity=cfg["shuffle"],
                            shuffling_queue_seed=epoch, device=device) as loader:
                for batch in loader:
                    opt.zero_grad()
                    loss = torch.nn.functional.cross_entropy(model(batch["image"]),
                                                             batch["digit"])
                    loss.backward()
                    opt.step()
                    losses.append(loss.item())
                    idx.append(batch["idx"])
                    images.append(batch["image"])
            sync()
            seconds = time.perf_counter() - t0
            return dict(idx=torch.cat(idx), images=torch.cat(images), losses=losses,
                        seconds=seconds, size=reader.cache.size_on_disk(),
                        devices={str(t.device) for t in images})

        local_disk_cache.LocalDiskCache.get = counting_get
        try:
            for epoch in range(cfg["epochs"]):
                counts.update(get=0, fill=0)
                out, busy = traced(lambda: mnist_epoch(epoch),
                                   os.path.join(tmp, f"mnist{epoch}.json"),
                                   cfg["batch"] * 28 * 28 * 4)
                out.update(busy=busy, gets=counts["get"], fills=counts["fill"])
                epochs.append(out)
        finally:
            local_disk_cache.LocalDiskCache.get = real_get
        items = groups * cfg["drop_partitions"]
        for epoch, out in enumerate(epochs):
            got = sorted(out["idx"].cpu().tolist())
            if got != kept:
                fail(f"reader (b): epoch {epoch} delivered {len(got)} rows, not each of the "
                     f"{len(kept)} rows the predicate keeps once")
            if out["gets"] != items:
                fail(f"reader (b): epoch {epoch} asked the cache for {out['gets']} work items, "
                     f"expected {items}")
            if not all(math.isfinite(x) for x in out["losses"]):
                fail(f"reader (b): losses not finite in epoch {epoch}")
            if out["devices"] != {str(torch.device(device, 0) if on_card else device)}:
                fail(f"reader (b): batches arrived on {out['devices']}")
        if epochs[0]["fills"] != items or epochs[1]["fills"] != 0:
            fail(f"reader (b): cache fills {epochs[0]['fills']} / {epochs[1]['fills']}, "
                 f"expected {items} / 0 (every second-epoch item a hit)")
        order = [torch.argsort(out["idx"]) for out in epochs]
        if not torch.equal(epochs[0]["images"][order[0]], epochs[1]["images"][order[1]]):
            fail("reader (b): the cached epoch's images differ from the first epoch's")
        if all(torch.equal(a, b.detach()) for a, b in zip(before, model.parameters())):
            fail("reader (b): the parameters did not move")
        epoch_lines = [
            f"epoch {e}: rows={len(out['idx'])} rows_per_s_traced={len(out['idx']) / out['seconds']:.1f} "
            f"cache_gets={out['gets']} cache_fills={out['fills']} "
            f"cache_size_on_disk={out['size']} device_busy_pct_traced={out['busy']} "
            f"loss_mean={np.mean(out['losses']):.4f}"
            for e, out in enumerate(epochs)]
        del epochs, model, opt

        # (c) The batch loaders on phase 7's Criteo-shaped store.
        tab_url = f"file://{tmp}/criteo"
        tab_rows = td.make_tabular_dataset(tab_url, rows=TABULAR["rows"], days=TABULAR["days"])
        per_day = tab_rows // TABULAR["days"]
        days = set(cfg["tab_days"])

        def batched_run(limit=None, on_batch=None):
            reader = make_batch_reader(
                tab_url, predicate=in_set(days, "day"),
                shuffle_row_drop_partitions=cfg["drop_partitions"], cache_type="local-disk",
                cache_location=os.path.join(tmp, "tab_cache"), cache_size_limit=cfg["cache_bytes"],
                num_epochs=1, shard_seed=cfg["seed"])
            seen, where, n = [], set(), 0
            t0 = time.perf_counter()
            with BatchedDataLoader(reader, batch_size=cfg["tab_batch"],
                                   shuffling_queue_capacity=cfg["tab_shuffle"],
                                   shuffling_queue_seed=cfg["seed"], device=device) as loader:
                for batch in loader:
                    seen.append(batch["sample_index"])
                    where.update(str(t.device) for t in batch.values())
                    if on_batch is not None:
                        on_batch(batch)
                    n += 1
                    if limit is not None and n == limit:
                        break
            sync()
            return torch.cat(seen).cpu(), where, n / (time.perf_counter() - t0), n

        sample, where, batched_per_s, batched_n = batched_run()
        want = sorted(i for d in sorted(days) for i in range(d * per_day, (d + 1) * per_day))
        if sorted(sample.tolist()) != want:
            fail(f"reader (c): the batch loader delivered {len(sample)} rows, not each row of "
                 f"days {sorted(days)} once")
        dev = str(torch.device(device, 0)) if on_card else device
        if where != {dev}:
            fail(f"reader (c): the shuffle buffer's batches lay on {where}, not {dev}")
        model = td.init_dlrm(seed=1, device=device)
        dlrm_step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
        dlrm_losses = []

        def train(batch):
            dense, sparse, labels = td.collate_dlrm(batch)
            mask = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
            dlrm_losses.append(float(dlrm_step(dense, sparse, labels, mask)))

        _, _, dlrm_batches_per_s, _ = batched_run(cfg["dlrm_steps"], train)
        if len(dlrm_losses) != cfg["dlrm_steps"] or not all(map(math.isfinite, dlrm_losses)):
            fail(f"reader (c): DLRM steps off the batch loader: losses {dlrm_losses}")

        fields = ["sample_index", "label"] + [f"dense_{i}" for i in range(td.NUM_DENSE)]
        t0 = time.perf_counter()
        inmem = InMemBatchedDataLoader(make_batch_reader(tab_url, schema_fields=fields),
                                       batch_size=cfg["tab_batch"],
                                       num_epochs=cfg["inmem_epochs"], device=device,
                                       random_seed=cfg["seed"])
        with inmem:
            batches = list(inmem)
        sync()
        inmem_s = time.perf_counter() - t0
        if sorted(inmem._cache) != sorted(fields) or not all(
                t.device.type == torch.device(device).type for t in inmem._cache.values()):
            fail("reader (c): the in-memory loader's cache is not on the device")
        per_epoch = -(-tab_rows // cfg["tab_batch"])
        for e in range(cfg["inmem_epochs"]):
            got = torch.cat([b["sample_index"] for b in batches[e * per_epoch:
                                                                (e + 1) * per_epoch]])
            if sorted(got.cpu().tolist()) != list(range(tab_rows)):
                fail(f"reader (c): in-memory epoch {e} is not a permutation of the "
                     f"{tab_rows} rows")
        inmem_per_s = len(batches) / inmem_s

        # (d) WeightedSamplingReader over the two splits, against a host replay.
        readers = [make_reader(url, schema_fields=["idx"], num_epochs=1, predicate=(
            in_pseudorandom_split(cfg["split"], s, "idx"))) for s in range(2)]
        with WeightedSamplingReader(readers, cfg["mix"], random_seed=cfg["seed"]) as mix:
            sources = [0 if split.do_include({"idx": int(next(mix).idx)}) else 1
                       for _ in range(cfg["mix_draws"])]
        rnd, cum = random.Random(cfg["seed"]), np.cumsum(cfg["mix"]) / sum(cfg["mix"])
        replay = [next(i for i, c in enumerate(cum) if d < c) if d < cum[-1] else len(cum) - 1
                  for d in (rnd.random() for _ in range(cfg["mix_draws"]))]
        if sources != replay:
            first = next(i for i, (a, b) in enumerate(zip(sources, replay)) if a != b)
            fail(f"reader (d): draw {first} came from source {sources[first]}, the replay of "
                 f"random.Random({cfg['seed']}) says {replay[first]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"reader: the path launched flash kernels: {launches}")
    print(f"reader (a): gpu={smi!r} mnist rows={rows} row_groups={groups} "
          f"store_mb={store_mb:.1f} write_s={write_s:.2f} index_build_s={index_s:.2f} | "
          f"SingleIndexSelector over {len(values)} idx values in row groups {picked}: "
          f"rows={len(selected)} (each of those row groups' rows once)", flush=True)
    print(f"reader (b): make_reader(predicate=in_pseudorandom_split({cfg['split']}, 0, 'idx'), "
          f"shuffle_row_drop_partitions={cfg['drop_partitions']}, local-disk cache "
          f"limit={cfg['cache_bytes']}) -> DataLoader(batch={cfg['batch']}, "
          f"shuffling_queue_capacity={cfg['shuffle']}) -> MLP 784-128-10 SGD lr={cfg['lr']}; "
          f"kept_rows={len(kept)} work_items={items} | " + " | ".join(epoch_lines)
          + "; second epoch: every item a cache hit, images bit-equal", flush=True)
    print(f"reader (c): criteo rows={tab_rows} | make_batch_reader(predicate=in_set("
          f"{sorted(days)}, 'day'), drop_partitions={cfg['drop_partitions']}, local-disk "
          f"cache) -> BatchedDataLoader(batch={cfg['tab_batch']}, "
          f"shuffling_queue_capacity={cfg['tab_shuffle']}): rows={len(sample)} "
          f"batches={batched_n} batches_per_s={batched_per_s:.1f} on {sorted(where)} | "
          f"dlrm steps={len(dlrm_losses)} batches_per_s={dlrm_batches_per_s:.1f} "
          f"loss_first={dlrm_losses[0]:.5f} loss_last={dlrm_losses[-1]:.5f} | "
          f"InMemBatchedDataLoader({len(fields)} columns, epochs={cfg['inmem_epochs']}): "
          f"batches={len(batches)} batches_per_s={inmem_per_s:.1f} (fill included) "
          f"seconds={inmem_s:.2f}", flush=True)
    print(f"reader (d): WeightedSamplingReader({cfg['mix']}, random_seed={cfg['seed']}) over "
          f"the two splits: {cfg['mix_draws']} draws, source 0 share="
          f"{sources.count(0) / len(sources):.4f}, equal to the host replay; "
          f"flash_launches={launches}", flush=True)


def tabular_dp_rank(rank, store, out_dir, url):
    """One rank of phase 7 (d): joins a gloo group of ``DP`` ranks on card
    0, runs its checks (raising on a miss), trains on its shard and writes
    its numbers to ``<out_dir>/rank<rank>.json`` and its final parameters
    to ``params<rank>.pt``, or its traceback to ``rank<rank>.err``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=DP)
        group = dist.group.WORLD
        out, params = tabular_dp_checks(rank, group, url)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.save({k: v.cpu() for k, v in params.items()},
                   os.path.join(out_dir, f"params{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def tabular_dp_checks(rank, group, url):
    """The checks of one rank of phase 7 (d); returns its numbers and its
    final parameters."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.sharding import agree_max_batches, global_step_count

    cfg = TABULAR
    # f32 compute: the first step's all-reduced gradients against the mean
    # of both batches' one-process gradients (the batches are all-gathered).
    model = td.init_dlrm(compute_dtype=torch.float32, device="cuda")
    reader = make_batch_reader(url, num_epochs=cfg["epochs"], shuffle_row_groups=True,
                               shard_seed=7, cur_shard=rank, shard_count=DP)
    with make_torch_dataloader(reader, cfg["batch"], device="cuda", group=group) as loader:
        batch = next(iter(loader))
    dense, sparse, labels = td.collate_dlrm(batch)
    mask = torch.ones(labels.shape[0], dtype=torch.bool, device="cuda")
    _, grads = td.dlrm_gradients(model, dense, sparse, labels, mask, group)
    grads = {k: v.clone() for k, v in grads.items()}
    gathered = []
    for t in (dense, sparse, labels):
        parts = [torch.empty_like(t.cpu()) for _ in range(DP)]
        dist.all_gather(parts, t.cpu(), group=group)
        gathered.append(parts)
    mean = None
    for parts in zip(*gathered):
        _, g = td.dlrm_gradients(model, *(p.cuda() for p in parts), mask)
        g = {k: v.clone() for k, v in g.items()}
        mean = g if mean is None else {k: mean[k] + g[k] for k in g}
    grad_err = max((grads[k] - mean[k] / DP).abs().max().item()
                   / max((mean[k] / DP).abs().max().item(), 1e-30) for k in grads)
    if not grad_err <= DP_GRAD_REL:
        raise AssertionError(f"dp: all-reduced gradients differ from the one-process mean by "
                             f"{grad_err:.3e} of the largest (limit {DP_GRAD_REL:.0e})")
    agreed = agree_max_batches(100 + rank, group=group)
    if agreed != 100:
        raise AssertionError(f"dp: agree_max_batches gave {agreed}, expected min(100, 101)")
    want = global_step_count(url, cfg["batch"], DP, num_epochs=cfg["epochs"], shard_seed=7)
    t0 = time.perf_counter()
    result = td.train_dlrm(url, batch_size=cfg["batch"], epochs=cfg["epochs"], device="cuda",
                           group=group)
    seconds = time.perf_counter() - t0
    derived = result["diagnostics"]["max_batches"]
    if not (derived == want == result["steps"] > 0):
        raise AssertionError(f"dp rank {rank}: derived max_batches {derived}, "
                             f"global_step_count {want}, steps {result['steps']}")
    if not all(math.isfinite(x) for x in result["losses"]):
        raise AssertionError(f"dp rank {rank}: losses not finite: {result['losses']}")
    return {"grad_rel_err": grad_err, "agreed": agreed, "steps": result["steps"],
            "max_batches": derived, "global_step_count": want,
            "steps_per_s_warm": result["steps_per_s_warm"],
            "train_s": seconds}, result["model"].state_dict()


def tabular_phase(smi):
    """Phase 7 (see the module docstring); fails the run on any check."""
    import gc
    import multiprocessing

    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.checkpoint import restore_training_state

    cfg = TABULAR
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tab_")
    try:
        url = f"file://{tmp}/criteo"
        t0 = time.perf_counter()
        rows = td.make_tabular_dataset(url, rows=cfg["rows"], days=cfg["days"])
        write_s = time.perf_counter() - t0
        arrow_schema = pq.read_schema(os.path.join(tmp, "criteo", "part-00000.parquet"))
        wide = sum(1 for f in arrow_schema if f.type.bit_width == 64)  # int64 columns
        per_group = rows // cfg["days"]

        # (a) Filters: a full scan and a one-day scan.
        scans = {}
        for name, filters in (("full", None), ("day3", [("day", "=", 3)])):
            t0 = time.perf_counter()
            with make_batch_reader(url, num_epochs=1, filters=filters) as reader:
                n = sum(len(b.sample_index) for b in reader)
                groups = reader.diagnostics["rowgroups_total"]
            scans[name] = (groups, n, n / (time.perf_counter() - t0))
        if scans["full"][:2] != (cfg["days"], rows) or scans["day3"][:2] != (1, per_group):
            fail(f"tabular (a): scans planned / read {scans}, expected "
                 f"({cfg['days']}, {rows}) and (1, {per_group})")

        # (b) The uninterrupted run, then an identical traced one.
        train = dict(batch_size=cfg["batch"], epochs=cfg["epochs"], device="cuda")
        fa.reset_launch_counts()
        base = td.train_dlrm(url, collect_field="sample_index", **train)
        launches = dict(fa.LAUNCHES)
        steps = cfg["epochs"] * rows // cfg["batch"]
        losses = base["losses"]
        first_q, last_q = quarter_means(losses)
        if base["steps"] != steps or not all(math.isfinite(x) for x in losses) \
                or not last_q < first_q:
            fail(f"tabular (b): {base['steps']} steps (expected {steps}), losses finite and "
                 f"falling: quarter means {first_q:.7f} -> {last_q:.7f}")
        if base["batch_devices"] != ["cuda:0"]:
            fail(f"tabular (b): batches arrived on {base['batch_devices']}, not cuda:0")
        counts = np.bincount(base["collected"], minlength=rows)
        dropped = cfg["epochs"] * rows - steps * cfg["batch"]
        if counts.max() > cfg["epochs"] or int((cfg["epochs"] - counts).sum()) != dropped:
            fail(f"tabular (b): rows trained {counts.min()}-{counts.max()} times, "
                 f"{int((cfg['epochs'] - counts).sum())} short (expected {dropped})")
        if any(launches.values()):
            fail(f"tabular (b): the path launched flash kernels: {launches}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = td.train_dlrm(url, **train)
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy = device_busy_pct(trace, cfg["batch"] * 8, td.WARM_FROM_STEP,
                               copies_per_batch=wide)
        diag = base["diagnostics"]

        # (c) Preempted at step 100, checkpointed, every object dropped,
        # restored, and finished by a fresh reader with resume_state.
        ckpt = os.path.join(tmp, "ckpt")
        first = td.train_dlrm(url, interrupt_after=cfg["interrupt_after"], checkpoint_dir=ckpt,
                              collect_field="sample_index", **train)
        saved = {k: v.detach().cpu().clone() for k, v in first["model"].state_dict().items()}
        first_rows, save_ms = first["collected"], first["checkpoint_save_ms"]
        first_steps = first["steps"]
        del first
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        arrays, state = restore_training_state(ckpt, map_location="cuda")
        restore_ms = 1e3 * (time.perf_counter() - t0)
        model = td.init_dlrm(seed=1, device="cuda")
        model.load_state_dict(arrays["model"])
        restored = model.state_dict()
        if sorted(restored) != sorted(saved) or not all(
                torch.equal(restored[k].cpu(), saved[k]) for k in saved):
            fail("tabular (c): restored parameters differ from the saved ones")
        second = td.train_dlrm(url, resume_state=state, model=model,
                               collect_field="sample_index", **train)
        if not all(math.isfinite(x) for x in second["losses"]):
            fail(f"tabular (c): resumed losses not finite: {second['losses']}")
        counts = np.bincount(np.concatenate([first_rows, second["collected"]]),
                             minlength=rows)
        deficit = int(np.maximum(cfg["epochs"] - counts, 0).sum())
        reread = int(np.maximum(counts - cfg["epochs"], 0).sum())
        if deficit >= cfg["batch"]:
            fail(f"tabular (c): {deficit} row-trainings short of {cfg['epochs']} per row "
                 f"over both runs (limit: under {cfg['batch']}, the dropped final batch)")

        # (d) Data parallel: DP spawned ranks on card 0.
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=tabular_dp_rank,
                             args=(r, os.path.join(tmp, "store"), tmp, url))
                 for r in range(DP)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SP_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        dp_s = time.perf_counter() - t0
        failed = [f"rank {r} exit {p.exitcode}: "
                  + (open(os.path.join(tmp, f"rank{r}.err")).read()
                     if os.path.exists(os.path.join(tmp, f"rank{r}.err")) else "no traceback")
                  for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            fail("tabular (d): " + "\n".join(failed))
        ranks = []
        for r in range(DP):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        params = [torch.load(os.path.join(tmp, f"params{r}.pt")) for r in range(DP)]
        if not all(torch.equal(params[0][k], params[1][k]) for k in params[0]):
            fail("tabular (d): the ranks' final parameters differ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    full, day = scans["full"], scans["day3"]
    print(f"tabular (a): gpu={smi!r} rows={rows} row_groups={cfg['days']} "
          f"columns={len(arrow_schema)} write_s={write_s:.2f} | full scan: "
          f"rowgroups_total={full[0]} rows={full[1]} rows_per_s={full[2]:.1f} | "
          f"filters=[('day', '=', 3)]: rowgroups_total={day[0]} rows={day[1]} "
          f"rows_per_s={day[2]:.1f}", flush=True)
    print(f"tabular (b): dlrm 13 dense, 26 tables x 1024 x 16, hidden 64, bf16, "
          f"batch={cfg['batch']} epochs={cfg['epochs']} steps={base['steps']} "
          f"loss_first_quarter={first_q:.7f} loss_last_quarter={last_q:.7f} "
          f"steps_per_s_warm={base['steps_per_s_warm']:.2f} "
          f"rows_per_s_warm={base['rows_per_s_warm']:.1f} (steps {td.WARM_FROM_STEP}-end) "
          f"input_stall_pct={diag['input_stall_pct']} "
          f"h2d_bytes_per_row={diag['h2d_bytes'] / diag['rows']:.1f} "
          f"peak_mem_mib={base['peak_memory_bytes'] / 2**20:.1f} "
          f"traced_steps_per_s_warm={traced['steps_per_s_warm']:.2f} "
          f"device_busy_pct_traced={busy} dropped_rows={dropped} "
          f"flash_launches={launches}", flush=True)
    print(f"tabular (c): interrupted after {first_steps} steps, resumed for "
          f"{second['steps']} steps; restored parameters bit for bit; "
          f"reread_rows={reread} deficit_rows={deficit} "
          f"checkpoint_save_ms={save_ms:.2f} checkpoint_restore_ms={restore_ms:.2f}",
          flush=True)
    grad_errs = [f"{r['grad_rel_err']:.2e}" for r in ranks]
    print(f"tabular (d): ranks={DP} on cuda:0 (gloo, pinned-host staging; transport on one "
          f"card, not a claim): global_step_count={ranks[0]['global_step_count']} "
          f"steps={[r['steps'] for r in ranks]} "
          f"max_batches={[r['max_batches'] for r in ranks]} final parameters bit-equal; "
          f"f32 grad_rel_err={grad_errs} "
          f"agree_max_batches(100, 101)={ranks[0]['agreed']} "
          f"steps_per_s_warm={[round(r['steps_per_s_warm'], 2) for r in ranks]} "
          f"seconds={dp_s:.1f}", flush=True)


def loader_phase(smi, image_images_per_s, cfg=IMAGE, device="cuda"):
    """Phase 9 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run on
    the card uses the defaults. ``image_images_per_s``: phase 4's, from this
    call, printed beside (b)'s."""
    import hashlib

    import numpy as np
    import torch

    from petastorm_tpu_torch.cache_impl import BatchCache, CacheConfig
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.service.seedtree import fold_in, permutation
    from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    lc, batch = LOADER, cfg["batch"]
    on_card = torch.device(device).type == "cuda"
    dev = str(torch.device(device, 0)) if on_card else device
    per_pass = -(-cfg["rows"] // batch)
    raw_bytes = batch * int(np.prod(cfg["image_shape"]))
    stage_kw = dict(normalize=(127.5, 127.5), crop=cfg["crop"], flip=True)
    fields = ["image", "label"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def digests(batches):
        return [hashlib.blake2b(t.cpu().numpy().tobytes(), digest_size=16).hexdigest()
                for t in batches]

    def equal(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=cfg["rows"],
                                  image_shape=cfg["image_shape"], num_classes=cfg["classes"],
                                  rows_per_row_group=cfg["rows_per_row_group"])

        # (a) bench.py's leg_cached_epochs on the card.
        def cached_epochs(seed):
            cache = BatchCache(mem_budget_bytes=lc["leg_cache_bytes"])
            reader = make_columnar_reader(url, reader_pool_type="thread", workers_count=1,
                                          num_epochs=1, shuffle_row_groups=False,
                                          schema_fields=fields)
            # Each pass's images are kept for the checks in a buffer made
            # beforehand: allocating on the card inside the timed pass
            # would time the allocator.
            passes = [torch.empty((per_pass, batch) + tuple(cfg["image_shape"]),
                                  dtype=torch.uint8, device=device) for _ in range(2)]
            counts, walls, marks, where = [], [], [], set()
            try:
                with make_torch_dataloader(reader, batch, batch_cache=cache, shuffle_seed=seed,
                                           device=device) as loader:
                    for images in passes:
                        n = 0
                        sync()
                        t0 = time.perf_counter()
                        for i, b in enumerate(loader):
                            if i == per_pass:
                                fail(f"loader (a) seed={seed}: more than {per_pass} batches "
                                     "in a pass")
                            images[i].copy_(b["image"])
                            where.add(str(b["image"].device))
                            n += len(b["image"])
                        sync()
                        walls.append(time.perf_counter() - t0)
                        counts.append(n)
                        stats = cache.stats()
                        marks.append((stats["hits"], stats["misses"]))
            finally:
                cache.cleanup()
            warm_hits = marks[1][0] - marks[0][0]
            warm_lookups = warm_hits + marks[1][1] - marks[0][1]
            return dict(passes=passes, counts=counts, where=where, stats=stats,
                        cold=counts[0] / walls[0], warm=counts[1] / walls[1],
                        hit_rate=warm_hits / warm_lookups if warm_lookups else None)

        leg = {seed: cached_epochs(seed) for seed in (None, lc["seed"])}
        canonical = digests(leg[None]["passes"][0])
        for seed, run in leg.items():
            if run["counts"] != [per_pass * batch] * 2 or run["where"] != {dev}:
                fail(f"loader (a) seed={seed}: passes delivered {run['counts']} rows on "
                     f"{run['where']}, expected {per_pass * batch} per pass on {dev}")
            if run["hit_rate"] != 1.0:
                fail(f"loader (a) seed={seed}: warm hit rate {run['hit_rate']}, expected 1.0")
        if not equal(leg[None]["passes"][1], leg[None]["passes"][0]):
            fail("loader (a): the unseeded warm pass is not the cold pass bit for bit")
        seeded = [digests(images) for images in leg[lc["seed"]]["passes"]]
        for k, got in enumerate(seeded):
            order = permutation(fold_in(lc["seed"], ("cache-epoch", k)), per_pass)
            if got != [canonical[i] for i in order]:
                fail(f"loader (a): seeded pass {k} is not the canonical batches in the order "
                     f"permutation(fold_in({lc['seed']}, ('cache-epoch', {k})), {per_pass})")
        if seeded[0] == seeded[1] or leg[lc["seed"]]["stats"]["permuted_serves"] != 2:
            fail(f"loader (a): the seeded passes' orders are equal or not counted as permuted "
                 f"({leg[lc['seed']]['stats']['permuted_serves']} permuted serves)")
        leg_lines = [
            f"seed={seed}: cold_images_per_sec={run['cold']:.1f} "
            f"warm_images_per_sec={run['warm']:.1f} warm_vs_cold={run['warm'] / run['cold']:.3f} "
            f"cache_hit_rate={run['hit_rate']} bytes_mem={run['stats']['bytes_mem']} "
            f"permuted_serves={run['stats']['permuted_serves']}"
            for seed, run in leg.items()]
        del leg, seeded

        # (b) The image path on a cached, producer-staged loader.
        in_shape = cfg["crop"] + (cfg["image_shape"][2],)

        def image_run(name):
            cache = CacheConfig("mem+disk", mem_mb=lc["mem_mb"],
                                cache_dir=os.path.join(tmp, f"{name}_cache")).build()
            reader = make_reader(url, schema_fields=fields, num_epochs=1,
                                 shuffle_row_groups=False)
            trace_path = os.path.join(tmp, f"{name}_loader_trace.json")
            model = ic.init_image_classifier(in_shape, cfg["classes"], hidden=cfg["hidden"],
                                             conv_features=cfg["conv_features"], device=device)
            step = ic.make_image_train_step(model, cfg["lr"])
            out = dict(losses=[], walls=[], diags=[], labels=[], where=set())
            try:
                with make_torch_dataloader(
                        reader, batch, last_batch="pad", device_stage=DeviceStage(**stage_kw),
                        batch_cache=cache, shuffle_seed=lc["seed"], stage_in_producer=True,
                        trace_path=trace_path, device=device) as loader:
                    for _ in range(lc["passes"]):
                        losses = []
                        labels = torch.zeros(cfg["classes"], dtype=torch.int64, device=device)
                        sync()
                        t0 = time.perf_counter()
                        for b in loader:
                            out["where"].update(str(t.device) for t in b.values())
                            images = b["image"]
                            mask = b.get(PAD_MASK_KEY)
                            if mask is None:
                                mask = torch.ones(images.shape[0], dtype=torch.bool,
                                                  device=images.device)
                            losses.append(step(images, b["label"], mask))
                            labels.index_add_(0, b["label"].long(), mask.long())
                        sync()
                        out["walls"].append(time.perf_counter() - t0)
                        out["losses"].append([float(x) for x in losses])
                        out["labels"].append(labels.cpu().tolist())
                        out["diags"].append(loader.diagnostics)
                out["stats"] = cache.stats()
            finally:
                cache.cleanup()
            with open(trace_path) as f:
                events = json.load(f)["traceEvents"]
            out["spans"] = {name: sum(1 for e in events if e["ph"] == "B" and e["name"] == name)
                            for name in ("loader.decode", "loader.wait", "loader.device_put",
                                         "loader.consumer")}
            return out

        fa.reset_launch_counts()
        run = image_run("b")
        launches = dict(fa.LAUNCHES)
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced = image_run("b_traced")
            trace = os.path.join(tmp, "b_profile.json")
            prof.export_chrome_trace(trace)
            busy = device_busy_pct(trace, raw_bytes, per_pass)
        else:
            traced, busy = run, "not measured"
        if any(launches.values()):
            fail(f"loader (b): the path launched flash kernels: {launches}")
        if run["where"] != {dev}:
            fail(f"loader (b): batches arrived on {run['where']}, not {dev}")
        first, last = np.mean(run["losses"][0]), np.mean(run["losses"][-1])
        if not all(math.isfinite(x) for p in run["losses"] for x in p) or not last < first:
            fail(f"loader (b): loss not finite and falling: pass means "
                 f"{[round(float(np.mean(p)), 4) for p in run['losses']]}")
        stats = run["stats"]
        if (stats["misses"], stats["hits"], stats["permuted_serves"]) != (
                1, lc["passes"] - 1, lc["passes"]):
            fail(f"loader (b): cache misses / hits / permuted serves {stats['misses']} / "
                 f"{stats['hits']} / {stats['permuted_serves']}, expected 1 / "
                 f"{lc['passes'] - 1} / {lc['passes']}")
        if any(labels != run["labels"][0] for labels in run["labels"]) or \
                sum(run["labels"][0]) != cfg["rows"]:
            fail(f"loader (b): the passes trained on different labels: {run['labels']}")
        if run["spans"]["loader.device_put"] != per_pass or \
                run["spans"]["loader.wait"] != per_pass:
            fail(f"loader (b): the trace of the last pass holds {run['spans']}, expected "
                 f"{per_pass} loader.device_put and loader.wait spans")
        warm = run["diags"][1:]
        walls = run["walls"]
        stall_pct = 100.0 * sum(d["stall_s"] for d in warm) / sum(d["wall_s"] for d in warm)
        consumer_ms = 1e3 * sum(d["consumer_s"] for d in warm) / sum(d["batches"] for d in warm)
        cold_ips = cfg["rows"] / walls[0]
        warm_ips = (lc["passes"] - 1) * cfg["rows"] / sum(walls[1:])
        traced_warm_ips = (lc["passes"] - 1) * cfg["rows"] / sum(traced["walls"][1:])
        decode_ms = [1e3 * sum(d["producer_decode_s"] for d in diags)
                     / sum(d["batches"] for d in diags) for diags in (run["diags"][:1], warm)]
        del traced

        # (c) Producer-side staging is invisible in the data.
        def staged(stage_in_producer, prefetch):
            reader = make_reader(url, schema_fields=fields, num_epochs=1, workers_count=1,
                                 shuffle_row_groups=False)
            with make_torch_dataloader(
                    reader, batch, last_batch="pad", device_stage=DeviceStage(**stage_kw),
                    max_batches=lc["stage_batches"], stage_in_producer=stage_in_producer,
                    device_prefetch=prefetch, device=device) as loader:
                return [(b["image"], b["label"]) for b in loader]

        runs = {(sip, p): staged(sip, p) for sip in (False, True) for p in lc["stage_prefetch"]}
        ref = runs[(False, lc["stage_prefetch"][0])]
        if len(ref) != lc["stage_batches"]:
            fail(f"loader (c): {len(ref)} batches, expected {lc['stage_batches']}")
        for key, got in runs.items():
            if not all(equal(g, w) for g, w in zip(got, ref)) or len(got) != len(ref):
                fail(f"loader (c): stage_in_producer={key[0]} device_prefetch={key[1]} gave "
                     "other card tensors than consumer-side staging at device_prefetch 1")
        del runs, ref

        # (d) Resume a permuted pass from the disk tier.
        def resume_loader(cache, cache_resume=None):
            # One decode worker: the uninterrupted run fills its own entry,
            # which must hold the canonical order the interrupted run's does.
            reader = make_reader(url, schema_fields=fields, num_epochs=1, workers_count=1,
                                 shuffle_row_groups=False)
            return make_torch_dataloader(
                reader, batch, last_batch="pad",
                device_stage=DeviceStage(normalize=stage_kw["normalize"]), batch_cache=cache,
                shuffle_seed=lc["seed"], stage_in_producer=True, cache_resume=cache_resume,
                device=device)

        def take(batches):
            return [(b["image"], b["label"]) for b in batches]

        full_cache = BatchCache(mem_budget_bytes=lc["mem_mb"] << 20)
        with resume_loader(full_cache) as loader:
            for _ in range(lc["resume_passes"]):
                for _ in loader:
                    pass
            want = take(loader)
        full_cache.cleanup()
        cache_dir = os.path.join(tmp, "d_cache")
        cache = CacheConfig("mem+disk", mem_mb=lc["mem_mb"], cache_dir=cache_dir).build()
        with resume_loader(cache) as loader:
            for _ in range(lc["resume_passes"]):
                for _ in loader:
                    pass
            iterator = iter(loader)
            head = take(next(iterator) for _ in range(lc["resume_after"]))
            state = loader.state_dict()
            iterator.close()
        cache.cleanup()
        del loader, cache
        want_state = {"version": 1, "kind": "cache_replay", "cache_epoch": lc["resume_passes"],
                      "batches_yielded": lc["resume_after"], "shuffle_seed": lc["seed"]}
        if state != want_state:
            fail(f"loader (d): state_dict() {state}, expected {want_state}")
        cache = CacheConfig("mem+disk", mem_mb=lc["mem_mb"], cache_dir=cache_dir).build()
        t0 = time.perf_counter()
        with resume_loader(cache, state) as loader:
            rest = take(loader)
        sync()
        resume_s = time.perf_counter() - t0
        resumed = cache.stats()
        cache.cleanup()
        if not all(equal(g, w) for g, w in zip(head + rest, want)) or \
                len(head) + len(rest) != len(want):
            fail(f"loader (d): the interrupted + resumed pass 3 ({len(head)} + {len(rest)} "
                 f"batches) is not the uninterrupted pass's {len(want)} bit for bit")
        if resumed["hits_disk"] < 1 or resumed["misses"] != 0:
            fail(f"loader (d): the resumed cache counted {resumed['hits_disk']} disk hits and "
                 f"{resumed['misses']} misses, expected >= 1 and 0 (no fill)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"loader (a): gpu={smi!r} bench.py leg_cached_epochs: make_columnar_reader(workers=1) "
          f"-> make_torch_dataloader({batch}, batch_cache=BatchCache(1 GiB)), 2 passes of "
          f"{per_pass} batches | " + " | ".join(leg_lines)
          + "; unseeded replay bit-equal, seeded passes in the seed-tree order", flush=True)
    print(f"loader (b): gpu={smi!r} make_reader -> make_torch_dataloader(pad, DeviceStage("
          f"crop={cfg['crop']}, flip), CacheConfig('mem+disk', {lc['mem_mb']} MiB), "
          f"shuffle_seed={lc['seed']}, stage_in_producer, trace_path) -> CNN conv="
          f"{cfg['conv_features']} hidden={cfg['hidden']}, {lc['passes']} passes: "
          f"pass1_images_per_s={cold_ips:.1f} warm_images_per_s={warm_ips:.1f} "
          f"(passes 2-{lc['passes']}) phase4_images_per_s={image_images_per_s:.1f} "
          f"input_stall_pct_warm={stall_pct:.2f} "
          f"dispatch_overlap_pct_last={warm[-1]['dispatch_overlap_pct']} "
          f"consumer_ms_per_step_warm={consumer_ms:.3f} "
          f"producer_decode_ms_per_batch_pass1={decode_ms[0]:.3f} "
          f"producer_decode_ms_per_batch_warm={decode_ms[1]:.3f} "
          f"traced_warm_images_per_s={traced_warm_ips:.1f} device_busy_pct_traced_warm={busy} "
          f"loss_pass1={first:.4f} loss_pass{lc['passes']}={last:.4f} "
          f"last_pass_spans={run['spans']} cache_stats={json.dumps(stats)} "
          f"flash_launches={launches}", flush=True)
    print(f"loader (c): the first {lc['stage_batches']} batches at stage_in_producer "
          f"False/True x device_prefetch {list(lc['stage_prefetch'])}: bit-equal card "
          "tensors (the stage's draws follow the production ordinal)", flush=True)
    print(f"loader (d): stopped after {lc['resume_after']} batches of pass "
          f"{lc['resume_passes'] + 1}: {json.dumps(state)}; a fresh BatchCache on the same "
          f"directory and a fresh reader resumed the pass in {resume_s:.2f} s: "
          f"{len(rest)} batches bit-equal to the uninterrupted run's; hits_disk="
          f"{resumed['hits_disk']} misses={resumed['misses']}", flush=True)


def trainer_cases():
    """Kernel cases at the shapes and dtypes the sequence trainers (phases 5
    and 6) give the kernels, ``(name, case, dlse)``: B=16, H=4, D=8 windows
    of 5 frames, unmasked, bf16; ragged B=16 T=24 causal with
    ``kv_lengths``, bf16; packed B=4 T=48 causal with segment ids (-1
    padded tails), f32; and the sp = 2 ring's blocks of the last two (T=12
    and T=24, strict causal, per-block ``kv_lengths`` or a ``(q_ids,
    kv_ids)`` pair, with an lse cotangent)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(50)
    out = []
    frames = make_case(16, 5, 4, 8, torch.bfloat16, seed=51)
    frames[1]["causal"] = False
    out.append(("seq frames B=16 T=5 D=8 bf16", frames, None))
    for t, offset, tag in ((24, 0, "ragged B=16 T=24"), (12, -1, "ragged ring block B=16 T=12")):
        tensors, kw = make_case(16, t, 4, 8, torch.bfloat16, seed=52 + t)
        kw["causal_offset"] = offset
        kw["kv_lengths"] = torch.randint(0, t + 1, (16,), device="cuda", generator=g).int()
        dlse = torch.randn(16 * 4, t, device="cuda", generator=g) if offset else None
        out.append((f"seq {tag} causal+kv_lengths D=8 bf16", (tensors, kw), dlse))
    out.append(("seq packed B=4 T=48 causal+seg D=8 f32",
                make_case(4, 48, 4, 8, torch.float32, seg="tail_pad", seed=54), None))
    tensors, kw = make_case(4, 24, 4, 8, torch.float32, seg="tail_pad", seed=55)
    kw["causal_offset"] = -1
    kw["kv_seg"] = kw["q_seg"].flip(0).contiguous()  # another row's ids: a pair
    out.append(("seq packed ring block B=4 T=24 strict causal+seg pair D=8 f32", (tensors, kw),
                torch.randn(4 * 4, 24, device="cuda", generator=g)))
    return out


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

    from petastorm_tpu_torch.models.long_context_lm import (
        WARM_FROM_STEP,
        generate_corpus,
        train_lm,
    )
    from petastorm_tpu_torch.ops import _build
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.ops.segment_layouts import SEGMENT_KINDS

    # -- 1. env ------------------------------------------------------------
    t_start = t_phase = time.perf_counter()
    phase_s = {}
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
    count_dir = tempfile.mkdtemp(prefix="chip_smoke_count_")
    counting = {  # kernel -> (source, switch, entry point)
        "fwd": ("flash_fwd.cu", "PTT_FWD_COUNT_TILES=1", "ptt_flash_fwd"),
        "dq": ("flash_bwd_dq.cu", "PTT_DQ_COUNT_TILES=1", "ptt_flash_bwd_dq"),
        "dkv": ("flash_bwd_dkv.cu", "PTT_DKV_COUNT_TILES=1", "ptt_flash_bwd_dkv"),
    }
    procs = {}
    try:
        for kernel, (src, define, _) in counting.items():
            so = os.path.join(count_dir, f"lib{kernel}_count.so")
            procs[kernel] = (so, _build.compile_source(src, so, defines=(define,)))
        _build.build_all()
    finally:
        outs = {kernel: proc.communicate()[0] for kernel, (_, proc) in procs.items()}
    count_libs = {}
    for kernel, (so, proc) in procs.items():
        src, _, symbol = counting[kernel]
        if proc.returncode != 0:
            fail(f"nvcc failed for the counting build of {src}:\n{outs[kernel].decode()}")
        count_libs[kernel] = (_build.load(so, symbol), _build.load(so, symbol + "_tile_counts"))
    shutil.rmtree(count_dir, ignore_errors=True)  # loaded: the mappings stay
    build_s = time.perf_counter() - t0
    print(f"env: gpu={smi!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"nvcc={nvcc_version!r} triton={triton_version} cutlass_headers={cutlass} "
          f"kernels_built_in_s={build_s:.2f}", flush=True)

    # -- 2. kernels ----------------------------------------------------------
    phase_s["env"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    B, T, H, D = BENCH["B"], BENCH["T"], BENCH["H"], BENCH["D"]
    cases = [
        ("bench causal+seg f32", make_case(B, T, H, D, torch.float32, seg=True)),
        ("bench causal bf16", make_case(B, T, H, D, torch.bfloat16)),
        ("bench causal gqa(hkv=2) f32", make_case(B, T, H, D, torch.float32, Hkv=2)),
        ("bench kv_lengths f32", make_case(B, T, H, D, torch.float32, lens=True)),
    ]
    for i, kind in enumerate(SEGMENT_KINDS):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            cases.append((f"T=1024 {kind} {tag}",
                          make_case(B, 1024, H, D, dtype, seg=kind, seed=i)))
    for d in (16, 32, 64):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            cases.append((f"D={d} T=512 tail_pad {tag}",
                          make_case(B, 512, H, d, dtype, seg="tail_pad", seed=d)))
    # Strict causal (causal_offset -1: the striped ring's blocks whose key
    # shard sits after the query shard) and the lse cotangent through the dQ
    # kernel (every ring backward carries one), at the ring's block shapes:
    # the LM's at sp = 2 (T=64, D=16) and the sequence family's (D=8, which
    # the kernels take zero-padded to 16, see ``kernel_layout``); and D=8 on
    # the tile-tripping ids.
    cases = [(name, case, None) for name, case in cases]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases.append((f"D=8 T=512 tail_pad {tag}",
                      make_case(B, 512, H, 8, dtype, seg="tail_pad", seed=8), None))
        for d in (16, 8):
            (tensors, kw) = make_case(LM["B"], LM["T"] // 2, LM["H"], d, dtype, seg=True,
                                      seed=30 + d)
            kw["causal_offset"] = -1
            g = torch.Generator(device="cuda").manual_seed(d)
            dlse = torch.randn(LM["B"] * LM["H"], LM["T"] // 2, device="cuda", generator=g)
            cases.append((f"D={d} T={LM['T'] // 2} strict causal+seg dlse {tag}",
                          (tensors, kw), dlse))
    (tensors, kw) = make_case(B, 1024, H, D, torch.float32, seg=True, seed=21)
    kw["causal_offset"] = -1
    cases.append(("T=1024 strict causal+seg f32", (tensors, kw), None))
    cases += trainer_cases()
    cases.append(("lm D=16 causal+seg f32", make_case(LM["B"], LM["T"], LM["H"], LM["D"],
                                                      torch.float32, seg=True), None))
    checked = [check_case(name, *kernel_layout(case), count_libs, dlse)
               for name, case, dlse in cases]
    errs = [line for line, _ in checked]
    max_err = checked[-1][1]  # the main path's shape: the LM case
    del cases
    timed = {}
    for label, shape in (("lm", LM), ("bench", BENCH)):
        timing, pairs, counts = measure(shape, count_libs)
        timed[label] = timing
        errs.append(
            f"| {label} causal+seg f32 {shape}: "
            + "; ".join(f"{n} ms={t['ms']:.4f} host_ms={t['host_ms']:.4f} "
                        f"plain_ms={t['plain_ms']:.4f} "
                        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})"
                        for n, t in timing.items())
            + f"; sdpa fwd ms={timing['fwd']['library_ms']:.4f} "
            f"sdpa bwd (dq+dk+dv) ms={timing['bwd']['library_ms']:.4f}; "
            f"visible pairs={pairs}; counted on the card: "
            + " ".join(f"{k}={v}" for k, v in counts.items()))
    errs.append(f"| timing batches still short of spin: {SPIN_SHORT}")
    print("kernels: " + "; ".join(errs), flush=True)

    # -- 3. train ------------------------------------------------------------
    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        url = f"file://{tmp}/corpus"
        generate_corpus(url)
        fa.reset_launch_counts()
        result = train_lm(url, slot_len=128, slots=4, steps=TRAIN_STEPS,
                          num_heads=4, d_model=64, epochs=8, device="cuda")
        launches = dict(fa.LAUNCHES)
        # The card's busy share in the warm window, from a trace of a second,
        # identical run: a packed batch is three int32 [4, 128] copies
        # (tokens, positions, segment ids) of 2,048 bytes each.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = train_lm(url, slot_len=128, slots=4, steps=TRAIN_STEPS,
                              num_heads=4, d_model=64, epochs=8, device="cuda")
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        lm_busy = device_busy_pct(trace, 4 * 128 * 4, WARM_FROM_STEP, copies_per_batch=3)
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
          f"steps_per_s_warm={result['steps_per_s_warm']:.2f} (from step {WARM_FROM_STEP}) "
          f"step_ms_median_warm={result['step_ms_median_warm']:.3f} "
          f"traced_steps_per_s_warm={traced['steps_per_s_warm']:.2f} "
          f"device_busy_pct_traced={lm_busy} "
          f"input_stall_pct={diag['input_stall_pct']} h2d_bytes={diag['h2d_bytes']} "
          f"peak_mem_mb={result['peak_memory_bytes'] / 2**20:.1f} "
          f"logit_parity={result['logit_parity']:.2e} launches={launches}",
          flush=True)

    # -- 4. image ... 9. loader --------------------------------------------
    phase_s["train"] = time.perf_counter() - t_phase
    out = {}
    for name, run in (("image", lambda: image_phase(smi)), ("seq", seq_phase),
                      ("sp", lambda: sp_phase(result["steps_per_s"])),
                      ("tabular", lambda: tabular_phase(smi)),
                      ("reader", lambda: reader_phase(smi)),
                      ("loader", lambda: loader_phase(smi, out["image"]))):
        t_phase = time.perf_counter()
        out[name] = run()
        phase_s[name] = time.perf_counter() - t_phase
    print("phases: " + " ".join(f"{name}_s={sec:.1f}" for name, sec in phase_s.items())
          + f" total_s={time.perf_counter() - t_start:.1f}", flush=True)

    source = "petastorm_tpu_torch/ops/csrc/"
    replaces = {"fwd": "petastorm_tpu/ops/flash_attention.py:96",
                "dq": "petastorm_tpu/ops/flash_attention.py:522",
                "dkv": "petastorm_tpu/ops/flash_attention.py:593"}
    files = {"fwd": "flash_fwd.cu", "dq": "flash_bwd_dq.cu", "dkv": "flash_bwd_dkv.cu"}
    record = {"kernels": [
        {"name": f"flash_{name}", "route": "cuda", "source": source + files[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max_err[name], **timed["lm"][name]}
        for name in ("fwd", "dq", "dkv")],
        "backward": {"name": "flash_dq+flash_dkv", "launches": launches["dq"] + launches["dkv"],
                     **timed["lm"]["bwd"]}}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
