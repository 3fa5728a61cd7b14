"""Flash attention for PyTorch: hand-written CUDA kernels for Hopper, plus
their plain PyTorch versions.

Counterpart of ``petastorm_tpu/ops/flash_attention.py``. The public
:func:`flash_attention` keeps that module's contract: ``[B, T, H, D]``
tensors; ``causal`` aligned at the last position; per-example
``kv_lengths``; packed ``segment_ids`` as one ``[B, T]`` array or a
``(q_ids, kv_ids)`` pair; grouped-query K/V (``h % h_kv == 0``); rows with no
visible key give zero output, NaN-free; the same ``ValueError`` messages.

Three kernels (``ops/csrc``, CUDA C++ for ``sm_90a``, built at first use by
:mod:`._build`) carry it on the card:

- ``flash_fwd.cu``: output and the per-row log-sum-exp residual (``+inf``
  for rows with no visible key), saved for the backward; it skips the K
  tiles :func:`visited_k_tiles` leaves out;
- ``flash_bwd_dq.cu``: dQ, plus ``delta = rowsum(dout * o)`` (less the lse
  cotangent ``dlse`` where one is given); it skips the K tiles
  :func:`visited_k_tiles` leaves out for its tiles (``DQ_*``);
- ``flash_bwd_dkv.cu``: dK/dV accumulated per K/V head inside the block; it
  skips the Q tiles :func:`visited_q_tiles` leaves out.

:class:`FlashAttentionFn` chains them as a ``torch.autograd.Function``, and
:class:`FlashAttentionWithLseFn` does for :func:`flash_attention_with_lse`,
whose lse output is differentiable too (the ring attention's merge
statistic). The kernels are instantiated for head dims
:data:`KERNEL_HEAD_DIMS` and take the softmax scale as an argument; the
autograd functions take any ``D <= 128``: their forward zero-pads q, k, v
once to the next instantiated head dim (:func:`pad_head_dim`; zero columns
add exact zeros to every product) with the true ``1 / sqrt(D)`` as the
scale and saves the padded tensors, their backward pads dout once, and both
slice their outputs back. Each kernel wrapper adds one to
:data:`LAUNCHES` where it launches. The plain
versions (:func:`flash_forward_plain`, :func:`flash_backward_plain`) compute
the same functions blockwise with PyTorch ops and no autograd; a wrapper
takes them only for tensors that lie on the CPU. For CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import math

import torch

#: Launch count of each kernel, incremented by the wrappers right where they
#: launch (never by the plain versions).
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

#: Head dims the CUDA kernels are instantiated for; the autograd functions
#: zero-pad any other head dim up to ``max(KERNEL_HEAD_DIMS)`` to the next of
#: them (:func:`pad_head_dim`).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PLAIN_BLOCK_K = 128

#: Query rows per block, query rows per warp and keys per K/V tile of
#: ``flash_fwd.cu`` (its ``BQ``, ``WQ`` and ``BK``): a block loads the K
#: tiles :func:`visited_k_tiles` gives for ``block_q=FWD_BLOCK_Q``, and each
#: warp computes those it gives for ``block_q=FWD_WARP_Q``.
FWD_BLOCK_Q, FWD_WARP_Q, FWD_BLOCK_K = 64, 16, 32

#: Keys per block, keys per warp and query rows per Q tile of
#: ``flash_bwd_dkv.cu`` (its ``BK``, ``WK`` and ``BQ``): a block loads the Q
#: tiles :func:`visited_q_tiles` gives for ``block_k=DKV_BLOCK_K``, and each
#: warp computes those it gives for ``block_k=DKV_WARP_K``.
DKV_BLOCK_K, DKV_WARP_K, DKV_BLOCK_Q = 64, 16, 16

#: Query rows per block, query rows per warp and keys per K/V tile of
#: ``flash_bwd_dq.cu`` (its ``BQ``, ``WQ`` and ``BK``): the forward's rule,
#: :func:`visited_k_tiles` with ``block_q=DQ_BLOCK_Q`` for its blocks and
#: ``block_q=DQ_WARP_Q`` for its warps, and ``block_k=DQ_BLOCK_K``.
DQ_BLOCK_Q, DQ_WARP_Q, DQ_BLOCK_K = 64, 16, 16

#: The tensors the kernels copy with 16-byte ``cp.async``: each must start on
#: a 16-byte boundary (o is read directly).
_CP_ASYNC_INPUTS = ("q", "k", "v", "do")


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Argument checks (same messages as the JAX package)
# ---------------------------------------------------------------------------

def _check_gqa_heads(q, k, v):
    h, h_kv = q.shape[2], k.shape[2]
    if v.shape[2] != h_kv:
        raise ValueError(
            f"k has {h_kv} heads but v has {v.shape[2]}; K and V must "
            "share their (possibly grouped) head count")
    if h % h_kv:
        raise ValueError(
            f"{h} query heads do not group over {h_kv} K/V heads "
            "(grouped-query attention requires h % h_kv == 0)")
    return h, h_kv


def _check_segment_ids(segment_ids, t_q, t_kv):
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
        for name, ids in (("q_ids", q_ids), ("kv_ids", kv_ids)):
            if ids.dim() != 2:
                raise ValueError(
                    f"segment_ids {name} must be [B, T] (batch axis "
                    f"included), got shape {tuple(ids.shape)}")
        if q_ids.shape[1] != t_q or kv_ids.shape[1] != t_kv:
            raise ValueError(
                f"segment_ids pair shapes {tuple(q_ids.shape)} / "
                f"{tuple(kv_ids.shape)} do not match T_q={t_q} / "
                f"T_kv={t_kv} (is the (q_ids, kv_ids) order swapped?)")
        return q_ids, kv_ids
    if segment_ids.dim() != 2:
        raise ValueError(
            f"segment_ids must be [B, T] (batch axis included — "
            f"per-token ids alone are ambiguous across the batch), "
            f"got shape {tuple(segment_ids.shape)}")
    if t_q != t_kv:
        raise ValueError(
            f"a single segment_ids array requires T_q == T_kv "
            f"(self-attention over a packed batch), got {t_q} vs "
            f"{t_kv}; pass a (q_ids, kv_ids) pair for cross-length "
            "attention")
    if segment_ids.shape[1] != t_q:
        raise ValueError(
            f"segment_ids shape {tuple(segment_ids.shape)} does not "
            f"match the sequence length T={t_q}")
    return segment_ids, segment_ids


def resolve_device(device):
    """The entry points' device rule: ``"cuda"`` unless the caller asks for
    another device, and no silent fallback — a CUDA request without a card
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")
    return device


# ---------------------------------------------------------------------------
# Plain PyTorch versions (blockwise, no autograd)
# ---------------------------------------------------------------------------

def _kv_limits(kv_lengths, b, t_kv, device):
    if kv_lengths is None:
        return torch.full((b,), t_kv, dtype=torch.int64, device=device)
    return torch.clamp(kv_lengths.to(device=device, dtype=torch.int64), max=t_kv)


def _visible(rows, cols, kv_limit, causal, causal_offset, q_seg, kv_seg):
    """[B, 1, Tq, bk] boolean mask of visible (row, col) pairs: the rule of
    ``flash_common.cuh::key_visible``."""
    ok = cols[None, None, None, :] < kv_limit[:, None, None, None]
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None] + causal_offset)[None, None]
    if q_seg is not None:
        ok = ok & (q_seg[:, None, :, None] == kv_seg[:, cols][:, None, None, :])
    return ok


def _heads_first(x, group=1):
    """[B, T, Hx, D] → f32 [B, Hx·group, T, D] (K/V heads repeated over
    their query-head group)."""
    x = x.permute(0, 2, 1, 3).to(torch.float32)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def flash_forward_plain(q, k, v, causal=False, causal_offset=0,
                        kv_lengths=None, q_seg=None, kv_seg=None, scale=None,
                        block_k=_PLAIN_BLOCK_K):
    """The forward kernel's function in PyTorch: a blockwise online softmax
    over K tiles, scores scaled by ``scale`` (``1 / sqrt(D)`` by default).
    Returns ``(o [B, Tq, H, D] in q's dtype, lse [B·H, Tq] f32)`` with lse
    ``+inf`` for rows with no visible key."""
    b, t_q, h, d = q.shape
    t_kv, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = _heads_first(q)
    kf, vf = _heads_first(k, h // h_kv), _heads_first(v, h // h_kv)
    kv_limit = _kv_limits(kv_lengths, b, t_kv, q.device)
    rows = torch.arange(t_q, device=q.device)
    m = torch.full((b, h, t_q, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, t_q, 1), device=q.device)
    acc = torch.zeros((b, h, t_q, d), device=q.device)
    for k0 in range(0, t_kv, block_k):
        cols = torch.arange(k0, min(k0 + block_k, t_kv), device=q.device)
        s = torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
        s = torch.where(_visible(rows, cols, kv_limit, causal, causal_offset,
                                 q_seg, kv_seg), s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        empty = m_new == -math.inf
        m_safe = torch.where(empty, 0.0, m_new)
        alpha = torch.where(empty, 1.0, torch.exp(m - m_safe))
        p = torch.exp(s - m_safe)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, :, k0:k0 + block_k])
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)),
                      math.inf)
    return (o.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            lse.reshape(b * h, t_q))


def visited_k_tiles(b, t_q, t_kv, causal=False, causal_offset=0,
                    kv_lengths=None, q_seg=None, kv_seg=None,
                    block_q=FWD_BLOCK_Q, block_k=FWD_BLOCK_K):
    """The forward kernel's tile-skip rule in PyTorch, which the dQ kernel
    shares (with its ``DQ_*`` tiles): a boolean ``[B, ceil(Tq / block_q),
    ceil(Tkv / block_k)]`` tensor, True where the rows of Q tile i (a
    block's, or with ``block_q=FWD_WARP_Q`` a warp's) take K tile j.

    A Q tile sees keys below ``k_end``: the kv bound and, if causal, its last
    row's diagonal. Without segment ids it visits every tile that starts
    below ``k_end``. With them it visits a tile only if one of those keys has
    an id in ``[min, max]`` of the ids of the Q tile's rows (ids in any order,
    -1 padding included): a visible pair's key has its row's id, so no
    visible pair is ever skipped, and a tile whose id range is disjoint from
    the Q tile's is always skipped."""
    device = next((t.device for t in (q_seg, kv_lengths) if t is not None),
                  torch.device("cpu"))
    n_q, n_k = -(-t_q // block_q), -(-t_kv // block_k)
    q0 = torch.arange(n_q, device=device) * block_q
    k_end = _kv_limits(kv_lengths, b, t_kv, device)[:, None].expand(b, n_q)
    if causal:
        k_end = torch.minimum(k_end, q0 + block_q + causal_offset)
    keys = torch.arange(n_k * block_k, device=device)
    seen = keys[None, None, :] < k_end[:, :, None]             # [B, n_q, keys]
    if q_seg is not None:
        pad = n_q * block_q - t_q
        ids = q_seg.to(torch.int64)
        lo = torch.nn.functional.pad(ids, (0, pad), value=2 ** 40)
        hi = torch.nn.functional.pad(ids, (0, pad), value=-2 ** 40)
        lo = lo.reshape(b, n_q, block_q).amin(dim=-1)
        hi = hi.reshape(b, n_q, block_q).amax(dim=-1)
        kv = torch.nn.functional.pad(kv_seg.to(torch.int64),
                                     (0, n_k * block_k - t_kv))
        seen = seen & (kv[:, None, :] >= lo[:, :, None]) & (
            kv[:, None, :] <= hi[:, :, None])
    return seen.reshape(b, n_q, n_k, block_k).any(dim=-1)


def visited_q_tiles(b, t_q, t_kv, causal=False, causal_offset=0,
                    kv_lengths=None, q_seg=None, kv_seg=None,
                    block_k=DKV_BLOCK_K, block_q=DKV_BLOCK_Q):
    """The dK/dV kernel's tile-skip rule in PyTorch, :func:`visited_k_tiles`
    with Q and K swapped: a boolean ``[B, ceil(Tkv / block_k), ceil(Tq /
    block_q)]`` tensor, True where the keys of K tile i (a block's, or with
    ``block_k=DKV_WARP_K`` a warp's) take Q tile j.

    A K tile's valid keys lie below the kv bound; a tile with none takes no
    Q tile. Its keys can see rows below ``t_q`` and, if causal, at or after
    its first key's diagonal row ``k0 - causal_offset``. Without segment ids
    it visits every Q tile holding such a row. With them it visits a tile
    only if one of those rows has an id in ``[min, max]`` of the ids of the
    valid keys: exact for ids in any order, as in :func:`visited_k_tiles`."""
    device = next((t.device for t in (q_seg, kv_lengths) if t is not None),
                  torch.device("cpu"))
    n_k, n_q = -(-t_kv // block_k), -(-t_q // block_q)
    keys = torch.arange(n_k * block_k, device=device)
    valid = keys[None] < _kv_limits(kv_lengths, b, t_kv, device)[:, None]
    rows = torch.arange(n_q * block_q, device=device)
    seen = (rows < t_q)[None, None, :] & valid.reshape(b, n_k, block_k).any(
        dim=-1)[:, :, None]                                    # [B, n_k, rows]
    if causal:
        k0 = torch.arange(n_k, device=device) * block_k
        seen = seen & (rows[None, :] >= (k0 - causal_offset)[:, None])[None]
    if q_seg is not None:
        ids = torch.nn.functional.pad(kv_seg.to(torch.int64),
                                      (0, n_k * block_k - t_kv))
        lo = torch.where(valid, ids, 2 ** 40).reshape(b, n_k, block_k)
        hi = torch.where(valid, ids, -2 ** 40).reshape(b, n_k, block_k)
        lo, hi = lo.amin(dim=-1), hi.amax(dim=-1)
        qi = torch.nn.functional.pad(q_seg.to(torch.int64),
                                     (0, n_q * block_q - t_q))
        seen = seen & (qi[:, None, :] >= lo[:, :, None]) & (
            qi[:, None, :] <= hi[:, :, None])
    return seen.reshape(b, n_k, n_q, block_q).any(dim=-1)


def _bwd_tiles(q, k, v, do, lse, delta, causal, causal_offset, kv_lengths,
               q_seg, kv_seg, scale, block_k):
    """Yield ``(k0, k1, p, ds)`` per K tile, f32 ``[B, H, Tq, bk]``:
    ``p = exp(s - lse)`` and ``ds = p * (do v^T - delta) * scale`` — the
    recomputation both backward kernels share (``delta`` already less any
    lse cotangent; ``scale`` ``1 / sqrt(D)`` by default)."""
    b, t_q, h, d = q.shape
    t_kv, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, dof = _heads_first(q), _heads_first(do)
    kf, vf = _heads_first(k, h // h_kv), _heads_first(v, h // h_kv)
    lse = lse.reshape(b, h, t_q, 1)
    delta = delta.reshape(b, h, t_q, 1)
    kv_limit = _kv_limits(kv_lengths, b, t_kv, q.device)
    rows = torch.arange(t_q, device=q.device)
    for k0 in range(0, t_kv, block_k):
        k1 = min(k0 + block_k, t_kv)
        cols = torch.arange(k0, k1, device=q.device)
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        p = torch.exp(torch.where(
            _visible(rows, cols, kv_limit, causal, causal_offset, q_seg,
                     kv_seg), s - lse, -math.inf))
        dp = torch.matmul(dof, vf[:, :, k0:k1].transpose(-1, -2))
        yield k0, k1, p, p * (dp - delta) * scale


def _heads_last(x, like):
    return x.permute(0, 2, 1, 3).to(like.dtype).contiguous()


def flash_bwd_dq_plain(q, k, v, o, lse, do, causal=False, causal_offset=0,
                       kv_lengths=None, q_seg=None, kv_seg=None, dlse=None,
                       scale=None, block_k=_PLAIN_BLOCK_K):
    """The dQ kernel's function in PyTorch: ``delta = rowsum(do * o)``, less
    the lse cotangent ``dlse`` (``[B·H, Tq]`` f32) when one is given, and
    ``dq = sum over K tiles of ds k``. Returns ``(dq, delta [B·H, Tq] f32)``;
    delta feeds :func:`flash_bwd_dkv_plain` as it feeds the dK/dV kernel."""
    b, t_q, h, _ = q.shape
    delta = (_heads_first(do) * _heads_first(o)).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.reshape(b, h, t_q)
    kf = _heads_first(k, h // k.shape[2])
    dq = torch.zeros((b, h, t_q, q.shape[-1]), device=q.device)
    for k0, k1, _, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                    causal_offset, kv_lengths, q_seg, kv_seg,
                                    scale, block_k):
        dq += torch.matmul(ds, kf[:, :, k0:k1])
    return _heads_last(dq, q), delta.reshape(b * h, t_q)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                        causal_offset=0, kv_lengths=None, q_seg=None,
                        kv_seg=None, scale=None, block_k=_PLAIN_BLOCK_K):
    """The dK/dV kernel's function in PyTorch: ``dv = p^T do`` and
    ``dk = ds^T q`` per query head, summed over each K/V head's query-head
    group in f32. Returns ``(dk, dv)``."""
    b, _, h, d = q.shape
    t_kv, h_kv = k.shape[1], k.shape[2]
    qf, dof = _heads_first(q), _heads_first(do)
    dk = torch.zeros((b, h, t_kv, d), device=q.device)
    dv = torch.zeros((b, h, t_kv, d), device=q.device)
    for k0, k1, p, ds in _bwd_tiles(q, k, v, do, lse, delta, causal,
                                    causal_offset, kv_lengths, q_seg, kv_seg,
                                    scale, block_k):
        dv[:, :, k0:k1] = torch.matmul(p.transpose(-1, -2), dof)
        dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qf)
    dk = dk.reshape(b, h_kv, h // h_kv, t_kv, d).sum(dim=2)
    dv = dv.reshape(b, h_kv, h // h_kv, t_kv, d).sum(dim=2)
    return _heads_last(dk, k), _heads_last(dv, v)


def flash_backward_plain(q, k, v, o, lse, do, dlse=None, **kwargs):
    """Both backward kernels' functions in PyTorch: ``(dq, dk, dv)``."""
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse, do, dlse=dlse, **kwargs)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kwargs)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_kernel_inputs(q, k, v, like_q=None, stats=(), kv_lengths=None,
                         q_seg=None, kv_seg=None, aligned16=False):
    """Raise on what the kernels do not take: the dtype, head dim, device,
    layout and shapes of every tensor argument (``like_q``: tensors shaped
    like q by name, such as ``{"o": o, "do": do}``; ``stats``: f32
    ``[B·H, Tq]`` lse / delta) and, with ``aligned16`` (the kernels' 16-byte
    ``cp.async`` copies), any of q, k, v and do whose data does not start on
    a 16-byte boundary (a view at an odd offset into its storage), by name."""
    like_q = like_q or {}
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernels take [B, T, H, D] with D in {KERNEL_HEAD_DIMS} "
            f"(pad_head_dim pads other head dims up to "
            f"{KERNEL_HEAD_DIMS[-1]}), got q of shape {tuple(q.shape)}")
    b, t_q, h, d = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != d or h % k.shape[2]):
        raise ValueError(
            f"k / v of shapes {tuple(k.shape)} / {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)} (same B and D, h % h_kv == 0)")
    expected = [(t, q.dtype, tuple(q.shape)) for t in like_q.values()]
    expected += [(t, torch.float32, (b * h, t_q)) for t in stats]
    expected += [(k, q.dtype, tuple(k.shape)), (v, q.dtype, tuple(k.shape))]
    for t, shape in ((kv_lengths, (b,)), (q_seg, (b, t_q)),
                     (kv_seg, (b, k.shape[1]))):
        if t is not None:
            expected.append((t, torch.int32, shape))
    for t, dtype, shape in [(q, q.dtype, tuple(q.shape))] + expected:
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"flash kernels take a contiguous {dtype} tensor of shape "
                f"{shape} on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    named = {"q": q, "k": k, "v": v, **like_q}
    for name in _CP_ASYNC_INPUTS if aligned16 else ():
        t = named.get(name)
        if t is not None and t.data_ptr() % 16:
            raise ValueError(
                f"this flash kernel takes its inputs starting on a "
                f"16-byte boundary; {name} starts {t.data_ptr() % 16} bytes "
                "past one (a view into its storage): pass a copy")


def _dims(q, k, causal, causal_offset, scale=None):
    """The kernels' shared scalar arguments: B, H, Hkv, Tq, Tkv, D, dtype
    code, causal, causal_offset, scale (``1 / sqrt(D)`` by default)."""
    b, t_q, h, d = q.shape
    return (b, h, k.shape[2], t_q, k.shape[1], d, _DTYPE_CODES[q.dtype],
            int(causal), int(causal_offset),
            1.0 / math.sqrt(d) if scale is None else scale)


def _kernel_head_dim(d):
    """The instantiated head dim a head dim ``d`` is padded to (``d`` itself
    past the largest, which the input checks refuse)."""
    return next((dk for dk in KERNEL_HEAD_DIMS if d <= dk), d)


def _pad_head_dim(t, dk):
    """``t`` zero-padded on its last axis to ``dk`` columns (a fresh,
    contiguous buffer), or ``t`` itself when it has ``dk`` already."""
    return t if t.shape[-1] == dk else torch.nn.functional.pad(t, (0, dk - t.shape[-1]))


def _unpad_head_dim(t, d):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def pad_head_dim(*tensors):
    """``(tensors, scale)``: ``[..., D]`` tensors zero-padded on their last
    axis to the kernels' head dim for D (themselves when D is instantiated),
    and the true ``1 / sqrt(D)``. This is how the kernels take a head dim
    they are not instantiated for: zero columns add exact zeros to every
    product (0 splits into hi = lo = 0 in the 3xTF32 passes), so the padded
    call's outputs, sliced back, are the true head dim's."""
    d = tensors[0].shape[-1]
    dk = _kernel_head_dim(d)
    return [_pad_head_dim(t, dk) for t in tensors], 1.0 / math.sqrt(d)


def _launch(symbol, *args):
    from petastorm_tpu_torch.ops import _build

    err = _build.kernel(symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with cudaError {err}")


def flash_forward_kernel(q, k, v, causal=False, causal_offset=0,
                         kv_lengths=None, q_seg=None, kv_seg=None, scale=None):
    """Launch ``flash_fwd.cu``: same contract as :func:`flash_forward_plain`."""
    _check_kernel_inputs(q, k, v, kv_lengths=kv_lengths, q_seg=q_seg,
                         kv_seg=kv_seg, aligned16=True)
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0] * q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("ptt_flash_fwd", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
                _ptr(lse), _ptr(q_seg), _ptr(kv_seg), _ptr(kv_lengths),
                *_dims(q, k, causal, causal_offset, scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["fwd"] += 1
    return o, lse


def flash_bwd_dq_kernel(q, k, v, o, lse, do, causal=False, causal_offset=0,
                        kv_lengths=None, q_seg=None, kv_seg=None, dlse=None,
                        scale=None):
    """Launch ``flash_bwd_dq.cu``: same contract as
    :func:`flash_bwd_dq_plain`."""
    b, t_q, h, _ = q.shape
    stats = (lse,) if dlse is None else (lse, dlse)
    _check_kernel_inputs(q, k, v, like_q={"o": o, "do": do}, stats=stats,
                         kv_lengths=kv_lengths, q_seg=q_seg, kv_seg=kv_seg,
                         aligned16=True)
    dq = torch.empty_like(q)
    delta = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("ptt_flash_bwd_dq", _ptr(q), _ptr(k), _ptr(v), _ptr(o),
                _ptr(do), _ptr(lse), _ptr(dlse), _ptr(delta), _ptr(dq),
                _ptr(q_seg), _ptr(kv_seg), _ptr(kv_lengths),
                *_dims(q, k, causal, causal_offset, scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["dq"] += 1
    return dq, delta


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal=False,
                         causal_offset=0, kv_lengths=None, q_seg=None,
                         kv_seg=None, scale=None):
    """Launch ``flash_bwd_dkv.cu``: same contract as
    :func:`flash_bwd_dkv_plain`."""
    _check_kernel_inputs(q, k, v, like_q={"do": do}, stats=(lse, delta),
                         kv_lengths=kv_lengths, q_seg=q_seg, kv_seg=kv_seg,
                         aligned16=True)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("ptt_flash_bwd_dkv", _ptr(q), _ptr(k), _ptr(v), _ptr(do),
                _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), _ptr(q_seg),
                _ptr(kv_seg), _ptr(kv_lengths),
                *_dims(q, k, causal, causal_offset, scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["dkv"] += 1
    return dk, dv


def flash_backward_kernel(q, k, v, o, lse, do, dlse=None, **kwargs):
    """dQ then dK/dV on the current stream (the second reads the delta the
    first wrote, less any ``dlse``): ``(dq, dk, dv)``."""
    dq, delta = flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=dlse, **kwargs)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kwargs)
    return dq, dk, dv


def flash_forward(q, *args, **kwargs):
    """Forward kernel for CUDA tensors, its plain version for CPU tensors."""
    if q.is_cuda:
        return flash_forward_kernel(q, *args, **kwargs)
    return flash_forward_plain(q, *args, **kwargs)


def flash_backward(q, *args, **kwargs):
    """Backward kernels for CUDA tensors, their plain version for CPU ones."""
    if q.is_cuda:
        return flash_backward_kernel(q, *args, **kwargs)
    return flash_backward_plain(q, *args, **kwargs)


def _aligned16(t):
    """``t`` contiguous and starting on a 16-byte boundary: itself when it
    already is, else a copy (a layout step for the kernels' 16-byte copies,
    not a fallback)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_saved(ctx, q, k, v, causal, causal_offset, kv_lengths, q_seg,
                   kv_seg):
    """The autograd functions' forward: ``(o, lse)``. q, k, v are laid out
    once for the kernels — zero-padded to an instantiated head dim
    (:func:`pad_head_dim`), contiguous on 16-byte boundaries (views such as
    ``qkv.unbind(2)`` or odd offsets are copied here) — and saved so, with
    the padded o, for the backward; o comes back at the true head dim."""
    d = q.shape[-1]
    (q, k, v), ctx.scale = pad_head_dim(q, k, v)
    q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    o, lse = flash_forward(q, k, v, causal=causal, causal_offset=causal_offset,
                           kv_lengths=kv_lengths, q_seg=q_seg, kv_seg=kv_seg,
                           scale=ctx.scale)
    ctx.save_for_backward(q, k, v, o, lse, kv_lengths, q_seg, kv_seg)
    ctx.causal, ctx.causal_offset, ctx.head_dim = causal, causal_offset, d
    return _unpad_head_dim(o, d), lse


def _backward_saved(ctx, do, dlse=None):
    """The autograd functions' backward: dQ then dK/dV on the saved (padded)
    inputs, with dout padded once to their head dim and the lse cotangent
    (``[B·H, Tq]``) where there is one; the gradients sliced back to the
    true head dim, and ``None`` for the non-tensor arguments."""
    q, k, v, o, lse, kv_lengths, q_seg, kv_seg = ctx.saved_tensors
    d = ctx.head_dim
    dq, dk, dv = flash_backward(
        q, k, v, o, lse, _aligned16(_pad_head_dim(do, q.shape[-1])), dlse=dlse,
        causal=ctx.causal, causal_offset=ctx.causal_offset,
        kv_lengths=kv_lengths, q_seg=q_seg, kv_seg=kv_seg, scale=ctx.scale)
    return (_unpad_head_dim(dq, d), _unpad_head_dim(dk, d),
            _unpad_head_dim(dv, d), None, None, None, None, None)


class FlashAttentionFn(torch.autograd.Function):
    """``o = attention(q, k, v)`` with the flash kernels in both directions:
    the forward saves q, k, v with ``(o, lse)``; the backward runs dQ then
    dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal, causal_offset, kv_lengths, q_seg,
                kv_seg):
        return _forward_saved(ctx, q, k, v, causal, causal_offset, kv_lengths,
                              q_seg, kv_seg)[0]

    @staticmethod
    def backward(ctx, do):
        return _backward_saved(ctx, do)


def _prepare(q, k, v, kv_lengths, segment_ids, device):
    """The public functions' shared checks and layout: ``(q_seg, kv_seg,
    kv_lengths)`` as contiguous int32 on q's device (or None)."""
    device = resolve_device(device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != device.type:
            raise ValueError(
                f"{name} lies on {t.device} but device={device}; move the "
                "inputs or pass the matching device")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, T, H, D], got shape "
                             f"{tuple(t.shape)}")
    _check_gqa_heads(q, k, v)
    q_seg = kv_seg = None
    if segment_ids is not None:
        if kv_lengths is not None:
            raise ValueError(
                "segment_ids and kv_lengths are mutually exclusive: give "
                "padded slots their own segment id instead")
        q_seg, kv_seg = _check_segment_ids(segment_ids, q.shape[1],
                                           k.shape[1])
        q_seg = q_seg.to(device=q.device, dtype=torch.int32).contiguous()
        kv_seg = kv_seg.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_lengths is not None:
        kv_lengths = kv_lengths.to(device=q.device,
                                   dtype=torch.int32).contiguous()
    return q_seg, kv_seg, kv_lengths


def flash_attention(q, k, v, causal=False, kv_lengths=None, segment_ids=None,
                    device="cuda"):
    """Tiled attention over ``[B, T, H, D]`` tensors without a ``[T, T]``
    score matrix in either direction (counterpart of the JAX package's
    ``flash_attention``).

    :param causal: mask keys after each query's last-aligned position.
    :param kv_lengths: optional ``[B]`` valid key counts; with ``causal`` the
        alignment still uses the static ``T_q``/``T_kv``.
    :param segment_ids: optional packed-batch ids: one ``[B, T]`` tensor
        (requires ``T_q == T_kv``) or a ``(q_ids, kv_ids)`` pair. Mutually
        exclusive with ``kv_lengths``.
    :param device: where the inputs must lie — ``"cuda"`` (the default, the
        hand-written kernels) or ``"cpu"`` (the plain PyTorch versions, for
        tests). A mismatch raises; nothing falls back.

    K/V may carry fewer heads than Q (``h % h_kv == 0``): each group of
    ``h // h_kv`` query heads reads one K/V head, and dK/dV come back summed
    over the group in f32.
    """
    q_seg, kv_seg, kv_lengths = _prepare(q, k, v, kv_lengths, segment_ids,
                                         device)
    causal_offset = k.shape[1] - q.shape[1]
    return FlashAttentionFn.apply(q, k, v, bool(causal), causal_offset,
                                  kv_lengths, q_seg, kv_seg)


class FlashAttentionWithLseFn(torch.autograd.Function):
    """``(o, lse) = attention(q, k, v)`` with the flash kernels in both
    directions, differentiable in both outputs. lse comes out ``[B, Tq, H]``
    with ``-inf`` on rows that see no key (the log-sum-exp of an empty set);
    the kernels' residual stays ``[B·H, Tq]`` with ``+inf`` there. The
    backward maps the lse cotangent to ``[B·H, Tq]`` and hands it to the dQ
    kernel, which folds it into delta for both backward kernels
    (``dlse = p`` summed into ds: ``ds = p (dp - delta + dlse) scale``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, causal_offset, kv_lengths, q_seg,
                kv_seg):
        o, lse = _forward_saved(ctx, q, k, v, causal, causal_offset,
                                kv_lengths, q_seg, kv_seg)
        b, t_q, h, _ = q.shape
        lse_pub = torch.where(torch.isposinf(lse), -math.inf, lse)
        return o, lse_pub.reshape(b, h, t_q).transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, do, dlse):
        b, t_q, h = dlse.shape
        return _backward_saved(ctx, do, dlse.to(torch.float32).transpose(1, 2)
                               .reshape(b * h, t_q).contiguous())


def flash_attention_with_lse(q, k, v, causal=False, causal_shift=0,
                             kv_lengths=None, segment_ids=None,
                             device="cuda"):
    """Flash attention that also returns the per-row log-sum-exp, the
    statistic that merges partial attention over K/V shards exactly (the
    ring attention's blocks). Counterpart of the JAX package's
    ``flash_attention_with_lse``.

    Returns ``(out [B, Tq, H, D], lse [B, Tq, H] f32)`` with ``lse = -inf``
    on rows with no visible key; both are differentiable. ``causal_shift``
    slides the causal diagonal: keys up to ``T_kv - T_q + causal_shift``
    past each row are visible, so ``-1`` is strict causal (the striped
    ring's blocks whose key shard sits after the query shard). The other
    arguments are :func:`flash_attention`'s.
    """
    q_seg, kv_seg, kv_lengths = _prepare(q, k, v, kv_lengths, segment_ids,
                                         device)
    causal_offset = k.shape[1] - q.shape[1] + (causal_shift if causal else 0)
    return FlashAttentionWithLseFn.apply(q, k, v, bool(causal),
                                         causal_offset, kv_lengths, q_seg,
                                         kv_seg)
