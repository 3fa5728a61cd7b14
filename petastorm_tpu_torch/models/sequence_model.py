"""Sequence encoder with sequence-parallel attention: ring and Ulysses over
``torch.distributed`` (counterpart of
``petastorm_tpu/models/sequence_model.py``).

NGram windows collated to ``[B, T, F]`` feed a small transformer-style
encoder whose attention can run sequence-parallel over a process group:

- :func:`ring_attention`: each rank holds a ``T / sp`` slice of the
  sequence, and K/V blocks rotate around the ring (``ring_permute``) while
  an online softmax accumulates, so no rank holds a ``[T, T]`` score matrix.
  The local attention is dense (:func:`ring_attention_block`) or the flash
  kernels (:func:`_ring_flash_block`: partials merged by their
  log-sum-exp); causal placement is striped (balanced) or contiguous;
- :func:`ulysses_attention`: two tiled all-to-alls reshard from
  sequence-split to head-split and back, and each rank attends over the
  whole sequence for its ``H / sp`` heads.

Both keep the JAX package's global view (``torch_utils/sharding.py``): the
model runs on the whole ``[B, T, ...]`` activations on every rank and only
attention is split over T. A process group stands where the JAX code has a
mesh; ``group=None`` means one process. Unlike the JAX package, no path
falls back to dense attention below 8 timesteps: that rule exists for the
TPU's sublane tile, and the CUDA kernels take any T.

:func:`attention_reference` is the dense oracle every path is held to.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from petastorm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
    resolve_device,
)
from petastorm_tpu_torch.torch_utils.sharding import (
    all_to_all,
    enter_sequence_parallel,
    group_rank_size,
    leave_sequence_parallel,
    rank_slice,
    ring_permute,
)

#: Full-sequence length at or above which ``local_attn="auto"`` picks the
#: flash kernels' plain versions over dense attention for CPU tensors (the
#: JAX package's rule). For CUDA tensors ``"auto"`` is always the kernels.
ULYSSES_FLASH_THRESHOLD = 1024

_SEQ_WEIGHTS = ("embed", "pos", "wq", "wk", "wv", "wo", "cls")


def attention_reference(q, k, v, causal=False, lengths=None,
                        segment_ids=None):
    """Plain scaled-dot-product attention over ``[B, T, H, Dh]``.

    ``causal`` masks keys after each query's last-aligned position;
    ``lengths`` ``[B]`` masks keys at or past ``lengths[b]``; ``segment_ids``
    ``[B, T]`` keeps attention within a packed segment (requires
    ``T_q == T_kv``). Rows with no valid key give zero output, NaN-free in
    both directions.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    t_q, t_kv = q.shape[1], k.shape[1]
    dev = q.device
    mask = None
    if causal:
        row = torch.arange(t_q, device=dev)[:, None] + (t_kv - t_q)
        mask = (torch.arange(t_kv, device=dev)[None, :] <= row)[None, None]
    if lengths is not None:
        valid = (torch.arange(t_kv, device=dev)[None, :]
                 < lengths.to(dev)[:, None])[:, None, None, :]
        mask = valid if mask is None else mask & valid
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = same if mask is None else mask & same
    row_valid = None
    if mask is not None:
        row_valid = mask.any(dim=-1, keepdim=True)
        scores = torch.where(mask, scores, -math.inf)
        scores = torch.where(row_valid, scores, 0.0)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if row_valid is not None:
        probs = torch.where(row_valid, probs, 0.0)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def _stripe(x, sp):
    """Permute the T axis of ``[B, T, ...]`` so that contiguous shard r of
    the result holds positions r, r + sp, r + 2 sp, ... (the striped
    placement of the causal ring)."""
    b, t = x.shape[:2]
    return x.reshape((b, t // sp, sp) + x.shape[2:]).transpose(1, 2).reshape(x.shape)


def _unstripe(x, sp):
    b, t = x.shape[:2]
    return x.reshape((b, sp, t // sp) + x.shape[2:]).transpose(1, 2).reshape(x.shape)


def _not_empty(x):
    return ~torch.isneginf(x)


def _exp_or_zero(x):
    """``exp(x)`` with ``-inf`` giving 0 and no ``inf`` on the gradient's
    way: the exponent's argument is guarded, not only its result."""
    ok = _not_empty(x)
    return torch.where(ok, torch.exp(torch.where(ok, x, 0.0)), 0.0)


def _merge(state, o_b, lse_b):
    """Fold a normalized partial ``(o_b [B, L, H, D], lse_b [B, L, H])`` into
    the running ``(num, m, den)``: the exact blockwise-softmax combination,
    NaN-free in both directions for rows that see no key in any block."""
    num, m, den = state
    m_new = torch.maximum(m, lse_b)
    safe = torch.where(_not_empty(m_new), m_new, 0.0)
    alpha = _exp_or_zero(torch.where(_not_empty(m), m - safe, -math.inf))
    beta = _exp_or_zero(torch.where(_not_empty(lse_b), lse_b - safe, -math.inf))
    num = num * alpha[..., None] + o_b.float() * beta[..., None]
    return num, m_new, den * alpha + beta


def _positions(placement, rank, sp, l, device):
    """Original positions of the local indices of shard ``rank``."""
    j = torch.arange(l, device=device)
    return rank + sp * j if placement == "striped" else rank * l + j


def _ring(k, v, segment_ids, state, group, update):
    """The ring loop both block kinds share: at step i the resident K/V
    block (with its ids) came from rank ``src = (r - i) mod sp``;
    ``update(k, v, kv_ids, state, src)`` folds it into ``state``, and the
    block moves one rank on (``sp - 1`` permutes) with ``state`` riding the
    same autograd node (see ``sharding.ring_permute``). Returns the final
    state."""
    r, sp = group_rank_size(group)
    blocks = (k, v) if segment_ids is None else (k, v, segment_ids)
    for i in range(sp):
        state = update(blocks[0], blocks[1], blocks[2] if len(blocks) > 2 else None,
                       state, (r - i) % sp)
        if i < sp - 1:
            moved = ring_permute(blocks, state, group)
            blocks, state = moved[:len(blocks)], moved[len(blocks):]
    return state


def ring_attention_block(q, k, v, group=None, causal=False,
                         placement="contiguous", lengths=None,
                         segment_ids=None):
    """Per-rank ring attention with dense local blocks.

    ``q, k, v``: the rank's slice ``[B, L, H, Dh]`` (``L = T / sp``). K/V
    blocks (and, with ``segment_ids``, the block's ids) move ``sp - 1``
    times around the ring; an f32 online softmax makes the result equal to
    attention over the whole sequence. At step i the resident block came
    from rank ``src = (r - i) mod sp``, so original key positions are known
    and causal and ``lengths`` masks apply per block. ``placement``:
    ``"contiguous"`` (rank r owns positions ``[r L, (r + 1) L)``; blocks
    wholly in the future are skipped) or ``"striped"`` (rank r owns r,
    r + sp, ...; :func:`ring_attention` stripes and unstripes). GQA K/V ride
    the ring at their grouped head count and are repeated only here.
    """
    r, sp = group_rank_size(group)
    b, l, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf = q.float()
    rep = h // k.shape[2]
    q_pos = _positions(placement, r, sp, l, q.device)

    def update(k_cur, v_cur, kseg, state, src):
        if causal and placement == "contiguous" and src > r:
            return state  # a block wholly in the future
        acc, row_max, row_sum = state
        if rep > 1:
            k_cur = k_cur.repeat_interleave(rep, dim=2)
            v_cur = v_cur.repeat_interleave(rep, dim=2)
        scores = torch.einsum("blhd,bmhd->bhlm", qf, k_cur.float()) * scale
        mask = torch.ones((1, 1, l, l), dtype=torch.bool, device=q.device)
        if segment_ids is not None:
            mask = mask & (segment_ids[:, :, None] == kseg[:, None, :])[:, None]
        k_pos = _positions(placement, src, sp, l, q.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])[None, None]
        if lengths is not None:
            mask = mask & (k_pos[None, :] < lengths[:, None])[:, None, None, :]
        scores = torch.where(mask, scores, -math.inf)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        safe = torch.where(_not_empty(new_max), new_max, 0.0)
        correction = _exp_or_zero(torch.where(_not_empty(row_max), row_max - safe,
                                              -math.inf))
        probs = _exp_or_zero(torch.where(mask, scores - safe[..., None], -math.inf))
        acc = acc * correction[..., None] + torch.einsum(
            "bhlm,bmhd->bhld", probs, v_cur.float())
        return acc, new_max, row_sum * correction + probs.sum(dim=-1)

    state = (torch.zeros((b, h, l, dh), device=q.device),
             torch.full((b, h, l), -math.inf, device=q.device),
             torch.zeros((b, h, l), device=q.device))
    acc, _, row_sum = _ring(k, v, segment_ids, state, group, update)
    out = acc / torch.clamp(row_sum, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _ring_flash_block(q, k, v, group=None, causal=False,
                      placement="contiguous", lengths=None, segment_ids=None):
    """Per-rank ring attention with the flash kernels as the local
    attention: no ``[L, L]`` score block anywhere, forward or backward.

    Each resident K/V block attends through :func:`flash_attention_with_lse`
    and the ``(out, lse)`` partials fold into a running ``(num, m, den)``
    by their log-sum-exp (:func:`_merge`). Causal masking per block: striped
    placement runs the kernels' causal diagonal with ``causal_shift`` 0 when
    the key shard is at or before the query shard in the interleaved order
    (``src <= r``) and -1 (strict) after it; contiguous placement skips
    blocks wholly in the future and runs the diagonal block causally.
    ``lengths`` become per-block ``kv_lengths``; ``segment_ids`` go in as a
    ``(q_ids, kv_ids)`` pair, the kv ids riding the ring with their block.
    The backward is the kernels' own, the lse cotangent included.
    """
    r, sp = group_rank_size(group)
    b, l, h, dh = q.shape
    striped = placement == "striped"

    def block_lens(src):
        if lengths is None:
            return None
        if striped:  # k_pos = src + sp j < len  <=>  j < ceil((len - src) / sp)
            cnt = torch.div(lengths - src + sp - 1, sp, rounding_mode="floor")
        else:
            cnt = lengths - src * l
        return torch.clamp(cnt, 0, l).int()

    def update(k_cur, v_cur, kseg, state, src):
        if not causal:
            causal_, shift = False, 0
        elif striped:
            causal_, shift = True, 0 if src <= r else -1
        elif src <= r:  # contiguous: the diagonal block causal, past ones whole
            causal_, shift = src == r, 0
        else:
            return state  # a block wholly in the future
        o_b, lse_b = flash_attention_with_lse(
            q, k_cur, v_cur, causal=causal_, causal_shift=shift,
            kv_lengths=block_lens(src), device=q.device,
            segment_ids=None if segment_ids is None else (segment_ids, kseg))
        return _merge(state, o_b, lse_b)

    state = (torch.zeros((b, l, h, dh), device=q.device),
             torch.full((b, l, h), -math.inf, device=q.device),
             torch.zeros((b, l, h), device=q.device))
    num, _, den = _ring(k, v, segment_ids, state, group, update)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def _check_sequence_split(t, sp):
    if t % sp:
        raise ValueError(
            f"sequence length {t} does not split over {sp} sequence-parallel "
            "ranks")


def ring_attention(q, k, v, group=None, causal=False, placement="striped",
                   lengths=None, segment_ids=None, local_attn="dense"):
    """Sequence-parallel attention over the ranks of ``group``.

    Inputs are global ``[B, T, H, Dh]`` tensors, the same on every rank; the
    output is the global attention, equal to :func:`attention_reference`
    up to float rounding, on every rank. ``causal``: decoder-style masking;
    ``placement`` (causal only) ``"striped"`` (every rank does equal work
    per ring step) or ``"contiguous"`` (skips wholly-future blocks, so ranks
    wait on the busiest one); the output is always in natural order.
    ``lengths`` ``[B]`` masks keys at or past ``lengths[b]`` by original
    position. ``segment_ids`` ``[B, T]``: packed batches, the ids riding the
    K/V ring. ``local_attn``: ``"dense"`` (per-step ``[L, L]`` scores),
    ``"flash"`` (the flash kernels, partials merged by log-sum-exp) or
    ``"auto"`` (see :func:`_resolve_local_attn`).
    """
    _, sp = group_rank_size(group)
    if v.shape[2] != k.shape[2]:
        raise ValueError(
            f"k has {k.shape[2]} heads but v has {v.shape[2]}; K and V "
            "must share their (possibly grouped) head count")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"ring_attention grouped-query heads must divide: q has "
            f"{q.shape[2]} heads, k/v have {k.shape[2]}")
    local_attn = _resolve_local_attn(q, q.shape[1], local_attn)
    if (causal or lengths is not None or segment_ids is not None) \
            and q.shape[1] != k.shape[1]:
        raise ValueError(
            "causal/lengths/segment ring attention requires T_q == T_kv "
            f"(got {q.shape[1]} vs {k.shape[1]})")
    if lengths is not None and segment_ids is not None:
        raise ValueError(
            "segment_ids and lengths are mutually exclusive: give padded "
            "slots their own segment id instead")
    _check_sequence_split(q.shape[1], sp)
    _check_sequence_split(k.shape[1], sp)
    striped = causal and placement == "striped"
    if striped:
        q, k, v = _stripe(q, sp), _stripe(k, sp), _stripe(v, sp)
        if segment_ids is not None:
            segment_ids = _stripe(segment_ids, sp)
    if lengths is not None:
        lengths = lengths.to(q.device)
    if segment_ids is not None:
        segment_ids = rank_slice(segment_ids.to(q.device), group)
    block = _ring_flash_block if local_attn == "flash" else ring_attention_block
    q, k, v = enter_sequence_parallel((q, k, v), group)
    out = block(q, k, v, group=group, causal=causal,
                placement="striped" if striped else "contiguous",
                lengths=lengths, segment_ids=segment_ids)
    out = leave_sequence_parallel(out, group)
    return _unstripe(out, sp) if striped else out


def _resolve_local_attn(q, t_full, local_attn):
    """Resolve ``local_attn``: ``"auto"`` is the flash kernels for CUDA
    tensors and, for CPU tensors, flash from ``ULYSSES_FLASH_THRESHOLD``
    timesteps of the full sequence (``t_full``) and dense below."""
    if local_attn == "auto":
        local_attn = ("flash" if q.is_cuda or t_full >= ULYSSES_FLASH_THRESHOLD
                      else "dense")
    if local_attn not in ("dense", "flash"):
        raise ValueError(f"local_attn {local_attn!r} is not 'auto', "
                         "'dense', or 'flash'")
    return local_attn


def ulysses_attention_block(q, k, v, group=None, causal=False,
                            local_attn="auto", lengths=None,
                            segment_ids=None):
    """Per-rank Ulysses (all-to-all) attention: the rank's slice ``[B, L,
    H, Dh]`` is traded for the whole sequence of its ``H / sp`` heads (a
    tiled all-to-all), attended (dense or the flash kernels, with the whole
    ``lengths`` / ``[B, T]`` ``segment_ids``), and traded back."""
    _, sp = group_rank_size(group)
    b, l, h, dh = q.shape
    if h % sp:
        raise ValueError(
            f"ulysses attention needs heads ({h}) divisible by the mesh "
            f"axis ({sp}); use ring attention otherwise")
    qh, kh, vh = all_to_all((q, k, v), split_axis=2, concat_axis=1, group=group)
    if _resolve_local_attn(q, l * sp, local_attn) == "flash":
        out = flash_attention(qh, kh, vh, causal=causal, kv_lengths=lengths,
                              segment_ids=segment_ids, device=q.device)
    else:
        out = attention_reference(qh, kh, vh, causal=causal, lengths=lengths,
                                  segment_ids=segment_ids)
    return all_to_all((out,), split_axis=1, concat_axis=2, group=group)[0]


def ulysses_attention(q, k, v, group=None, causal=False, local_attn="auto",
                      lengths=None, segment_ids=None):
    """All-to-all sequence-parallel attention over the ranks of ``group``:
    :func:`ring_attention`'s contract (global ``[B, T, H, Dh]`` in and out),
    with ``H`` divisible by the group size and no grouped-query K/V."""
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise NotImplementedError(
            f"ulysses_attention reshards HEADS over the sequence axis, so "
            f"grouped-query K/V (q {q.shape[2]} heads vs k/v "
            f"{k.shape[2]}/{v.shape[2]}) is not supported — use "
            "ring_attention (its K/V ring permutes the grouped heads "
            "directly, shrinking ICI traffic by the group factor) or "
            "repeat K/V to the query head count first")
    local_attn = _resolve_local_attn(q, q.shape[1], local_attn)
    if lengths is not None and segment_ids is not None:
        raise ValueError(
            "segment_ids and lengths are mutually exclusive: give padded "
            "slots their own segment id instead")
    _check_sequence_split(q.shape[1], group_rank_size(group)[1])
    if lengths is not None:
        lengths = lengths.to(q.device)
    if segment_ids is not None:
        segment_ids = segment_ids.to(q.device)
    q, k, v = enter_sequence_parallel((q, k, v), group)
    out = ulysses_attention_block(q, k, v, group=group, causal=causal,
                                  local_attn=local_attn, lengths=lengths,
                                  segment_ids=segment_ids)
    return leave_sequence_parallel(out, group)


# --- a small encoder around it -------------------------------------------

class SeqModel(nn.Module):
    """embed -> (q, k, v, o) attention -> mean pool -> classifier, with the
    JAX package's parameter names and layouts (``x @ w``, ``w`` of shape
    ``[d_in, d_out]``)."""

    def __init__(self, feature_dim, d_model=64, num_heads=4, num_classes=10,
                 max_len=512):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} does not split over "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        shapes = {"embed": (feature_dim, d_model), "pos": (max_len, d_model),
                  "wq": (d_model, d_model), "wk": (d_model, d_model),
                  "wv": (d_model, d_model), "wo": (d_model, d_model),
                  "cls": (d_model, num_classes)}
        for name in _SEQ_WEIGHTS:
            setattr(self, name, nn.Parameter(torch.empty(shapes[name])))

    def forward(self, windows, group=None, compute_dtype=torch.bfloat16,
                attn_impl="dense", causal=False, lengths=None,
                local_attn="auto"):
        """:func:`apply_seq_model` on this module."""
        return apply_seq_model(self, windows, group=group,
                               compute_dtype=compute_dtype,
                               attn_impl=attn_impl, causal=causal,
                               lengths=lengths, local_attn=local_attn)


def init_seq_params(seed, feature_dim, d_model=64, num_heads=4,
                    num_classes=10, max_len=512, device="cuda"):
    """A :class:`SeqModel` with the JAX package's initial distributions
    (weights ~ N(0, 1/fan_in), pos ~ N(0, 0.02^2)), drawn from
    ``torch.Generator().manual_seed(seed)``."""
    device = resolve_device(device)
    model = SeqModel(feature_dim, d_model, num_heads, num_classes, max_len)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in _SEQ_WEIGHTS:
            w = getattr(model, name)
            std = 0.02 if name == "pos" else 1.0 / math.sqrt(w.shape[0])
            w.copy_(torch.randn(w.shape, generator=gen) * std)
    return model.to(device)


def params_from_jax(numpy_params, num_heads, device="cuda"):
    """The JAX package's ``init_seq_params`` pytree (numpy arrays) as a
    :class:`SeqModel` on ``device``; layouts match, arrays are copied."""
    device = resolve_device(device)
    arrays = {name: np.asarray(numpy_params[name], np.float32)
              for name in _SEQ_WEIGHTS}
    model = SeqModel(arrays["embed"].shape[0], arrays["embed"].shape[1],
                     num_heads, arrays["cls"].shape[1], arrays["pos"].shape[0])
    with torch.no_grad():
        for name in _SEQ_WEIGHTS:
            getattr(model, name).copy_(torch.tensor(arrays[name]))
    return model.to(device)


def apply_seq_model(model, windows, group=None, compute_dtype=torch.bfloat16,
                    attn_impl="dense", causal=False, lengths=None,
                    local_attn="auto"):
    """``windows`` ``[B, T, F]`` float -> f32 logits ``[B, num_classes]``.

    With ``group``: sequence-parallel attention over its ranks (T must
    split over them), ``attn_impl="ring"`` (``"dense"`` means ring here) or
    ``"ulysses"`` (heads must split over them). Without: ``"dense"`` (the
    oracle; ``"ring"`` maps here, its one-process equivalent) or ``"flash"``
    (the flash kernels). ``causal`` masks decoder-style in every path;
    ``lengths`` ``[B]``: positions at or past ``lengths[b]`` neither attend
    nor are attended to nor pooled. ``local_attn``: the sequence-parallel
    paths' local attention (see :func:`ring_attention`).
    """
    h = model.num_heads
    cd = compute_dtype
    x = windows.to(cd) @ model.embed.to(cd)
    b, t, d = x.shape
    x = x + model.pos[:t].to(cd)

    def split(w):
        return (x @ w.to(cd)).reshape(b, t, h, d // h)

    q, k, v = split(model.wq), split(model.wk), split(model.wv)
    if lengths is not None:
        lengths = lengths.to(x.device)
    if group is not None:
        if attn_impl == "dense":
            attn_impl = "ring"
        if attn_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"attn_impl {attn_impl!r} is not a sequence-parallel "
                f"implementation; with a mesh use 'ring' or 'ulysses'")
        parallel_attn = (ulysses_attention if attn_impl == "ulysses"
                         else ring_attention)
        attn = parallel_attn(q, k, v, group, causal=causal, lengths=lengths,
                             local_attn=local_attn)
    elif attn_impl in ("ring", "dense"):
        attn = attention_reference(q, k, v, causal=causal, lengths=lengths)
    elif attn_impl == "flash":
        attn = flash_attention(q, k, v, causal=causal, kv_lengths=lengths,
                               device=x.device)
    else:
        raise ValueError(
            f"attn_impl {attn_impl!r} is not valid without a mesh "
            f"('ulysses' needs one); use 'dense', 'ring', or 'flash'")
    attn = attn.reshape(b, t, d) @ model.wo.to(cd)
    if lengths is None:
        pooled = attn.mean(dim=1)
    else:
        valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        pooled = ((attn * valid[..., None].to(attn.dtype)).sum(dim=1)
                  / torch.clamp(lengths[:, None], min=1).to(attn.dtype))
    return (pooled @ model.cls.to(cd)).float()


def seq_loss(model, windows, labels, mask, lengths=None, **apply_kwargs):
    """Masked mean cross-entropy of :func:`apply_seq_model`'s logits."""
    logits = apply_seq_model(model, windows, lengths=lengths, **apply_kwargs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    nll = torch.where(mask, nll, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1).float()


def make_seq_train_step(model, learning_rate=0.05, group=None,
                        attn_impl="ring", causal=False, local_attn="auto",
                        compute_dtype=torch.bfloat16):
    """``step(windows, labels, mask, lengths=None) -> loss``: masked
    cross-entropy and one SGD step on ``model``'s parameters, updated in
    place; sequence-parallel attention over ``group`` when one is given.
    Every rank of the group takes the same step on the same batch, so the
    ranks' weights stay equal."""
    kwargs = dict(group=group, attn_impl=attn_impl, causal=causal,
                  local_attn=local_attn, compute_dtype=compute_dtype)

    def step(windows, labels, mask, lengths=None):
        model.zero_grad(set_to_none=True)
        loss = seq_loss(model, windows, labels, mask, lengths, **kwargs)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= learning_rate * p.grad
        return loss.detach()

    return step
