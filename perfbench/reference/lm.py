"""The decoder LM's training step, written from its equations.

For a packed batch of token ids ``x`` ``[B, T]``, positions ``p`` and
segment ids ``s`` (-1 on padding), with weights ``E`` [V, d], ``P``
[P_max, d] and per layer ``Wq, Wk, Wv, Wo, F`` [d, d]:

    h_0 = E[x] + P[p]
    a_l = attention(h Wq, h Wk, h Wv)      H heads of d/H, scale 1/sqrt(d/H)
    h'  = h + a_l Wo
    h_{l+1} = h' + tanh(h' F)
    logits = h_L E^T

Query ``i`` sees key ``j`` when ``j <= i``, ``s_i == s_j`` and ``s_i >= 0``;
a row that sees no key outputs zero. The loss is the mean cross-entropy of
token ``t + 1`` over the positions ``t`` whose next position continues the
same (non-padding) document. One step is plain SGD: ``w <- w - lr * grad``.

Attention is dense and masked, computed in blocks of query rows (the
backward recomputes each block's probabilities), so a slot of 8,192
positions fits. Every matrix product goes through
:func:`~perfbench.reference.precision.matmul`, so the whole step can be
computed in a lower precision for the control.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.precision import matmul, plain_matmul
from perfbench.weights import BLOCK_WEIGHTS

Q_BLOCK = 1024


def visible(seg_q, seg_k, rows, cols):
    """[Tq, Tk] mask: causal, same segment, not padding."""
    return ((cols[None, :] <= rows[:, None]) & (seg_q[:, None] == seg_k[None, :])
            & (seg_q[:, None] >= 0))


class _BlockAttention(torch.autograd.Function):
    """``[B, T, H, D]`` dense masked attention, in blocks of query rows."""

    @staticmethod
    def forward(ctx, q, k, v, seg, precision):
        b, t, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))       # [B, H, T, D]
        o = torch.zeros_like(qh)
        lse = torch.full((b, h, t), float("inf"), device=q.device)
        idx = torch.arange(t, device=q.device)
        for i in range(b):
            for s in range(0, t, Q_BLOCK):
                e = min(t, s + Q_BLOCK)
                mask = visible(seg[i, s:e], seg[i, :e], idx[s:e], idx[:e])
                scores = plain_matmul(qh[i, :, s:e], kh[i, :, :e].transpose(-1, -2),
                                      precision) * scale
                scores = scores.masked_fill(~mask, float("-inf"))
                m = scores.amax(-1, keepdim=True)
                m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
                p = torch.exp(scores - m)
                l = p.sum(-1, keepdim=True)
                p = p / torch.where(l > 0, l, torch.ones_like(l))
                o[i, :, s:e] = plain_matmul(p, vh[i, :, :e], precision)
                lse[i, :, s:e] = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(l[..., 0]),
                                             torch.full_like(l[..., 0], float("inf")))
        ctx.save_for_backward(qh, kh, vh, o, lse, seg)
        ctx.precision, ctx.scale = precision, scale
        return o.permute(0, 2, 1, 3)

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, o, lse, seg = ctx.saved_tensors
        precision, scale = ctx.precision, ctx.scale
        b, h, t, d = qh.shape
        doh = do.permute(0, 2, 1, 3)
        dq, dk, dv = (torch.zeros_like(x) for x in (qh, kh, vh))
        idx = torch.arange(t, device=qh.device)
        for i in range(b):
            for s in range(0, t, Q_BLOCK):
                e = min(t, s + Q_BLOCK)
                mask = visible(seg[i, s:e], seg[i, :e], idx[s:e], idx[:e])
                scores = plain_matmul(qh[i, :, s:e], kh[i, :, :e].transpose(-1, -2),
                                      precision) * scale
                p = torch.exp(scores - lse[i, :, s:e, None]).masked_fill(~mask, 0.0)
                dob = doh[i, :, s:e]
                dv[i, :, :e] += plain_matmul(p.transpose(-1, -2), dob, precision)
                dp = plain_matmul(dob, vh[i, :, :e].transpose(-1, -2), precision)
                delta = (dob * o[i, :, s:e]).sum(-1, keepdim=True)
                ds = p * (dp - delta)
                dq[i, :, s:e] = plain_matmul(ds, kh[i, :, :e], precision) * scale
                dk[i, :, :e] += plain_matmul(ds.transpose(-1, -2), qh[i, :, s:e],
                                             precision) * scale
        back = (x.permute(0, 2, 1, 3) for x in (dq, dk, dv))
        return (*back, None, None)


def loss(leaves, tokens, positions, seg, num_layers, num_heads, precision="f32"):
    """The mean next-token cross-entropy of one packed batch."""
    tokens, positions = tokens.long(), positions.long()
    b, t = tokens.shape
    embed = leaves["embed"]
    d = embed.shape[1]
    h = embed[tokens] + leaves["pos"][positions]
    for layer in range(num_layers):
        w = {name: leaves[f"blocks.{layer}.{name}"] for name in BLOCK_WEIGHTS}
        q, k, v = (matmul(h, w[n], precision).reshape(b, t, num_heads, d // num_heads)
                   for n in ("wq", "wk", "wv"))
        a = _BlockAttention.apply(q, k, v, seg, precision).reshape(b, t, d)
        h = h + matmul(a, w["wo"], precision)
        h = h + torch.tanh(matmul(h, w["ffn"], precision))
    logits = matmul(h, embed.transpose(0, 1), precision)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, 2, tokens[:, 1:, None])[..., 0]
    cont = ((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] >= 0)).float()
    return (nll * cont).sum() / torch.clamp(cont.sum(), min=1.0)


def train(leaves, batches, cfg, learning_rate, precision="f32"):
    """SGD steps on ``batches`` (``(tokens, positions, segment_ids)``),
    updating ``leaves`` (f32, drawn from the seed) in place; yields each
    step's loss once the step's update is done."""
    for tokens, positions, seg in batches:
        params = {name: p.detach().requires_grad_(True) for name, p in leaves.items()}
        value = loss(params, tokens, positions, seg, cfg["num_layers"], cfg["num_heads"],
                     precision)
        grads = torch.autograd.grad(value, list(params.values()))
        with torch.no_grad():
            for (name, p), g in zip(leaves.items(), grads):
                p -= learning_rate * g
        del grads, params
        yield value.detach()
