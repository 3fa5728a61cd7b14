"""Dense attention oracle (counterpart of
``petastorm_tpu/models/sequence_model.py::attention_reference``).

The sequence-parallel ring and Ulysses attention of that module are not
ported yet; on one card the long-context LM calls the flash kernels
directly and holds them against this oracle.
"""

from __future__ import annotations

import math

import torch


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
