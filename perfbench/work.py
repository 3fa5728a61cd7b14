"""Work counters and the card's peaks: the yardstick's arithmetic.

Everything here is counted from the inputs, never from what a kernel
visits, so a kernel that skips more tiles or a step that computes less
padding reads the same work and a shorter time.

A visible pair is a (query row, key row) pair of one packed slot that
causal attention within a document must compute: the key is not after the
query, both carry the same segment id, and that id is not padding (< 0).
"""

from __future__ import annotations

import numpy as np

#: Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), at
#: the full 700 W power limit.
PEAKS = {
    "tf32_flops": 495e12,   # the highest rate at which it multiplies f32 inputs
    "bf16_flops": 989e12,
    "fp32_simt_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def segment_lengths(segment_ids):
    """Lengths of the real documents of each packed slot, as one flat int64
    array: ``segment_ids`` is ``[slots, slot_len]`` with -1 for padding."""
    seg = np.asarray(segment_ids)
    lengths = []
    for row in seg:
        real = row[row >= 0]
        if real.size:
            lengths.append(np.bincount(real).astype(np.int64))
    return np.concatenate(lengths) if lengths else np.zeros(0, np.int64)


def visible_pairs(segment_ids):
    """Causal same-document (query, key) pairs of a packed batch."""
    n = segment_lengths(segment_ids)
    n = n[n > 0]
    return int((n * (n + 1) // 2).sum())


def real_tokens(segment_ids):
    """Non-padding positions of a packed batch."""
    return int((np.asarray(segment_ids) >= 0).sum())


def attention_flops(pairs, num_heads, head_dim):
    """``(forward, backward)`` matmul FLOPs of attention over ``pairs``
    visible pairs: the forward multiplies QK^T and PV (2 x 2 x D a pair a
    head); the backward dV, dP, dQ and dK (4 x 2 x D). The backward's
    recomputation of P is not counted."""
    per = 2 * head_dim * num_heads * pairs
    return 2 * per, 4 * per


def flash_bytes(batch, seq_len, num_heads, head_dim, itemsize=4):
    """``(forward, backward)`` bytes of one attention call, each input read
    once and each output written once. Forward: q, k, v, the segment ids
    in; o and the log-sum-exp out. Backward: q, k, v, o, dO, lse and the
    segment ids in; dQ, dK, dV out."""
    tensor = batch * seq_len * num_heads * head_dim * itemsize
    lse = batch * num_heads * seq_len * 4
    seg = batch * seq_len * 4
    return 4 * tensor + lse + seg, 7 * tensor + lse + seg


def lm_matmul_params(d_model, num_layers, vocab):
    """Matmul parameters a token meets in the decoder: wq, wk, wv, wo and
    the FFN (5 d^2 a layer) and the output head tied to the embedding
    (vocab x d). The embedding and position lookups are no matmul."""
    return 5 * d_model * d_model * num_layers + vocab * d_model


def lm_model_flops(tokens, pairs, d_model, num_layers, num_heads, vocab):
    """Model FLOPs of a training step (forward and backward): 6 x the
    matmul parameters a real token, plus attention's over the batch's
    visible pairs in every layer."""
    fwd, bwd = attention_flops(pairs, num_heads, d_model // num_heads)
    return (6 * lm_matmul_params(d_model, num_layers, vocab) * tokens
            + num_layers * (fwd + bwd))


def least_seconds(flops, nbytes, flops_peak=PEAKS["tf32_flops"],
                  bytes_peak=PEAKS["hbm_bytes_per_s"]):
    """The roofline's least time: the larger of compute and memory time."""
    return max(flops / flops_peak, nbytes / bytes_peak)
