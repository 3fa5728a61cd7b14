"""The work counters against brute-force counts over small masks."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import work


def brute_pairs(seg):
    seg = np.asarray(seg)
    pairs = 0
    for row in seg:
        for i in range(row.size):
            for j in range(i + 1):
                pairs += int(row[i] >= 0 and row[i] == row[j])
    return pairs


CASES = {
    "one document": [[0] * 9],
    "packed": [[0, 0, 0, 1, 1, 2, 2, 2, 2]],
    "packed with padding": [[0, 0, 1, 1, 1, -1, -1, -1], [0, 0, 0, 0, 0, 0, 0, 0]],
    "all padding": [[-1, -1, -1, -1]],
    "single tokens": [[0, 1, 2, 3, -1]],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_visible_pairs_match_a_brute_force_count(name):
    seg = np.array(CASES[name], np.int32)
    assert work.visible_pairs(seg) == brute_pairs(seg)
    assert work.real_tokens(seg) == int((seg >= 0).sum())


def test_visible_pairs_on_random_packings():
    rng = np.random.RandomState(0)
    for _ in range(20):
        rows = []
        for _ in range(3):
            lengths = rng.randint(1, 6, size=rng.randint(1, 5))
            row = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)])
            rows.append(np.concatenate([row, np.full(24 - row.size, -1)]))
        seg = np.stack(rows).astype(np.int32)
        assert work.visible_pairs(seg) == brute_pairs(seg)


def test_attention_flops_count_each_product_once():
    # One pair, one head of D: QK^T and PV are 2D each forward; dV, dP, dQ,
    # dK are 2D each backward.
    fwd, bwd = work.attention_flops(1, num_heads=1, head_dim=8)
    assert (fwd, bwd) == (4 * 8, 8 * 8)
    fwd, bwd = work.attention_flops(10, num_heads=3, head_dim=8)
    assert (fwd, bwd) == (10 * 3 * 32, 10 * 3 * 64)


def test_flash_bytes_read_each_input_once():
    b, t, h, d = 2, 16, 3, 8
    tensor, lse, seg = b * t * h * d * 4, b * h * t * 4, b * t * 4
    assert work.flash_bytes(b, t, h, d) == (4 * tensor + lse + seg, 7 * tensor + lse + seg)


def test_model_flops_count_the_decoders_matmul_parameters():
    from petastorm_tpu_torch.models.long_context_lm import LongContextLM

    d, layers, vocab = 16, 3, 50
    model = LongContextLM(d, 2, layers, slot_len=32, vocab=vocab)
    matmul = sum(p.numel() for n, p in model.named_parameters() if n.startswith("blocks"))
    matmul += model.embed.numel()  # the tied head
    assert work.lm_matmul_params(d, layers, vocab) == matmul
    seg = np.array([[0, 0, 0, 1, 1, -1]], np.int32)
    tokens, pairs = work.real_tokens(seg), work.visible_pairs(seg)
    fwd, bwd = work.attention_flops(pairs, 2, d // 2)
    assert work.lm_model_flops(tokens, pairs, d, layers, 2, vocab) == (
        6 * matmul * tokens + layers * (fwd + bwd))


def test_least_seconds_takes_the_binding_roof():
    peaks = work.PEAKS
    assert work.least_seconds(peaks["tf32_flops"], 0) == pytest.approx(1.0)
    assert work.least_seconds(0, peaks["hbm_bytes_per_s"]) == pytest.approx(1.0)
    assert work.least_seconds(peaks["tf32_flops"], 2 * peaks["hbm_bytes_per_s"]) == \
        pytest.approx(2.0)
