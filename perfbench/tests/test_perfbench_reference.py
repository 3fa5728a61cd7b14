"""The frozen references against the port on the CPU, at tiny sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import compare, weights
from perfbench.reference import dlrm as ref_dlrm
from perfbench.reference import lm as ref_lm
from perfbench.reference import packing as ref_packing
from perfbench.reference import precision
from perfbench.reference import rows as ref_rows

LM_CFG = dict(d_model=32, num_heads=2, num_layers=2, vocab_size=61, max_positions=64)
DLRM_CFG = dict(num_dense=13, num_sparse=26, embed_dim=8, table_rows=50, bottom_hidden=16,
                top_hidden=16)


def _packed_batch(seed, slots=2, slot_len=64):
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, LM_CFG["vocab_size"], size=n).astype(np.int32)
            for n in rng.randint(3, 40, size=8)]
    batches = ref_packing.first_fit(docs, slots, slot_len)
    return [torch.from_numpy(x) for x in batches[0]]


def _port_lm(leaves):
    from petastorm_tpu_torch.models.long_context_lm import LongContextLM

    model = LongContextLM(LM_CFG["d_model"], LM_CFG["num_heads"], LM_CFG["num_layers"],
                          slot_len=LM_CFG["max_positions"], vocab=LM_CFG["vocab_size"])
    model.load_state_dict({k: v.clone() for k, v in leaves.items()})
    return model


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_reference_matches_the_port(seed):
    from petastorm_tpu_torch.models.long_context_lm import lm_loss

    leaves = weights.lm_leaves(seed, LM_CFG, "cpu")
    tokens, pos, seg = _packed_batch(seed)
    model = _port_lm(leaves)
    loss = lm_loss(model, tokens, pos, seg, attn_impl="flash")
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    ref = ref_lm.loss(params, tokens, pos, seg, LM_CFG["num_layers"], LM_CFG["num_heads"])
    grads = torch.autograd.grad(ref, list(params.values()))
    assert float(ref.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    for (name, p), g in zip(model.named_parameters(), grads):
        torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-6, msg=name)


def test_lm_reference_keeps_documents_apart():
    # The packed batch's loss is the token-weighted mean of each document's
    # loss alone in a slot: attention and the loss never cross a boundary.
    leaves = weights.lm_leaves(0, LM_CFG, "cpu")
    tokens, pos, seg = _packed_batch(3)
    packed = float(ref_lm.loss(leaves, tokens, pos, seg, 2, 2))
    total, weight = 0.0, 0
    for b in range(seg.shape[0]):
        for s in range(int(seg[b].max()) + 1):
            where = seg[b] == s
            n = int(where.sum())
            alone = torch.full_like(seg[:1], -1)
            alone[0, :n] = 0
            toks = torch.zeros_like(tokens[:1])
            toks[0, :n] = tokens[b][where]
            total += float(ref_lm.loss(leaves, toks, pos[b:b + 1] * 0 + torch.arange(
                pos.shape[1]) * (alone >= 0), alone, 2, 2)) * (n - 1)
            weight += n - 1
    assert packed == pytest.approx(total / weight, rel=1e-5)


def _port_dlrm(leaves):
    from petastorm_tpu_torch.models.tabular_dlrm import DLRM

    model = DLRM(DLRM_CFG["num_dense"], DLRM_CFG["num_sparse"], DLRM_CFG["table_rows"],
                 DLRM_CFG["embed_dim"], DLRM_CFG["bottom_hidden"], DLRM_CFG["top_hidden"],
                 compute_dtype=torch.float32)
    model.load_state_dict({k: v.clone() for k, v in leaves.items()})
    return model


@pytest.mark.parametrize("seed", [0, 1])
def test_dlrm_reference_steps_match_the_port(seed):
    from petastorm_tpu_torch.models.tabular_dlrm import make_dlrm_train_step

    rng = np.random.RandomState(seed)
    batches = [(torch.from_numpy(rng.rand(64, 13).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10_000, size=(64, 26)).astype(np.int64)),
                torch.from_numpy(rng.randint(0, 2, size=64).astype(np.int32)))
               for _ in range(3)]
    lr = 0.05
    model = _port_dlrm(weights.dlrm_leaves(seed, DLRM_CFG, "cpu"))
    step = make_dlrm_train_step(model, lr)
    port = {}
    mask = torch.ones(64, dtype=torch.bool)
    port_losses = (step(d, c, y, mask) for d, c, y in batches)
    port = compare.read_steps(dict(model.named_parameters()), port_losses,
                              lambda: weights.dlrm_leaves(seed, DLRM_CFG, "cpu"), lr, 3)
    leaves = weights.dlrm_leaves(seed, DLRM_CFG, "cpu")
    ref = compare.read_steps(leaves, ref_dlrm.train(leaves, batches, lr),
                             lambda: weights.dlrm_leaves(seed, DLRM_CFG, "cpu"), lr, 3)
    gaps = compare.gaps(compare.Readings(*port), compare.Readings(*ref))
    assert max(gaps.values()) < 1e-5, gaps
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), leaves[name], rtol=1e-5, atol=1e-7, msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_fit_matches_the_ports_packer(seed):
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_POSITION_KEY,
        PACK_SEGMENT_KEY,
        pack_ragged,
    )

    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, 100, size=n).astype(np.int32) for n in rng.randint(1, 50, size=40)]
    ours = ref_packing.first_fit(docs, 3, 64)
    port = list(pack_ragged(({"tokens": d} for d in docs), slot_len=64, slots=3))
    assert len(ours) == len(port)
    for (tok, pos, seg), theirs in zip(ours, port):
        np.testing.assert_array_equal(tok, theirs["tokens"])
        np.testing.assert_array_equal(pos, theirs[PACK_POSITION_KEY])
        np.testing.assert_array_equal(seg, theirs[PACK_SEGMENT_KEY])


def _stream(seed, groups=4, per_group=8, epochs=1):
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, 1000, size=n).astype(np.int32)
            for n in rng.randint(5, 60, size=groups * per_group)]
    plan = [g for _ in range(epochs) for g in rng.permutation(groups)]
    order = [g * per_group + i for g in plan for i in range(per_group)]
    delivered = ref_packing.first_fit([docs[i] for i in order], 2, 64)
    return docs, per_group, delivered


@pytest.mark.parametrize("seed", range(6))
def test_check_stream_accepts_a_sound_delivery(seed):
    # Over several epochs, so a group may follow itself at an epoch boundary.
    docs, per_group, delivered = _stream(seed, groups=2, epochs=4)
    mismatches, expected = ref_packing.check_stream(docs, per_group, delivered, 2, 64)
    assert mismatches == 0 and len(expected) == len(delivered)


@pytest.mark.parametrize("fault", ["token", "dropped document", "position", "segment"])
def test_check_stream_counts_a_fault(fault):
    docs, per_group, delivered = _stream(1)
    tok, pos, seg = (x.copy() for x in delivered[2])
    if fault == "token":
        tok[0, 1] += 1
    elif fault == "dropped document":
        gone = seg[1] == seg[1].max()
        tok[1][gone], pos[1][gone], seg[1][gone] = 0, 0, -1
    elif fault == "position":
        pos[0, 3] += 1
    else:
        seg[0, 0] = 5
    delivered[2] = (tok, pos, seg)
    mismatches, _ = ref_packing.check_stream(docs, per_group, delivered, 2, 64)
    assert mismatches > 0


def test_check_batches_finds_rows_and_counts_faults():
    rng = np.random.RandomState(0)
    label = rng.randint(0, 2, 64).astype(np.int32)
    dense = rng.rand(64, 13).astype(np.float32)
    cat = rng.randint(0, 99, (64, 26)).astype(np.int64)
    good = [(label[16:32], dense[16:32], cat[16:32]), (label[:16], dense[:16], cat[:16])]
    assert ref_rows.check_batches(label, dense, cat, good, 16) == (0, [16, 0])
    bad_cat = cat[32:48].copy()
    bad_cat[5, 3] += 1
    shifted = (label[1:17], dense[1:17], cat[1:17])
    mismatches, starts = ref_rows.check_batches(
        label, dense, cat, [(label[32:48], dense[32:48], bad_cat), shifted], 16)
    assert mismatches == 1 + 16 and starts == [32, None]


def test_rounding_matches_the_formats():
    x = torch.randn(10_000)
    tf32 = precision.round_tf32(x)
    assert torch.all((tf32.view(torch.int32) & 0x1FFF) == 0)
    assert float(((tf32 - x).abs() / x.abs()).max()) <= 2.0 ** -11
    fp8 = precision.round_fp8(x)
    assert float((fp8 - x).abs().max()) <= float(x.abs().max()) * 2.0 ** -3
    a = torch.randn(3, 5, requires_grad=True)
    b = torch.randn(5, 4, requires_grad=True)
    precision.matmul(a, b, "tf32").sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
