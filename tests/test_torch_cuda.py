"""Tests of petastorm_tpu_torch that need a CUDA card: the three flash
kernels against their plain PyTorch versions, pinned H2D staging, and the LM
trainer on the card. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs where
those are absent (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: f32 forward and lse 1e-4 absolute; bf16
forward within one bf16 step of the plain output, elementwise; gradients
relative to the largest gradient, 1e-3 in f32 and 1e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.models.long_context_lm import generate_corpus, train_lm
from petastorm_tpu_torch.ops import flash_attention as fa
from petastorm_tpu_torch.reader.reader import make_columnar_reader
from petastorm_tpu_torch.torch_utils.packing import make_packed_torch_dataloader

pytestmark = pytest.mark.cuda

#: name -> (b, t_q, t_kv, h, h_kv, d, causal, aux, dtype)
CASES = {
    "causal_segments_d16": (4, 128, 128, 4, 4, 16, True, "seg", torch.float32),
    "causal_ragged_d32": (2, 77, 77, 2, 2, 32, True, None, torch.float32),
    "empty_rows_d64": (1, 70, 50, 2, 2, 64, True, None, torch.float32),
    "kv_lengths_d128": (3, 100, 100, 2, 2, 128, False, "lens", torch.float32),
    "gqa_pair_segments_d16": (2, 48, 80, 4, 2, 16, False, "pair", torch.float32),
    "bf16_causal_segments_d64": (2, 130, 130, 4, 1, 64, True, "seg", torch.bfloat16),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _segments(rng, b, t):
    ids = np.sort(rng.randint(0, 4, (b, t)), axis=1).astype(np.int32)
    ids[0, -max(1, t // 8):] = -1
    return ids


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_versions(cuda_device, name):
    b, t_q, t_kv, h, h_kv, d, causal, aux, dtype = CASES[name]
    rng = np.random.RandomState(len(name))

    def rnd(t, heads):
        return torch.tensor(rng.randn(b, t, heads, d), dtype=dtype,
                            device=cuda_device)

    q, k, v, do = rnd(t_q, h), rnd(t_kv, h_kv), rnd(t_kv, h_kv), rnd(t_q, h)
    ids = lambda a: torch.tensor(a, device=cuda_device).int().contiguous()  # noqa: E731
    kw = dict(causal=causal, causal_offset=t_kv - t_q, kv_lengths=None,
              q_seg=None, kv_seg=None)
    if aux == "seg":
        kw["q_seg"] = kw["kv_seg"] = ids(_segments(rng, b, t_q))
    elif aux == "pair":
        kw["q_seg"], kw["kv_seg"] = ids(_segments(rng, b, t_q)), ids(_segments(rng, b, t_kv))
    elif aux == "lens":
        kw["kv_lengths"] = ids(np.array([t_kv, t_kv // 3, 0][:b]))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    grads = fa.flash_backward_kernel(q, k, v, o, lse, do, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    grads_p = fa.flash_backward_plain(q, k, v, o_p, lse_p, do, **kw)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    bf16 = dtype == torch.bfloat16
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    finite = torch.isfinite(lse_p)
    assert (lse[finite] - lse_p[finite]).abs().max().item() <= 1e-4
    g, w = o.float(), o_p.float()
    if bf16:  # both round f32 results that agree to ~1e-6: one bf16 step apart at most
        assert ((g - w).abs() <= 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5).all()
    else:
        assert (g - w).abs().max().item() <= 1e-4
    for got, want in zip(grads, grads_p):
        assert torch.isfinite(got).all()
        scale = max(want.float().abs().max().item(), 1e-6)
        err = (got.float() - want.float()).abs().max().item() / scale
        assert err <= (1e-2 if bf16 else 1e-3)


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 8, 2, 24, device=cuda_device)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_forward_kernel(q, q, q)
    q = torch.zeros(1, 8, 4, 16, device=cuda_device)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_forward_kernel(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="shape"):
        fa.flash_forward_kernel(q, q, q, q_seg=torch.zeros(1, 7, dtype=torch.int32,
                                                           device=cuda_device),
                                kv_seg=torch.zeros(1, 8, dtype=torch.int32,
                                                   device=cuda_device))
    q = torch.zeros(1, 8, 2, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_forward_kernel(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous=False"):
        fa.flash_forward_kernel(q, q, q)


def test_packed_loader_stages_pinned_batches(cuda_device, tmp_path):
    url = f"file://{tmp_path}/corpus"
    generate_corpus(url, docs=200, max_len=32)

    def batches(device):
        reader = make_columnar_reader(url, reader_pool_type="dummy",
                                      shuffle_row_groups=False)
        with make_packed_torch_dataloader(reader, slot_len=64, slots=4,
                                          sequence_fields=["tokens"],
                                          length_field="length",
                                          device=device) as loader:
            return list(loader), loader.diagnostics

    want, _ = batches("cpu")
    got, diag = batches(cuda_device)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in w:
            assert g[key].is_cuda and torch.equal(g[key].cpu(), w[key])
    assert diag["h2d_bytes"] == sum(t.nbytes for b in want for t in b.values())


def test_train_lm_on_the_card(cuda_device, tmp_path):
    url = f"file://{tmp_path}/corpus"
    generate_corpus(url, docs=256, max_len=32)
    fa.reset_launch_counts()
    result = train_lm(url, slot_len=64, slots=4, steps=12, device=cuda_device)
    assert min(fa.LAUNCHES.values()) >= 12
    assert result["batch_devices"] == ["cuda:0"]
    assert result["losses"][-1] < result["losses"][0]
    assert result["logit_parity"] <= 2e-4
