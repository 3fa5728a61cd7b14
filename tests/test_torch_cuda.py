"""Tests of petastorm_tpu_torch that need a CUDA card: the three flash
kernels against their plain PyTorch versions (also through autograd with a
do off a 16-byte boundary, and with q/k/v views), pinned H2D staging, the
LM trainer on the card, and the image path: the device stage and the
classifier on the card against the CPU, the row loader's staged bytes, and
the image trainer. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs where
those are absent (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: f32 forward and lse 1e-4 absolute; bf16
forward within one bf16 step of the plain output, elementwise; gradients
relative to the largest gradient, 1e-3 in f32 and 1e-2 in bf16. Besides
sorted packed ids, the segment cases take ``ops.segment_layouts``'s
layouts that would trip a tile-skipping kernel built on sorted ids.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.models import image_classifier as ic
from petastorm_tpu_torch.models.long_context_lm import generate_corpus, train_lm
from petastorm_tpu_torch.ops import flash_attention as fa
from petastorm_tpu_torch.ops.segment_layouts import SEGMENT_KINDS, segment_ids
from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
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
#: aux = a segment_ids kind: every kind in f32 and bf16, GQA, a ragged last
#: Q tile, and among them every head dim.
for _kind, _d in zip(SEGMENT_KINDS, (128, 64, 32, 16, 128)):
    for _dtype, _tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        CASES[f"{_kind}_d{_d}_{_tag}"] = (2, 200, 200, 4, 2, _d, True, _kind, _dtype)


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
    elif aux is not None:
        kw["q_seg"] = kw["kv_seg"] = ids(segment_ids(aux, b, t_q, seed=len(name)))
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


def test_backward_takes_do_off_a_16_byte_boundary(cuda_device):
    """A do that is a view off a 16-byte boundary (the backward kernels'
    cp.async copies need one) is copied to an aligned buffer by the
    backward: both kernels still run and match their plain version."""
    rng = np.random.RandomState(3)
    b, t, h, d = 2, 96, 2, 32
    q, k, v = (torch.tensor(rng.randn(b, t, h, d), dtype=torch.float32, device=cuda_device,
                            requires_grad=True) for _ in range(3))
    ids = torch.tensor(np.sort(rng.randint(0, 3, (b, t)), axis=1), dtype=torch.int32,
                       device=cuda_device)
    storage = torch.tensor(rng.randn(b * t * h * d + 1), dtype=torch.float32,
                           device=cuda_device)
    do = storage[1:].view(b, t, h, d)
    assert do.is_contiguous() and do.data_ptr() % 16 == 4
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, causal=True, segment_ids=ids).backward(do)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in ("dq", "dkv")} == {"dq": 1, "dkv": 1}
    kw = dict(causal=True, causal_offset=0, q_seg=ids, kv_seg=ids)
    x = [t.detach() for t in (q, k, v)]
    o_p, lse_p = fa.flash_forward_plain(*x, **kw)
    grads_p = fa.flash_backward_plain(*x, o_p, lse_p, do.clone(), **kw)
    for got, want in zip((q.grad, k.grad, v.grad), grads_p):
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert err <= 1e-3


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


def test_flash_attention_takes_views_and_equals_the_contiguous_call(cuda_device):
    """q/k/v as ``qkv.unbind(2)`` views of a fused projection, and a view
    off a 16-byte boundary: the autograd function lays them out for the
    kernels, so output and gradients equal the contiguous call bit for bit."""
    rng = np.random.RandomState(5)
    b, t, h, d = 2, 96, 2, 32
    ids = torch.tensor(np.sort(rng.randint(0, 3, (b, t)), axis=1), dtype=torch.int32,
                       device=cuda_device)
    do = torch.tensor(rng.randn(b, t, h, d), dtype=torch.float32, device=cuda_device)
    qkv = torch.tensor(rng.randn(b, t, 3, h, d), dtype=torch.float32, device=cuda_device,
                       requires_grad=True)
    storage = torch.tensor(rng.randn(3, b * t * h * d + 1), dtype=torch.float32,
                           device=cuda_device, requires_grad=True)
    odd = [row[1:].view(b, t, h, d) for row in storage.unbind(0)]
    assert odd[0].data_ptr() % 16 == 4 and not qkv.unbind(2)[0].is_contiguous()
    for q, k, v in (qkv.unbind(2), odd):
        o = fa.flash_attention(q, k, v, causal=True, segment_ids=ids)
        grads = torch.autograd.grad(o, (q, k, v), do)
        x = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in x)
        want = fa.flash_attention(*x, causal=True, segment_ids=ids)
        want_grads = torch.autograd.grad(want, x, do)
        assert torch.equal(o, want)
        for got, ref in zip(grads, want_grads):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_stage_on_the_card_equals_the_cpu(cuda_device, dtype):
    rng = np.random.RandomState(6)
    raw = torch.tensor(rng.randint(0, 256, (16, 64, 64, 3)), dtype=torch.uint8)
    stage = DeviceStage(output_dtype=dtype, normalize=((120.0, 128.0, 100.0), (60.0, 64.0, 50.0)),
                        crop=(56, 56), flip=True, seed=3)
    for step in (0, 7):
        got = stage.apply({"image": raw.to(cuda_device)}, step)["image"]
        want = stage.apply({"image": raw}, step)["image"]
        assert got.is_cuda and got.dtype == want.dtype == dtype
        assert torch.equal(got.cpu(), want)  # bit for bit: a gather and two IEEE ops


def test_classifier_f32_logits_on_the_card_match_the_cpu(cuda_device):
    """f32 compute with TF32 off: the card's conv / matmul sums in another
    order, so 1e-5 relative to the largest logit."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = ic.init_image_classifier((32, 32, 3), 10, hidden=256, conv_features=32,
                                       compute_dtype=torch.float32, seed=2, device="cpu")
        card = ic.init_image_classifier((32, 32, 3), 10, hidden=256, conv_features=32,
                                        compute_dtype=torch.float32, seed=2,
                                        device=cuda_device)
        x = torch.tensor(np.random.RandomState(7).rand(8, 32, 32, 3) * 2 - 1,
                         dtype=torch.float32)
        with torch.no_grad():
            want = cpu(x)
            got = card(x.to(cuda_device)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_image_loader_stages_bytes_and_decodes_on_the_card(cuda_device, tmp_path):
    url = f"file://{tmp_path}/images"
    ic.generate_image_dataset(url, CompressedImageCodec("png"), rows=80,
                              image_shape=(16, 16, 3), rows_per_row_group=16)

    def batches(device):
        reader = make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False)
        stage = DeviceStage(normalize=(127.5, 127.5), crop=(12, 12), flip=True, seed=1)
        with make_torch_dataloader(reader, 32, last_batch="pad", device=device,
                                   device_stage=stage) as loader:
            return list(loader), loader.diagnostics, stage

    want, _, _ = batches("cpu")
    got, diag, stage = batches(cuda_device)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].is_cuda and torch.equal(g[key].cpu(), w[key])
    # Per row: the raw 16x16x3 image, id (8), features (64), label (4); and
    # the pad mask (1 byte a row) of the one padded batch.
    assert diag["h2d_bytes"] == diag["rows"] * (16 * 16 * 3 + 8 + 64 + 4) + 32
    assert stage.h2d_bytes == diag["rows"] * 16 * 16 * 3
    assert diag["raw_stage_s"] > 0 and diag["device_decode_s"] > 0


def test_train_image_classifier_on_the_card(cuda_device, tmp_path):
    url = f"file://{tmp_path}/images"
    ic.generate_image_dataset(url, CompressedImageCodec("png"), rows=256,
                              image_shape=(32, 32, 3), rows_per_row_group=32)
    result = ic.train_image_classifier(url, batch_size=32, epochs=3, conv_features=16,
                                       hidden=128, learning_rate=0.05, device=cuda_device)
    losses = result["losses"]
    assert result["batch_devices"] == ["cuda:0"] and len(losses) == 24
    assert np.isfinite(losses).all() and np.mean(losses[-8:]) < np.mean(losses[:8])
    assert result["peak_memory_bytes"] > 0 and result["images_per_s"] > 0
