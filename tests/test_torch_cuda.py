"""Tests of petastorm_tpu_torch that need a CUDA card: the three flash
kernels against their plain PyTorch versions (also through autograd with a
do off a 16-byte boundary, and with q/k/v views), head dims the kernels are
not instantiated for (zero-padded, bit for bit the padded call), the lse
cotangent through the dQ kernel, strict causal and
``flash_attention_with_lse``'s gradients, a two-process ring on the card,
pinned H2D staging, the LM trainer on the card, and the image path: the
device stage and the classifier on the card against the CPU, the row
loader's staged bytes, and the image trainer. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs where
those are absent (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: f32 forward and lse 1e-4 absolute; bf16
forward within one bf16 step of the plain output, elementwise; gradients
relative to the largest gradient, 1e-3 in f32 and 1e-2 in bf16. Besides
sorted packed ids, the segment cases take ``ops.segment_layouts``'s
layouts that would trip a tile-skipping kernel built on sorted ids.
"""

import multiprocessing
import traceback

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.models import image_classifier as ic
from petastorm_tpu_torch.models import sequence_model as sm
from petastorm_tpu_torch.models.long_context_lm import generate_corpus, train_lm
from petastorm_tpu_torch.ops import _build
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


def _strict_causal_case(rng, device, b, t, h, h_kv, d, dtype=torch.float32):
    def rnd(heads):
        return torch.tensor(rng.randn(b, t, heads, d), dtype=dtype, device=device)

    ids = torch.tensor(_segments(rng, b, t), device=device)
    kw = dict(causal=True, causal_offset=-1, kv_lengths=None, q_seg=ids, kv_seg=ids)
    return (rnd(h), rnd(h_kv), rnd(h_kv), rnd(h)), kw


def _zero_pad(t, dim):
    return torch.cat([t, t.new_zeros(*t.shape[:-1], dim - t.shape[-1])], dim=-1)


@pytest.mark.parametrize("d,kernel_dim", [(8, 16), (24, 32)])
def test_head_dims_are_zero_padded_bit_for_bit(cuda_device, d, kernel_dim):
    """A head dim the kernels are not instantiated for runs as the next one:
    ``flash_attention``'s output and gradients, and
    ``flash_attention_with_lse``'s lse, equal bit for bit the kernels' own
    entry points called on inputs zero-padded by hand with ``1 / sqrt(d)``
    as the scale, sliced back."""
    rng = np.random.RandomState(d)
    (q, k, v, do), kw = _strict_causal_case(rng, cuda_device, 2, 100, 4, 2, d)
    ids = kw["q_seg"]
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(*x, causal=True, segment_ids=ids)
    o.backward(do)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    dq, dk, dv = (t.grad for t in x)
    _, lse = fa.flash_attention_with_lse(q, k, v, causal=True, segment_ids=ids)
    assert o.shape == q.shape and dq.shape == q.shape and dk.shape == k.shape

    qp, kp, vp, dop = (_zero_pad(t, kernel_dim) for t in (q, k, v, do))
    stream = torch.cuda.current_stream().cuda_stream
    dims = fa._dims(qp, kp, True, 0, 1 / np.sqrt(d))
    assert dims[5] == kernel_dim and dims[-1] == 1 / np.sqrt(d)
    o_p = torch.empty_like(qp)
    lse_p = torch.empty(2 * 4, 100, dtype=torch.float32, device=cuda_device)
    assert _build.kernel("ptt_flash_fwd")(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                          o_p.data_ptr(), lse_p.data_ptr(), ids.data_ptr(),
                                          ids.data_ptr(), None, *dims, stream) == 0
    dq_p, delta_p = torch.empty_like(qp), torch.empty_like(lse_p)
    assert _build.kernel("ptt_flash_bwd_dq")(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                             o_p.data_ptr(), dop.data_ptr(), lse_p.data_ptr(),
                                             None, delta_p.data_ptr(), dq_p.data_ptr(),
                                             ids.data_ptr(), ids.data_ptr(), None, *dims,
                                             stream) == 0
    dk_p, dv_p = torch.empty_like(kp), torch.empty_like(vp)
    assert _build.kernel("ptt_flash_bwd_dkv")(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                              dop.data_ptr(), lse_p.data_ptr(),
                                              delta_p.data_ptr(), dk_p.data_ptr(),
                                              dv_p.data_ptr(), ids.data_ptr(), ids.data_ptr(),
                                              None, *dims, stream) == 0
    torch.cuda.synchronize()
    lse_pub = torch.where(torch.isposinf(lse_p), -np.inf, lse_p).reshape(2, 4, 100)
    assert torch.equal(o, o_p[..., :d]) and torch.equal(lse, lse_pub.transpose(1, 2))
    assert (o_p[..., d:] == 0).all() and (dq_p[..., d:] == 0).all()
    assert torch.equal(dq, dq_p[..., :d])
    assert torch.equal(dk, dk_p[..., :d]) and torch.equal(dv, dv_p[..., :d])
    # and against the plain versions at the true head dim
    kw["causal_offset"] = 0
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, **kw)
    assert (o - o_ref).abs().max().item() <= 1e-4
    for got, want in zip((dq, dk, dv), fa.flash_backward_plain(q, k, v, o_ref, lse_ref, do,
                                                               **kw)):
        assert (got - want).abs().max().item() / want.abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_dlse_and_strict_causal_match_the_plain_versions(cuda_device, dtype, d):
    """The dQ kernel with an lse cotangent, under strict causal
    (``causal_offset`` -1): dq and delta (less dlse) against the plain
    version, and dK/dV reading that delta. With ``dlse=None`` the kernel's
    output equals the zero-cotangent call bit for bit. D=8 runs as the
    autograd functions run it: zero-padded to 16, with ``1 / sqrt(8)``."""
    rng = np.random.RandomState(d)
    (q, k, v, do), kw = _strict_causal_case(rng, cuda_device, 2, 130, 4, 2, d, dtype)
    (q, k, v, do), kw["scale"] = fa.pad_head_dim(q, k, v, do)
    dlse = torch.tensor(rng.randn(2 * 4, 130), dtype=torch.float32, device=cuda_device)
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p)) and torch.isinf(lse[:, 0]).all()
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=dlse, **kw)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, dlse=dlse, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw)
    dq0, delta0 = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw)
    dqz, deltaz = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=torch.zeros_like(dlse), **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq0, dqz) and torch.equal(delta0, deltaz)
    want = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(8, 130) - dlse
    assert (delta - want).abs().max().item() <= 1e-4
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    for got, ref in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item() \
            <= tol


@pytest.mark.parametrize("d,shift", [(8, -1), (16, -1), (16, 0)])
def test_flash_attention_with_lse_on_the_card_matches_the_cpu(cuda_device, d, shift):
    """Output, lse (``-inf`` in the same places) and the gradients of a loss
    that reads both, on the card against the plain versions on the CPU, for
    a causal ``(q_ids, kv_ids)`` pair as the ring runs it."""
    rng = np.random.RandomState(d - shift)
    b, t, h, h_kv = 2, 72, 4, 2
    arrays = [rng.randn(b, t, n, d).astype(np.float32) for n in (h, h_kv, h_kv, h)]
    w = torch.tensor(rng.randn(b, t, h), dtype=torch.float32)
    ids = (torch.tensor(_segments(rng, b, t)), torch.tensor(_segments(rng, b, t)))
    results = {}
    for device in ("cpu", cuda_device):
        q, k, v = (torch.tensor(a, device=device, requires_grad=True) for a in arrays[:3])
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, causal_shift=shift,
                                               segment_ids=tuple(i.to(device) for i in ids),
                                               device=device)
        loss = (out * torch.tensor(arrays[3], device=device)).sum() + torch.where(
            torch.isfinite(lse), lse * w.to(device), 0.0).sum()
        loss.backward()
        results[str(device)] = [x.detach().cpu() for x in (out, lse, q.grad, k.grad, v.grad)]
    (o_c, lse_c, *g_c), (o_g, lse_g, *g_g) = results.values()
    assert (o_g - o_c).abs().max().item() <= 1e-4
    assert torch.equal(torch.isneginf(lse_g), torch.isneginf(lse_c))
    fin = torch.isfinite(lse_c)
    assert (lse_g[fin] - lse_c[fin]).abs().max().item() <= 1e-4
    for got, want in zip(g_g, g_c):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() / want.abs().max().item() <= 1e-3


def _ring_rank(rank, store, out_dir):
    """One rank of the two-process ring (striped and contiguous) and
    Ulysses on the card: gloo over pinned host memory, the flash kernels on
    cuda:0."""
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, w = (torch.randn(2, 96, 4, 8, device="cuda", generator=g) for _ in range(4))
        seg = torch.sort(torch.randint(0, 4, (2, 96), device="cuda", generator=g),
                         dim=1).values.int()
        group, errs = dist.group.WORLD, []
        runs = [  # the last with the default local attention: the kernels on the card
            lambda *x: sm.ring_attention(*x, group, causal=True, placement="striped",
                                         segment_ids=seg, local_attn="flash"),
            lambda *x: sm.ring_attention(*x, group, causal=True, placement="contiguous",
                                         segment_ids=seg, local_attn="flash"),
            lambda *x: sm.ulysses_attention(*x, group, causal=True, segment_ids=seg)]
        for attention in runs:
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.reset_launch_counts()
            out = attention(*x)
            (out * w).sum().backward()
            launches = dict(fa.LAUNCHES)
            ref = sm.attention_reference(*ref_in, causal=True, segment_ids=seg)
            (ref * w).sum().backward()
            errs.append(((out - ref).abs().max().item(),
                         max(((a.grad - b.grad).abs().max() / b.grad.abs().max()).item()
                             for a, b in zip(x, ref_in)),
                         min(launches.values())))
        torch.save(errs, f"{out_dir}/rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def test_two_process_ring_on_the_card(cuda_device, tmp_path):
    fa.flash_forward_kernel(*(torch.zeros(1, 8, 1, 16, device=cuda_device),) * 3)  # build first
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ring_rank, args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.kill()
            p.join()
    for r, p in enumerate(procs):
        err = tmp_path / f"rank{r}.err"
        assert p.exitcode == 0, err.read_text() if err.exists() else f"rank {r} hung"
        errs = torch.load(tmp_path / f"rank{r}.pt")
        assert len(errs) == 3
        for out_err, grad_err, min_launches in errs:
            assert out_err <= 1e-4 and grad_err <= 1e-3 and min_launches >= 1
