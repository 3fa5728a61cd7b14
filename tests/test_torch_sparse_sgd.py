"""The row-wise sparse SGD update (``ops/sparse_sgd.py``, on the card
``ops/csrc/sparse_sgd.cu``) and the DLRM step that runs it.

On the CPU: the plain version against a dense ``p -= lr * grad`` whose
gradient is the index's scatter-add, and its refusals. On a card (marked
``cuda``; they skip without one): the kernel against the plain version run
on the CPU, bit for bit, at widths and run lengths that take each of its
paths (a warp's run, a block's run longer than a stage); and at the DLRM
cell's shapes cut to 100,000 rows a table, three sparse steps against three
dense ones (tables bit for bit, unnamed rows unchanged, no host
synchronisation), and at bfloat16 compute the sparse change at least as close
as the dense one to a float64 sum of the same row gradients.

This file imports neither JAX nor the JAX package, so it also runs where
those are absent (the suite's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sparse_sgd.py
"""

import copy

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.models import tabular_dlrm as td
from petastorm_tpu_torch.ops import sparse_sgd as ss

#: The Criteo Terabyte cardinalities capped at 40M (the DLRM cell's traffic):
#: the small ones make runs of thousands of lookups a batch.
CARDINALITIES = [39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951, 2953546,
                 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295, 39664984,
                 585935, 12972, 108, 36]


def _update_inputs(rows, dim, n, seed, hot=0):
    """A table, an index with repeats (``hot`` extra lookups of row 1) and
    row gradients, as numpy arrays."""
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, dim).astype(np.float32) * 0.05
    index = rng.randint(0, max(1, rows // 4), n).astype(np.int64)
    index[rng.permutation(n)[:hot]] = 1
    grads = rng.randn(n, dim).astype(np.float32)
    return table, index, grads


def _dense_update(table, index, grads, lr):
    """``table - lr * g`` with ``g`` the index's scatter-add into zeros."""
    g = torch.zeros_like(table)
    g.index_put_((index,), grads, accumulate=True)
    return table - lr * g


@pytest.mark.parametrize("dim,hot", [(8, 0), (3, 40), (16, 150)])
def test_plain_update_equals_the_dense_update(dim, hot):
    table, index, grads = (torch.from_numpy(a) for a in _update_inputs(64, dim, 200, dim, hot))
    want = _dense_update(table, index, grads, 0.05)
    got = table.clone()
    touched = ss.sparse_sgd(got, index, grads, 0.05)
    assert torch.equal(got, want)
    assert touched.dim() == 0 and int(touched) == torch.unique(index).numel()
    unnamed = sorted(set(range(64)) - set(index.tolist()))
    assert unnamed and torch.equal(got[unnamed], table[unnamed])


@pytest.mark.parametrize("case", ["table_dtype", "index_dtype", "grads_shape", "grads_view"])
def test_plain_update_refuses_what_it_does_not_take(case):
    table, index, grads = (torch.from_numpy(a) for a in _update_inputs(16, 4, 10, 0))
    if case == "table_dtype":
        table = table.double()
    elif case == "index_dtype":
        index = index.int()
    elif case == "grads_shape":
        grads = grads[:5]
    else:
        grads = torch.cat([grads, grads], 1)[:, ::2]
    with pytest.raises(ValueError, match="sparse_sgd takes"):
        ss.sparse_sgd(table, index, grads, 0.05)


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,rows,n,hot", [
    (128, 4096, 20000, 0),        # warps' runs only (at most ~20 lookups a row)
    (128, 4096, 20000, 5000),     # one run of ~5,000: the block's path, 79 stages
    (4, 64, 3000, 2000),          # 1 float4 a row; runs of ~60 and one of ~2,000
    (132, 1000, 5000, 40),        # a row width that is no multiple of 32 floats
    (1024, 256, 3000, 100),       # the widest rows: 8 a stage
])
def test_kernel_equals_the_plain_update(cuda_device, dim, rows, n, hot):
    table, index, grads = _update_inputs(rows, dim, n, dim + n, hot)
    want = torch.from_numpy(table.copy())
    want_touched = ss.sparse_sgd_plain(want, torch.from_numpy(index), torch.from_numpy(grads),
                                       0.05)
    got = torch.from_numpy(table).to(cuda_device)
    launches = ss.LAUNCHES["sparse_sgd"]
    touched = ss.sparse_sgd(got, torch.from_numpy(index).to(cuda_device),
                            torch.from_numpy(grads).to(cuda_device), 0.05)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["sparse_sgd"] == launches + 1
    assert torch.equal(got.cpu(), want)
    assert int(touched) == int(want_touched)


def _zipf_batch(batch, seed, device):
    rng = np.random.RandomState(seed)
    ids = (rng.zipf(1.1, (batch, len(CARDINALITIES))) - 1) % np.array(CARDINALITIES)
    return (torch.from_numpy(rng.rand(batch, 13).astype(np.float32)).to(device),
            torch.from_numpy(ids.astype(np.int64)).to(device),
            torch.from_numpy(rng.randint(0, 2, batch).astype(np.int32)).to(device),
            torch.ones(batch, dtype=torch.bool, device=device))


def _cell_model(compute_dtype, device):
    """The DLRM cell's widths at 100,000 rows a table (1.3 GB)."""
    return td.init_dlrm(num_dense=13, num_sparse=26, vocab_size=100_000, embed_dim=128,
                        bottom_hidden=512, top_hidden=1024, compute_dtype=compute_dtype,
                        seed=5, device=device)


def _dense_step(model, batch, lr):
    loss, grads = td.dlrm_gradients(model, *batch)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p -= lr * grads[name]
    return loss


@pytest.mark.cuda
def test_sparse_steps_equal_the_dense_steps_without_a_sync(cuda_device):
    lr = td.LEARNING_RATE
    sparse = _cell_model(torch.float32, cuda_device)
    dense = copy.deepcopy(sparse)
    before = sparse.embeddings.detach().clone()
    batches = [_zipf_batch(8192, seed, cuda_device) for seed in range(3)]
    step = td.make_dlrm_train_step(sparse, lr)
    named = torch.zeros(before.numel() // 128, dtype=torch.bool, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(*batch) for batch in batches]
        touched = step.last_touched_rows
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for batch, loss in zip(batches, losses):
        assert torch.equal(loss, _dense_step(dense, batch, lr))
        named[sparse.lookup(batch[1])[0]] = True
    for name, p in sparse.named_parameters():
        assert torch.equal(p, dict(dense.named_parameters())[name]), name
    flat, was = sparse.embeddings.detach().view(-1, 128), before.view(-1, 128)
    assert torch.equal(flat[~named], was[~named])
    index = sparse.lookup(batches[-1][1])[0]
    assert int(touched) == torch.unique(index).numel()
    assert int(named.sum()) < 0.1 * named.numel()


@pytest.mark.cuda
def test_bf16_sparse_change_is_at_least_as_close_as_the_dense_one(cuda_device):
    """At bfloat16 compute both paths see the same per-lookup row gradients;
    the dense path sums them in bfloat16 (its table gradient's dtype in the
    index backward), the sparse one in float32."""
    lr = td.LEARNING_RATE
    sparse = _cell_model(torch.bfloat16, cuda_device)
    dense = copy.deepcopy(sparse)
    before = sparse.embeddings.detach().clone().view(-1, 128)
    batch = _zipf_batch(8192, 7, cuda_device)
    probe = copy.deepcopy(sparse)
    _, index, rows = td._gradients(probe, *batch, row_leaf=True)
    truth = torch.zeros(before.shape, dtype=torch.float64, device=cuda_device)
    truth.index_add_(0, index, rows.grad.reshape(-1, 128).double())
    del probe, rows
    td.make_dlrm_train_step(sparse, lr)(*batch)
    _dense_step(dense, batch, lr)
    named = torch.unique(index)
    want = -lr * truth[named]
    errs = [float(torch.linalg.vector_norm(
        m.embeddings.detach().view(-1, 128)[named].double() - before[named].double() - want))
        for m in (sparse, dense)]
    assert errs[0] <= errs[1], errs
