"""Row-wise sparse SGD of an embedding table: only the rows an index names
change, each by its summed gradient.

For a table ``[R, D]``, a flat index ``[N]`` into its rows and the row
gradients ``[N, D]`` of those lookups, :func:`sparse_sgd` does, in place,

    table[r] = table[r] - lr * (((0 + g[i0]) + g[i1]) + ...)

for every row ``r`` the index names, with ``i0 < i1 < ...`` the positions of
``r`` in the index: each row's contributions summed in float32 in index
order, then one product and one difference, each rounded. That is plain SGD
(``p -= lr * grad``) on a table whose gradient is the index's scatter-add:
the rows no id names have a zero gradient and keep their values, and the
named rows get the dense update's values bit for bit, since PyTorch's index
backward sums a row's contributions in the same order.

On the card the update is ``csrc/sparse_sgd.cu`` after a stable device sort
of the index (:func:`sparse_sgd_kernel`); for a table on the CPU it is
:func:`sparse_sgd_plain`. Neither reads anything back to the host: the
count of touched rows they return is a 0-dim tensor on the table's device.
"""

from __future__ import annotations

import torch

#: Launches of ``csrc/sparse_sgd.cu``, counted by :func:`sparse_sgd_kernel`.
LAUNCHES = {"sparse_sgd": 0}

#: The largest row width the kernel takes (its ``kMaxDim``); it takes
#: multiples of 4 up to it.
KERNEL_MAX_DIM = 1024


def _check(table, index, grads):
    if table.dim() != 2 or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"sparse_sgd takes a contiguous float32 table [R, D], got "
                         f"{table.dtype} {tuple(table.shape)} "
                         f"(contiguous={table.is_contiguous()})")
    n, d = index.numel(), table.shape[1]
    if index.dim() != 1 or index.dtype != torch.int64:
        raise ValueError(f"sparse_sgd takes an int64 index [N], got {index.dtype} "
                         f"{tuple(index.shape)}")
    if (grads.dtype != torch.float32 or tuple(grads.shape) != (n, d)
            or not grads.is_contiguous()):
        raise ValueError(f"sparse_sgd takes contiguous float32 row gradients of shape "
                         f"{(n, d)}, got {grads.dtype} {tuple(grads.shape)} "
                         f"(contiguous={grads.is_contiguous()})")
    if index.device != table.device or grads.device != table.device:
        raise ValueError(f"sparse_sgd takes its index and gradients on the table's device "
                         f"{table.device}, got {index.device} and {grads.device}")


def sparse_sgd_plain(table, index, grads, learning_rate):
    """:func:`sparse_sgd` in PyTorch: the named rows (``unique``), their
    contributions summed into a zeroed buffer by ``index_add_`` (in index
    order on the CPU), then one subtraction. On a CUDA table ``index_add_``
    adds in no fixed order, so the sums may differ in their last bits, and
    the host synchronises (the unique rows' count); the kernel does
    neither."""
    _check(table, index, grads)
    unique, inverse = torch.unique(index, return_inverse=True)
    sums = torch.zeros((unique.numel(), table.shape[1]), dtype=torch.float32,
                       device=table.device)
    sums.index_add_(0, inverse, grads)
    table[unique] = table[unique] - learning_rate * sums
    return torch.tensor(unique.numel(), device=table.device)


def sparse_sgd_kernel(table, index, grads, learning_rate):
    """Launch ``csrc/sparse_sgd.cu`` on the current stream after a stable
    sort of ``index`` (as int32 keys: half the radix passes of int64): same
    contract as :func:`sparse_sgd_plain`, with no host synchronisation; the
    kernel counts the rows it changes. Raises on what the kernel does not
    take: a width that is not a multiple of 4 up to :data:`KERNEL_MAX_DIM`,
    2^31 rows or more, or a table or gradients off a 16-byte boundary."""
    from petastorm_tpu_torch.ops import _build

    _check(table, index, grads)
    rows, d = table.shape
    if d % 4 or d > KERNEL_MAX_DIM:
        raise ValueError(f"the sparse SGD kernel takes rows of a multiple of 4 floats up "
                         f"to {KERNEL_MAX_DIM}, got {d}")
    if rows >= 2 ** 31:
        raise ValueError(f"the sparse SGD kernel takes tables of under 2^31 rows, got {rows}")
    for name, t in (("table", table), ("grads", grads)):
        if t.data_ptr() % 16:
            raise ValueError(f"the sparse SGD kernel takes its {name} on a 16-byte "
                             f"boundary; it starts {t.data_ptr() % 16} bytes past one")
    touched = torch.zeros((), dtype=torch.int64, device=table.device)
    if index.numel() == 0:
        return touched
    keys, order = torch.sort(index.int(), stable=True)
    with torch.cuda.device(table.device):
        err = _build.kernel("ptt_sparse_sgd")(
            table.data_ptr(), keys.data_ptr(), order.data_ptr(), grads.data_ptr(),
            touched.data_ptr(), index.numel(), d, learning_rate,
            torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ptt_sparse_sgd launch failed with cudaError {err}")
    LAUNCHES["sparse_sgd"] += 1
    return touched


def sparse_sgd(table, index, grads, learning_rate):
    """In place on ``table`` (float32 ``[R, D]``): each row that ``index``
    (int64 ``[N]``) names less ``learning_rate`` times the float32 sum of its
    rows of ``grads`` (float32 ``[N, D]``), as the module docstring says.
    Returns the number of rows changed, a 0-dim int64 tensor on the table's
    device. The kernel for a CUDA table, the plain version for a CPU one."""
    if table.device.type == "cpu":
        return sparse_sgd_plain(table, index, grads, learning_rate)
    return sparse_sgd_kernel(table, index, grads, learning_rate)
