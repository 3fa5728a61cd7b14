"""The DLRM's training step, written from its equations, in float32.

For a batch of dense features ``x`` ``[B, 13]``, raw ids ``c`` ``[B, 26]``
and labels ``y``, with tables ``T`` [26, R, D] and the MLP weights
``W_l, b_l`` (``[d_in, d_out]``):

    z   = relu(relu(x W_b1 + b_b1) W_b2 + b_b2)               [B, D]
    e_j = T[j, c_j mod R]                                     [B, D]  j < 26
    f   = (z, e_0, ..., e_25)                                 27 vectors
    u   = (f_i . f_j for i < j, in row-major order)           [B, 351]
    logit = relu([z, u] W_t1 + b_t1) W_t2 + b_t2
    loss = mean_b (max(logit, 0) - logit y + log(1 + exp(-|logit|)))

One step is plain SGD on every leaf: ``w <- w - lr * grad``. A table row
that no id of the batch names has a zero gradient and stays as it is, so
the tables are updated on the named rows only.

Every matrix product and the pairwise dot products go through
:mod:`~perfbench.reference.precision`, so the step can be computed in a
lower precision for the control.
"""

from __future__ import annotations

import torch

from perfbench.reference.precision import matmul, rounder


def _pairs(features):
    rows, cols = [], []
    for i in range(features):
        for j in range(i + 1, features):
            rows.append(i)
            cols.append(j)
    return rows, cols


def loss(leaves, rows, dense, ids, labels, precision="f32"):
    """The batch's mean BCE-with-logits; ``rows`` are the looked-up table
    rows ``[B, 26, D]`` (a leaf of their own, for the sparse update)."""
    fn = rounder(precision)

    def dense_layer(name, x):
        return matmul(x, leaves[f"{name}_kernel"], precision) + leaves[f"{name}_bias"]

    z = torch.relu(dense_layer("bottom2", torch.relu(dense_layer("bottom1", dense))))
    feats = torch.cat([z[:, None], rows], dim=1)                    # [B, 27, D]
    if fn is not None:
        feats = feats + (fn(feats) - feats).detach()
    inter = feats @ feats.transpose(1, 2)                           # [B, 27, 27]
    i, j = _pairs(feats.shape[1])
    pairwise = inter[:, i, j]
    logit = dense_layer("top2", torch.relu(dense_layer("top1", torch.cat([z, pairwise], 1))))
    logit = logit[:, 0]
    y = labels.float()
    losses = torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-logit.abs()))
    return losses.mean()


def train(leaves, batches, learning_rate, precision="f32"):
    """SGD steps on ``batches`` (``(dense, ids, labels)``), updating
    ``leaves`` (f32, drawn from the seed) in place; yields each step's
    loss once its update is done."""
    tables = leaves["embeddings"]
    num_tables, table_rows, dim = tables.shape
    flat = tables.view(-1, dim)
    offsets = torch.arange(num_tables, device=tables.device) * table_rows
    mlp = [name for name in leaves if name != "embeddings"]
    for dense, ids, labels in batches:
        index = (torch.remainder(ids.long(), table_rows) + offsets).reshape(-1)
        rows = flat[index].reshape(ids.shape[0], num_tables, dim).requires_grad_(True)
        params = {name: leaves[name].detach().requires_grad_(True) for name in mlp}
        value = loss(params, rows, dense.float(), ids, labels, precision)
        grads = torch.autograd.grad(value, [rows] + [params[n] for n in mlp])
        with torch.no_grad():
            unique, inverse = torch.unique(index, return_inverse=True)
            row_grad = torch.zeros((unique.numel(), dim), device=tables.device)
            row_grad.index_add_(0, inverse, grads[0].reshape(-1, dim))
            flat[unique] = flat[unique] - learning_rate * row_grad
            for name, g in zip(mlp, grads[1:]):
                leaves[name] -= learning_rate * g
        del grads, params, rows
        yield value.detach()
