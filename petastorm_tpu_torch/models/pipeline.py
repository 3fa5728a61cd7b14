"""Pipeline-parallel encoder stack over a ``torch.distributed`` mesh: GPipe
and the fused 1F1B schedule.

Counterpart of ``petastorm_tpu/models/pipeline.py``, function for function
under its names. The S homogeneous residual blocks are stacked ``[S, ...]``
and split over the mesh's ``"pp"`` axis, one stage a rank; embed and head
are replicated.

GPipe (:func:`pipeline_forward`): ``M + S - 1`` ticks; each tick every
stage applies its block to its microbatch and ``ring_permute`` moves the
activation to the next stage; the last stage records finished
microbatches. The backward is autograd through the ticks, each permute's
backward sending the gradient the other way. The ranks' graphs differ
(stage 0 reads the input, the last stage records), so the record is
threaded through every permute as its ``carry``: the loss then depends on
every permute on every rank, and every rank runs every permute's backward,
in reverse order, bubble ticks included, which keeps the sends and
receives paired. A bubble tick (warm-up or drain: no microbatch at this
stage) computes nothing and sends zeros, so it adds exactly zero gradient.
The last stage's record leaves by a ``psum`` over ``"pp"`` (the other
stages hold zeros), so every rank computes the loss from the same
outputs, as JAX's replicated logits are.

1F1B (:func:`pipeline_1f1b_loss_and_grads`): each tick every stage runs
the forward of microbatch ``t - s`` and the hand-written backward of
microbatch ``t - (2S - 1) + s`` (the hidden activation rematerialized from
the stashed input), sends the activation to ``r + 1`` and the cotangent to
``r - 1`` in one batch (``ring_exchange``), and keeps each in-flight input
in a ring of ``2S`` slots. No autograd: the gradients are returned.

Like :mod:`petastorm_tpu_torch.models.moe`, the entry points keep the JAX
package's global view: every rank passes the whole batch and its block of
the params (``shard_params`` with :func:`pipeline_param_partition_specs`)
and gets the whole logits or loss; the gradients each rank gets are the
JAX gradients (its stage's block of the stacked weights).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from petastorm_tpu_torch.models.image_classifier import masked_cross_entropy, sgd_step
from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.torch_utils.mesh import Mesh
from petastorm_tpu_torch.torch_utils.sharding import (
    copy_to_group,
    enter_sequence_parallel,
    leave_sequence_parallel,
    psum,
    rank_slice,
    ring_exchange,
    ring_permute,
)

_PARAMS = ("embed", "w1", "w2", "head")


def init_pipeline_params(seed, feature_dim, d_model=64, d_hidden=128, num_stages=4,
                         num_classes=10, dtype=torch.float32, device="cuda"):
    """The JAX ``init_pipeline_params``' pytree and distributions (each
    weight ~ N(0, 1/fan_in)), drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shapes = {"embed": ((feature_dim, d_model), feature_dim),
              "w1": ((num_stages, d_model, d_hidden), d_model),
              "w2": ((num_stages, d_hidden, d_model), d_hidden),
              "head": ((d_model, num_classes), d_model)}
    return {name: (torch.randn(shape, generator=gen) / math.sqrt(fan)).to(device, dtype)
            for name, (shape, fan) in shapes.items()}


def params_from_jax(numpy_params, device="cuda"):
    """The JAX pipeline's parameter pytree (numpy arrays) as tensors on
    ``device``, every array copied as it is."""
    device = resolve_device(device)
    return {name: torch.tensor(np.asarray(numpy_params[name])).to(device) for name in _PARAMS}


def pipeline_param_partition_specs():
    """Partition specs over a mesh with a ``"pp"`` axis: one stage's block
    a rank; embed and head replicated."""
    return {"embed": (), "w1": ("pp",), "w2": ("pp",), "head": ()}


def _block(w1, w2, x):
    """One stage: a residual two-layer MLP."""
    return x + torch.relu(x @ w1) @ w2


def _check_stages(params, mesh, axis_name):
    num_stages = mesh.shape[axis_name]
    if params["w1"].shape[0] != 1:
        raise ValueError(
            f"params stack {params['w1'].shape[0] * num_stages} stages but the mesh's "
            f"{axis_name!r} axis has {num_stages} devices")
    return num_stages


def _pipeline_body(w1, w2, x_mb, mesh, axis_name, num_stages, num_microbatches):
    """One rank's GPipe schedule: ``w1`` / ``w2`` its stage ``[1, d, h]`` /
    ``[1, h, d]``, ``x_mb`` ``[M, mb, d]`` (only stage 0 reads it). Returns
    ``[M, mb, d]``: the finished microbatches on the last stage, zeros
    elsewhere."""
    group = mesh.group(axis_name)
    stage = mesh.axis_index(axis_name)
    last = num_stages - 1
    act = torch.zeros_like(x_mb[0])
    # The record rides every permute as its carry (module docstring); it
    # must be in the graph on every rank from the first tick on.
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (w1, w2, x_mb))
    outs = torch.zeros_like(x_mb).requires_grad_(grad)
    # Every stage selects its input from x_mb, as the JAX body does, so x_mb
    # is in every rank's graph (with a zero cotangent off stage 0) and the
    # sum of its cotangents over the stages runs on every rank.
    first = torch.tensor(stage == 0, device=x_mb.device)
    for t in range(num_microbatches + num_stages - 1):
        m = t - stage
        if 0 <= m < num_microbatches:
            out = _block(w1[0], w2[0], torch.where(first, x_mb[m], act))
            if stage == last:
                outs = outs.index_copy(0, torch.tensor([m], device=outs.device), out[None])
        else:
            out = torch.zeros_like(act)
        act, outs = ring_permute([out], carry=(outs,), group=group)
    return outs


def pipeline_forward(params, x_mb, mesh, axis_name="pp", batch_axis=None):
    """``[M, mb, d_model]`` microbatches → ``[M, mb, d_model]`` through the
    S-stage pipeline over ``mesh[axis_name]``, on every rank. ``params``:
    the rank's block (one stage). ``batch_axis``: the mesh axis the
    microbatch dim is split over (dp × pp: each data group runs the same
    schedule on its slice of every microbatch). Differentiate a loss of
    the output with ``.backward()`` (see ``image_classifier.sgd_step``)."""
    mesh = mesh if mesh is not None else Mesh((1,), (axis_name,))
    num_stages = _check_stages(params, mesh, axis_name)
    stages = mesh.group(axis_name)
    replicas = mesh.group(batch_axis) if batch_axis else None
    # The data slice (backward: all-gathered), which every stage holds and
    # only stage 0 reads (backward: summed over the stages).
    (x_local,) = enter_sequence_parallel([x_mb], replicas, dim=1)
    x_local = copy_to_group(x_local, stages)
    outs = _pipeline_body(copy_to_group(params["w1"], replicas),
                          copy_to_group(params["w2"], replicas), x_local, mesh, axis_name,
                          num_stages, x_mb.shape[0])
    return leave_sequence_parallel(psum(outs, stages), replicas, dim=1)


def _check_batch(b, num_microbatches, mesh, batch_axis):
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not divide into {num_microbatches} microbatches")
    if batch_axis is not None and mesh is not None:
        data = mesh.shape[batch_axis]
        if (b // num_microbatches) % data:
            raise ValueError(f"microbatch size {b // num_microbatches} does not shard over "
                             f"the {data}-device {batch_axis!r} axis")


def apply_pipeline_model(params, features, mesh, axis_name="pp", num_microbatches=4,
                         batch_axis=None):
    """``features`` ``[B, F]`` → float32 logits ``[B, C]`` on every rank; B
    must divide into ``num_microbatches`` equal microbatches (and each of
    them over ``batch_axis``)."""
    b = features.shape[0]
    _check_batch(b, num_microbatches, mesh, batch_axis)
    x = features @ params["embed"]
    x_mb = x.reshape(num_microbatches, b // num_microbatches, -1)
    out = pipeline_forward(params, x_mb, mesh, axis_name, batch_axis=batch_axis)
    return (out.reshape(b, -1) @ params["head"]).float()


def reference_forward(params, features):
    """The sequential oracle: the whole stack block by block in one
    process; ``params`` whole."""
    x = features @ params["embed"]
    for i in range(params["w1"].shape[0]):
        x = _block(params["w1"][i], params["w2"][i], x)
    return (x @ params["head"]).float()


@torch.no_grad()
def _1f1b_body(w1, w2, head, x_mb, labels_mb, mask_mb, *, mesh, axis_name, num_stages,
               num_microbatches, num_classes, batch_axis=None):
    """One rank's fused 1F1B schedule, as the JAX ``_1f1b_body``: tick
    ``t`` runs the backward of microbatch ``t - (2S - 1) + s`` (consuming
    the previous tick's cotangent, or on the last stage the cotangent its
    own forward seeded one tick before) and the forward of ``t - s``; the
    live span at stage ``s`` is ``2(S - s) - 1 < 2S`` slots of the stash.

    Returns ``(dw1 [1, d, h], dw2 [1, h, d], dhead, dx [M, mb, d], loss
    sum, count)``: ``dx`` is stage 0's input cotangents (zeros on the other
    stages), dhead / loss / count are still this rank's own, and the weight
    gradients are summed over ``batch_axis``."""
    group = mesh.group(axis_name)
    stage = mesh.axis_index(axis_name)
    s_count, m_count = num_stages, num_microbatches
    last = s_count - 1
    k_slots = 2 * s_count
    w1_s, w2_s = w1[0], w2[0]
    zero = torch.zeros_like(x_mb[0])
    act_in = cot_in = pending = zero
    stash = torch.zeros((k_slots,) + tuple(x_mb.shape[1:]), dtype=x_mb.dtype,
                        device=x_mb.device)
    dx = torch.zeros_like(x_mb)
    dw1, dw2, dhead = torch.zeros_like(w1_s), torch.zeros_like(w2_s), torch.zeros_like(head)
    lsum = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    cnt = torch.zeros_like(lsum)
    for t in range(m_count + 2 * s_count - 1):
        # Backward half.
        cot_out = zero
        m2 = t - (2 * s_count - 1) + stage
        if 0 <= m2 < m_count:
            xb = stash[m2 % k_slots]
            g = pending if stage == last else cot_in
            pre = xb @ w1_s
            hidden = torch.relu(pre)  # rematerialized from the stashed input
            dpre = (g @ w2_s.T) * (pre > 0)
            cot_out = g + dpre @ w1_s.T
            dw1 += xb.T @ dpre
            dw2 += hidden.T @ g
            if stage == 0:
                dx[m2] = cot_out
        # Forward half.
        act_out = zero
        m1 = t - stage
        if 0 <= m1 < m_count:
            x = x_mb[m1] if stage == 0 else act_in
            act_out = _block(w1_s, w2_s, x)
            stash[m1 % k_slots] = x
            if stage == last:
                # The loss of m1 and the cotangent this stage's backward
                # takes next tick.
                logits = act_out @ head
                label, msk = labels_mb[m1].long(), mask_mb[m1]
                logp = torch.log_softmax(logits, dim=-1)
                nll = -torch.gather(logp, 1, label[:, None])[:, 0]
                lsum += torch.where(msk, nll, torch.zeros_like(nll)).sum().float()
                cnt += msk.sum().float()
                onehot = torch.nn.functional.one_hot(label, num_classes).to(logits.dtype)
                dlogits = (torch.softmax(logits, dim=-1) - onehot) * msk[:, None].to(logits.dtype)
                dhead += act_out.T @ dlogits
                pending = dlogits @ head.T
        act_in, cot_in = ring_exchange(act_out, cot_out, group)
    if batch_axis is not None:
        replicas = mesh.group(batch_axis)
        dw1, dw2 = psum(dw1, replicas), psum(dw2, replicas)
    return dw1[None], dw2[None], dhead, dx, lsum, cnt


def pipeline_1f1b_loss_and_grads(params, features, labels, mask, mesh, axis_name="pp",
                                 num_microbatches=4, batch_axis=None):
    """The fused 1F1B forward and backward over the stage-split stack:
    ``(loss, grads)`` on every rank, ``grads`` equal to autograd's of the
    sequential (or GPipe) masked-mean cross-entropy, each rank's ``w1`` /
    ``w2`` its stage's. Embed runs outside the schedule (its gradient is
    ``features^T @ dx`` from stage 0's input cotangents); the head's
    forward and backward ride the last stage's ticks."""
    mesh = mesh if mesh is not None else Mesh((1,), (axis_name,))
    num_stages = _check_stages(params, mesh, axis_name)
    b = features.shape[0]
    _check_batch(b, num_microbatches, mesh, batch_axis)
    mb = b // num_microbatches
    replicas = mesh.group(batch_axis) if batch_axis else None
    with torch.no_grad():
        x = features @ params["embed"]
        d_model = x.shape[-1]

        def local(t):  # the rank's slice of every microbatch
            return rank_slice(t.reshape((num_microbatches, mb) + tuple(t.shape[1:])),
                              replicas, dim=1)

        x_mb, features_mb = local(x), local(features)
        dw1, dw2, dhead, dx, lsum, cnt = _1f1b_body(
            params["w1"], params["w2"], params["head"], x_mb, local(labels), local(mask),
            mesh=mesh, axis_name=axis_name, num_stages=num_stages,
            num_microbatches=num_microbatches, num_classes=params["head"].shape[-1],
            batch_axis=batch_axis)
        dembed = features_mb.reshape(-1, features.shape[-1]).T @ dx.reshape(-1, d_model)
        # dhead, the loss and the count live on the last stage, dembed on
        # stage 0, each on every data slice: one sum over the stages and
        # the slices makes them whole on every rank.
        sizes = [dhead.numel(), dembed.numel(), 1, 1]
        flat = torch.cat([dhead.reshape(-1), dembed.reshape(-1), lsum[None], cnt[None]])
        flat = psum(flat, mesh.group(((batch_axis,) if batch_axis else ()) + (axis_name,)))
        dhead, dembed, lsum, cnt = flat.split(sizes)
        denom = torch.clamp(cnt[0], min=1.0)
        grads = {"embed": dembed.reshape(params["embed"].shape) / denom, "w1": dw1 / denom,
                 "w2": dw2 / denom, "head": dhead.reshape(params["head"].shape) / denom}
    return lsum[0] / denom, grads


def make_pipeline_train_step(learning_rate=0.05, mesh=None, axis_name="pp",
                             num_microbatches=4, batch_axis=None, schedule="gpipe"):
    """``step(params, features, labels, mask) -> (params, loss)``: masked
    cross-entropy and SGD through the pipeline; every rank passes the
    whole batch and its block of the params. ``schedule="gpipe"``: the
    backward is autograd through the ticks; ``"1f1b"``: the fused
    hand-scheduled one (a ``2S``-slot stash whatever M); the two give the
    same step to float tolerance."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule {schedule!r} is not 'gpipe' or '1f1b'")
    if schedule == "1f1b":
        def step_1f1b(params, features, labels, mask):
            loss, grads = pipeline_1f1b_loss_and_grads(
                params, features, labels, mask, mesh, axis_name=axis_name,
                num_microbatches=num_microbatches, batch_axis=batch_axis)
            return {k: (p - learning_rate * grads[k]).to(p.dtype) for k, p in params.items()}, loss

        return step_1f1b

    def loss_fn(params, features, labels, mask):
        logits = apply_pipeline_model(params, features, mesh, axis_name=axis_name,
                                      num_microbatches=num_microbatches, batch_axis=batch_axis)
        return masked_cross_entropy(logits, labels, mask)

    def step(params, features, labels, mask):
        return sgd_step(loss_fn, params, learning_rate, features, labels, mask)

    return step
