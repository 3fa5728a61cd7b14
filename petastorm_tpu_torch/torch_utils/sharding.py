"""Rank defaults and the collectives of sequence-parallel attention, over
``torch.distributed`` (counterpart by name of
``petastorm_tpu/jax_utils/sharding.py``; the collectives are those the JAX
package's ``shard_map`` bodies call: ``lax.ppermute`` and ``lax.all_to_all``).

The sequence-parallel attentions (``models/sequence_model.py``) keep the JAX
package's global view: every rank of a group holds the whole ``[B, T, ...]``
activations, computes the same model on them, and only attention is split
over T. So attention enters a sequence-parallel region by taking its rank's
slice of T (:func:`enter_sequence_parallel`, whose backward all-gathers the
slices' gradients) and leaves it by all-gathering the output
(:func:`leave_sequence_parallel`, whose backward takes the rank's slice of
the gradient and sums nothing: every rank already holds the whole of it).
``torch.distributed.nn``'s ``all_gather`` reduce-scatters in its backward
and would make each gradient ``sp`` times too large here.

A process group stands where the JAX code has a mesh axis; ``group=None``
means one process (``sp = 1``, every collective an identity).

Transport, chosen by the group's backend and nothing else: NCCL moves CUDA
tensors directly; gloo takes host tensors only, so a CUDA tensor sent
through a gloo group is staged through pinned host memory (copied there,
sent, copied back to its device). Two ranks on one card need gloo: NCCL
refuses two ranks on one device.

Every collective here is one ``torch.autograd.Function`` node per call, so
each rank's backward meets the collectives in the same order, which the
forward's data dependencies fix (see :func:`ring_permute`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: Backends that take host tensors only: CUDA tensors go through pinned
#: host memory.
HOST_STAGED_BACKENDS = ("gloo",)


def default_shard_options(cur_shard=None, shard_count=None):
    """Fill ``(cur_shard, shard_count)`` from ``torch.distributed`` when
    both are unset: the process's rank and the world size once a process
    group of more than one rank is initialized, else ``(None, None)`` (no
    sharding)."""
    if cur_shard is not None or shard_count is not None:
        return cur_shard, shard_count
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None, None


def reader_options(group=None):
    """Keyword arguments for a trainer's reader under ``group``:
    ``{"workers_count": 1}`` for a group of more than one rank, ``{}``
    otherwise.

    Under the global view every rank of a group trains on the whole batch,
    so every rank's reader must yield the same rows in the same order. A
    thread pool of several workers publishes row groups as they finish, in
    an order that differs between processes; one worker decodes them in the
    ventilator's order, which the seeded shuffle fixes (``shard_seed``), so
    readers built alike agree batch for batch, and the pool's bounded
    results queue keeps decode a bounded distance ahead of the trainer."""
    return {"workers_count": 1} if group_rank_size(group)[1] > 1 else {}


def group_rank_size(group):
    """``(rank in group, group size)``; ``(0, 1)`` for ``group=None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _host_staged(group, t):
    return t.is_cuda and dist.get_backend(group) in HOST_STAGED_BACKENDS


def _to_wire(group, t):
    """``t`` as the group's backend takes it: contiguous, and in pinned host
    memory for a CUDA tensor through a host-staged backend."""
    t = t.contiguous()
    if _host_staged(group, t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _wire_buffer(group, like):
    if _host_staged(group, like):
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _exchange(group, tensors, to_offset):
    """Send each of ``tensors`` to rank ``r + to_offset`` and receive its
    counterpart from rank ``r - to_offset`` (mod the group size); return
    the received tensors on their senders' devices."""
    if not tensors:
        return []
    r, sp = group_rank_size(group)
    dst = dist.get_global_rank(group, (r + to_offset) % sp)
    src = dist.get_global_rank(group, (r - to_offset) % sp)
    ops, bufs = [], []
    for t in tensors:
        buf = _wire_buffer(group, t)
        ops.append(dist.P2POp(dist.isend, _to_wire(group, t), peer=dst, group=group))
        ops.append(dist.P2POp(dist.irecv, buf, peer=src, group=group))
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(t.device) for buf, t in zip(bufs, tensors)]


class RingPermuteFn(torch.autograd.Function):
    """``lax.ppermute`` over the ring ``r -> r + 1``: the first ``n_send``
    tensors go to the next rank and arrive from the previous one; the rest
    pass through unchanged. The backward sends the gradients the reverse
    way."""

    @staticmethod
    def forward(ctx, group, n_send, *tensors):
        ctx.group, ctx.n_send = group, n_send
        ctx.floating = [t.is_floating_point() for t in tensors[:n_send]]
        sent = _exchange(group, tensors[:n_send], 1)
        ctx.mark_non_differentiable(*(t for t in sent if not t.is_floating_point()))
        return (*sent, *tensors[n_send:])

    @staticmethod
    def backward(ctx, *grads):
        n, floating = ctx.n_send, ctx.floating
        back = iter(_exchange(ctx.group, [g for g, f in zip(grads[:n], floating) if f], -1))
        return (None, None, *(next(back) if f else None for f in floating), *grads[n:])


def ring_permute(send, carry=(), group=None):
    """``send`` (tensors) moved one step along the ring ``r -> r + 1``, and
    ``carry`` (tensors) unchanged, as one autograd node: ``(received...,
    carry...)``.

    ``carry`` is how a ring loop threads its running state through each
    permute: the output then depends on every permute on every rank, so
    every rank's backward runs every permute's backward, in the reverse of
    the forward's order, even where a rank skipped a block's compute (the
    contiguous causal ring), which keeps the ranks' sends and receives
    paired."""
    send, carry = tuple(send), tuple(carry)
    if group_rank_size(group)[1] == 1:
        return send + carry
    return RingPermuteFn.apply(group, len(send), *send, *carry)


def _all_to_all_one(group, x, split_axis, concat_axis):
    _, sp = group_rank_size(group)
    chunks = torch.stack(x.chunk(sp, dim=split_axis))     # [sp, ...]: chunk j to rank j
    wire = _to_wire(group, chunks)
    out = _wire_buffer(group, chunks)
    dist.all_to_all_single(out, wire, group=group)
    return torch.cat(out.to(x.device).unbind(0), dim=concat_axis)


class AllToAllFn(torch.autograd.Function):
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` for each
    tensor: its ``split_axis`` is cut into ``sp`` chunks, chunk j goes to
    rank j, and the chunks received are concatenated along ``concat_axis``
    in rank order. The backward is the same exchange with the axes
    swapped."""

    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, *tensors):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return tuple(_all_to_all_one(group, x, split_axis, concat_axis) for x in tensors)

    @staticmethod
    def backward(ctx, *grads):
        split_axis, concat_axis = ctx.axes
        return (None, None, None, *(
            None if g is None else _all_to_all_one(ctx.group, g, concat_axis, split_axis)
            for g in grads))


def all_to_all(tensors, split_axis, concat_axis, group=None):
    """The tiled all-to-all of Ulysses attention on each of ``tensors``, as
    one autograd node; identities for one process."""
    tensors = tuple(tensors)
    if group_rank_size(group)[1] == 1:
        return tensors
    return AllToAllFn.apply(group, split_axis, concat_axis, *tensors)


def rank_slice(x, group=None, dim=1):
    """The rank's slice of ``dim`` of ``x``: a plain slice, whose backward
    gathers nothing (for ids and other tensors without a gradient)."""
    r, sp = group_rank_size(group)
    if x.shape[dim] % sp:
        raise ValueError(
            f"axis {dim} of length {x.shape[dim]} does not split over "
            f"{sp} sequence-parallel ranks")
    return x.chunk(sp, dim=dim)[r].contiguous()


def _gather(group, x, dim):
    _, sp = group_rank_size(group)
    wire = _to_wire(group, x)
    parts = [_wire_buffer(group, wire) for _ in range(sp)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p.to(x.device) for p in parts], dim=dim)


class EnterSequenceParallelFn(torch.autograd.Function):
    """The rank's slice along ``dim`` of each tensor; the backward
    all-gathers the slices' gradients (each rank computed its slice's)."""

    @staticmethod
    def forward(ctx, group, dim, *tensors):
        ctx.group, ctx.dim = group, dim
        return tuple(rank_slice(x, group, dim) for x in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(None if g is None else _gather(ctx.group, g, ctx.dim)
                              for g in grads))


class LeaveSequenceParallelFn(torch.autograd.Function):
    """The slices of all ranks, all-gathered along ``dim``; the backward
    takes the rank's slice of the gradient, unsummed (every rank holds the
    whole gradient already)."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        return _gather(group, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, rank_slice(grad, ctx.group, ctx.dim)


def enter_sequence_parallel(tensors, group=None, dim=1):
    """Each of ``tensors`` (global, the same on every rank) cut to the
    rank's slice of ``dim``, as one autograd node; identities for one
    process."""
    tensors = tuple(tensors)
    if group_rank_size(group)[1] == 1:
        return tensors
    return EnterSequenceParallelFn.apply(group, dim, *tensors)


def leave_sequence_parallel(x, group=None, dim=1):
    """The ranks' slices of ``dim`` gathered into the global tensor (the
    same on every rank); the identity for one process."""
    if group_rank_size(group)[1] == 1:
        return x
    return LeaveSequenceParallelFn.apply(group, dim, x)
