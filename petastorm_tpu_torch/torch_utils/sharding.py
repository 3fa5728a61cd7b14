"""Rank defaults, equal-step coordination of data-parallel ranks, and the
collectives of the sequence- and model-parallel families, over
``torch.distributed`` (counterpart by name of
``petastorm_tpu/jax_utils/sharding.py``; the collectives are those the JAX
package's ``shard_map`` bodies call: ``lax.ppermute``, ``lax.all_to_all``,
``lax.psum`` / ``pmean``, and the transpose ``shard_map`` gives an input it
does not split, :func:`copy_to_group`).

Equal steps: ranks that read disjoint row-group shards must take the same
number of steps, or a gradient all-reduce waits forever for a rank that ran
out of data. Round-robin shards hold unequal row counts, so the safe count
is the smallest shard's batch count, which every rank computes from Parquet
metadata alone (:func:`global_step_count`,
:func:`derive_equal_step_max_batches`); where the count depends on the data,
ranks observe theirs (:func:`count_deliverable_batches`) and agree on the
minimum with one collective (:func:`agree_max_batches`). The JAX package's
``local_data_to_global_array`` has no counterpart: in the data-parallel
layout each rank keeps its local batch on its own card.

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

A process group stands where the JAX code has a mesh axis
(``torch_utils/mesh.py`` builds them for a grid of axes); ``group=None``
means one process (``sp = 1``, every collective an identity).

The model-parallel families take the same global view of their inputs and
outputs, and write out what ``shard_map`` derives for the backward:
:func:`psum` / :func:`pmean` (all-reduce forward, identity backward: what
follows is replicated) and :func:`copy_to_group` (identity forward,
all-reduce backward: what follows is each rank's own part), Megatron's g
and f. :func:`ring_exchange` posts both directions of a ring in one batch
for the hand-scheduled 1F1B pipeline, and :func:`all_reduce_grads` is the
data-parallel reduction of a module's gradients.

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

import warnings

import torch
import torch.distributed as dist

# The reader's shard arithmetic, re-exported where the JAX package defines
# it, so metadata-only step counts agree with what each rank reads.
from petastorm_tpu_torch.reader.reader import split_pieces_for_shards  # noqa: F401

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


def _batches_for_rows(rows, batch_size, last_batch):
    """Batches ``batch_iterator`` emits for a ``rows``-row stream."""
    if rows <= 0:
        return 0
    if last_batch == "drop":
        return rows // batch_size
    return -(-rows // batch_size)  # "pad" and "keep" emit the partial batch


def global_step_count(dataset_url, batch_size, shard_count, last_batch="drop",
                      num_epochs=1, shard_seed=None, filters=None, storage_options=None,
                      filesystem=None, hdfs_driver="libhdfs"):
    """The smallest shard's batch count over ``num_epochs`` epochs, from
    Parquet metadata alone: the same enumeration (``filters`` included) and
    shard arithmetic the reader plans with, then the batcher's
    ``last_batch`` policy. 0 when a shard is empty. ``storage_options``,
    ``filesystem`` and ``hdfs_driver`` select the filesystem, as for the
    readers."""
    if num_epochs is None:
        raise ValueError(
            "global_step_count requires a finite num_epochs (an infinite "
            "stream has no step count)")
    if shard_count is None or shard_count < 1:
        raise ValueError("shard_count must be a positive integer")
    from petastorm_tpu_torch.etl.metadata import piece_row_counts
    from petastorm_tpu_torch.fs_utils import FilesystemResolver
    from petastorm_tpu_torch.reader.reader import enumerate_row_group_pieces

    resolver = FilesystemResolver(dataset_url, hdfs_driver=hdfs_driver,
                                  storage_options=storage_options, filesystem=filesystem)
    fs = resolver.filesystem()
    pieces = enumerate_row_group_pieces(fs, resolver.get_dataset_path(), filters)
    counts = piece_row_counts(fs, pieces)
    return min(
        _batches_for_rows(sum(counts[(p.path, p.row_group)] for p in shard) * num_epochs,
                          batch_size, last_batch)
        for shard in split_pieces_for_shards(pieces, shard_count, shard_seed))


def _decline(reason):
    """Warn that no equal step count can be derived; returns None."""
    warnings.warn(f"Cannot derive an equal step count for {reason}. Pass "
                  "max_batches explicitly (observe it with "
                  "count_deliverable_batches, agree it with agree_max_batches) "
                  "or the ranks' steps may deadlock", UserWarning, stacklevel=3)
    return None


def derive_equal_step_max_batches(reader, batch_size, last_batch="drop"):
    """The smallest shard's batch count for ``reader``'s plan, computed on
    each rank with no collective (every rank enumerates the same store with
    the same ``shard_seed``), or None with a warning where metadata cannot
    know it: an infinite stream, NGram windows, a resumed reader, a
    row-level predicate or a ``TransformSpec`` function."""
    # The cheap refusals come first: shard_row_counts may read footers.
    num_epochs = getattr(reader, "num_epochs", 1)
    if num_epochs is None:
        return _decline("an infinite stream (num_epochs=None)")
    if getattr(reader, "ngram", None) is not None:
        return _decline("an NGram reader: windows per row group depend on the data")
    if getattr(reader, "_resume_state", None) is not None:
        return _decline("a resumed reader: the remaining rows depend on the checkpoint")
    if getattr(reader, "_predicate", None) is not None:
        return _decline("a row-level predicate: shard row counts depend on the data")
    if getattr(getattr(reader, "_transform_spec", None), "func", None) is not None:
        return _decline("a TransformSpec function: it can change shard row counts")
    counts = getattr(reader, "shard_row_counts", None)
    if counts is None:
        return None
    return min(_batches_for_rows(c * num_epochs, batch_size, last_batch) for c in counts)


def agree_max_batches(local_count, reduce="min", group=None):
    """One count for every rank of ``group`` (the default group when None)
    from each rank's observed ``local_count``: the minimum
    (``all_reduce(MIN)``, the only count every rank can deliver) or, with
    ``reduce="host0"``, the group's first rank's (a broadcast). With no
    group and no initialized default group, ``local_count``."""
    if reduce not in ("min", "host0"):
        raise ValueError(f"reduce {reduce!r} is not 'min' or 'host0'")
    local_count = int(local_count)
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return local_count
        group = dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return local_count
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    count = torch.tensor([local_count], dtype=torch.int64, device=device)
    if reduce == "min":
        dist.all_reduce(count, op=dist.ReduceOp.MIN, group=group)
    else:
        dist.broadcast(count, src=dist.get_global_rank(group, 0), group=group)
    return int(count.item())


def count_deliverable_batches(reader, batch_size, last_batch="drop"):
    """The batches ``reader`` delivers, counted by draining it once (then
    stopped): the observation half of :func:`agree_max_batches`, on a
    reader built apart from the training one with the same arguments."""
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator

    if getattr(reader, "num_epochs", 1) is None:
        raise ValueError(
            "count_deliverable_batches would never terminate on an infinite "
            "reader (num_epochs=None): construct the counting reader with "
            "num_epochs=1 and scale the agreed count by your epoch budget")
    with reader:
        return sum(1 for _ in batch_iterator(reader, batch_size, last_batch=last_batch))


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
    return _exchange_many(group, [(t, to_offset) for t in tensors])


def _exchange_many(group, sends):
    """``sends``: ``(tensor, to_offset)`` pairs. Each tensor goes to rank
    ``r + to_offset`` and its counterpart arrives from ``r - to_offset``
    (mod the group size), all posted in one ``batch_isend_irecv``; the i-th
    pair is tagged i, so two messages between one pair of ranks (a ring of
    two, where ``r + 1`` and ``r - 1`` are one rank) cannot cross. Returns
    the received tensors on their senders' devices."""
    if not sends:
        return []
    r, sp = group_rank_size(group)
    ops, bufs = [], []
    for tag, (t, to_offset) in enumerate(sends):
        dst = dist.get_global_rank(group, (r + to_offset) % sp)
        src = dist.get_global_rank(group, (r - to_offset) % sp)
        buf = _wire_buffer(group, t)
        ops.append(dist.P2POp(dist.isend, _to_wire(group, t), peer=dst, group=group, tag=tag))
        ops.append(dist.P2POp(dist.irecv, buf, peer=src, group=group, tag=tag))
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(t.device) for buf, (t, _) in zip(bufs, sends)]


def ring_exchange(forward, backward, group=None):
    """One tick of a two-way ring, without autograd: ``forward`` goes to
    rank ``r + 1`` and ``backward`` to rank ``r - 1`` (the reverse ring,
    on which a pipeline sends its cotangents), posted together so neither
    direction waits on the other. Returns ``(from r - 1, from r + 1)``;
    for one process, ``(forward, backward)``."""
    if group_rank_size(group)[1] == 1:
        return forward, backward
    return tuple(_exchange_many(group, [(forward, 1), (backward, -1)]))


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


def _all_reduce(group, x):
    """The sum of ``x`` over ``group``, in a new tensor on ``x``'s device;
    half-precision tensors are summed in float32 (gloo's reductions do not
    take every half type) and rounded once."""
    wire_dtype = torch.float32 if x.dtype in (torch.float16, torch.bfloat16) else x.dtype
    buf = _wire_buffer(group, x.to(wire_dtype))
    buf.copy_(x)
    dist.all_reduce(buf, group=group)
    return buf.to(device=x.device, dtype=x.dtype)


class PsumFn(torch.autograd.Function):
    """All-reduce forward; identity backward (see :func:`psum`)."""

    @staticmethod
    def forward(ctx, group, scale, x):
        ctx.scale = scale
        return _all_reduce(group, x) * scale

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad * ctx.scale


class CopyToGroupFn(torch.autograd.Function):
    """Identity forward; all-reduce backward (see :func:`copy_to_group`)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, _all_reduce(ctx.group, grad)


def psum(x, group=None):
    """``lax.psum(x, axis)``: the sum of ``x`` over ``group``, the same on
    every rank, as one autograd node whose backward is the IDENTITY.

    The convention (Megatron's "g", an all-reduce leaving a model-parallel
    region): what follows the sum is replicated over the group, every rank
    computing the same thing from it, so every rank already holds the whole
    cotangent of the sum, which is each addend's cotangent. Where ranks
    instead use one value differently and their cotangents are partial,
    the sum belongs in the backward: :func:`copy_to_group`. The identity
    for one process."""
    if group_rank_size(group)[1] == 1:
        return x
    return PsumFn.apply(group, 1, x)


def pmean(x, group=None):
    """``lax.pmean(x, axis)``: :func:`psum` divided by the group's size,
    with the same convention (identity backward, scaled: each addend's
    cotangent is the replicated cotangent over the size)."""
    _, n = group_rank_size(group)
    if n == 1:
        return x
    return PsumFn.apply(group, 1.0 / n, x)


def copy_to_group(x, group=None):
    """``x`` unchanged, as one autograd node whose backward SUMS the
    cotangent over ``group``.

    The convention (Megatron's "f", entering a model-parallel region; the
    transpose ``shard_map`` gives an input it does not split, ``P()``):
    every rank holds the same ``x`` and uses it on its own part of the
    work (its column block, its token shard, its pipeline stage), so each
    rank's cotangent is partial and ``x``'s is their sum, the same on every
    rank. The identity for one process."""
    if group_rank_size(group)[1] == 1:
        return x
    return CopyToGroupFn.apply(group, x)


def all_reduce_grads(params, group=None, mean=True):
    """Each ``p.grad`` of ``params`` summed over ``group`` in place (one
    all-reduce of them all, flattened) and, with ``mean``, divided by the
    group's size: the data-parallel reduction. A no-op for one process."""
    params = [p for p in params if p.grad is not None]
    _, n = group_rank_size(group)
    if n == 1 or not params:
        return
    flat = _all_reduce(group, torch.cat([p.grad.reshape(-1) for p in params]))
    if mean:
        flat = flat / n
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


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
