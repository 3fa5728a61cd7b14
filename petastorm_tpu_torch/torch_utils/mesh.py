"""A ``torch.distributed`` world laid out as a named grid, and the slicing of
parameters over it: the port's counterpart of ``jax.sharding.Mesh`` and
``PartitionSpec`` for the model-parallel families (``models/moe.py``,
``models/pipeline.py``, the tensor-parallel image classifier and the
table-parallel DLRM).

The ranks of the default process group fill the grid in row-major order,
so for a ``(data, model)`` grid rank ``r`` sits at ``(r // model, r %
model)``. The mesh builds one process group for every line of the grid
along every non-empty set of its axes, so a model's collectives over
``"ep"``, or over ``("data", "ep")`` together, run within the rank's own
line, as a ``shard_map`` collective over those axes does.
``torch.distributed.new_group`` is collective over the whole world: every
rank creates every group, its own or not, in one order, here.

A partition spec is a tuple with one entry per tensor dimension: a mesh
axis name (that dimension is split over the axis, each rank keeping its
coordinate's contiguous block) or ``None`` (not split); ``()`` is
replicated. :func:`shard_params` applies a dict of them.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch.distributed as dist


class Mesh:
    """The default group's ranks as a grid of ``axis_sizes`` named
    ``axis_names``: ``Mesh((2, 2), ("data", "ep"))``. A mesh of size 1
    is the rank alone, with or without a process group (every collective
    over it is an identity); a larger one must hold the whole world."""

    def __init__(self, axis_sizes, axis_names):
        axis_sizes, axis_names = tuple(int(n) for n in axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis sizes {axis_sizes} and names {axis_names} do not pair up")
        size = math.prod(axis_sizes)
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        if size != 1 and size != world:
            raise ValueError(f"a mesh of {axis_sizes} holds {size} ranks, but the world has "
                             f"{world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, axis_sizes))
        rank = dist.get_rank() if initialized and size > 1 else 0
        self._coords = dict(zip(axis_names, np.unravel_index(rank, axis_sizes)))
        self._groups = {}
        grid = np.arange(size).reshape(axis_sizes)
        for k in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(range(len(axis_names)), k):
                names = tuple(axis_names[a] for a in axes)
                n = math.prod(axis_sizes[a] for a in axes)
                if n == 1:
                    continue
                # Each line along ``axes``: the other axes' coordinates fixed.
                rest = [a for a in range(len(axis_names)) if a not in axes]
                lines = np.transpose(grid, rest + list(axes)).reshape(-1, n)
                for line in lines:
                    ranks = line.tolist()
                    group = (dist.group.WORLD if n == world
                             else dist.new_group(ranks))
                    if rank in ranks:
                        self._groups[names] = group

    def _axes(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in axes if a is not None)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"the mesh has no axis {unknown[0]!r} (axes: {self.axis_names})")
        return tuple(a for a in self.axis_names if a in axes)  # the mesh's order

    def size(self, axes):
        """The number of ranks along ``axes`` (a name or a tuple of them)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes):
        """``lax.axis_index``: the rank's coordinate along ``axes``, row-major
        over a tuple of them in the mesh's order."""
        index = 0
        for a in self._axes(axes):
            index = index * self.shape[a] + int(self._coords[a])
        return index

    def group(self, axes):
        """The process group of the rank's line along ``axes``; None when
        that line is the rank alone (a collective over it is an
        identity)."""
        return self._groups.get(self._axes(axes))

    def __repr__(self):
        return f"Mesh({self.shape})"


def shard_params(params, specs, mesh):
    """The rank's block of each tensor of ``params`` (a dict) under
    ``specs`` (a dict of partition specs, the same keys), as new contiguous
    tensors on each tensor's device: replicated tensors are copied whole.
    Raises ValueError naming the tensor when a dimension does not split
    over its axis."""
    out = {}
    for name, tensor in params.items():
        spec = tuple(specs[name])
        if len(spec) > tensor.dim():
            raise ValueError(f"{name}: spec {spec} has more entries than its {tensor.dim()} "
                             "dimensions")
        block = tensor
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.size(axis)
            if block.shape[dim] % n:
                raise ValueError(f"{name}: dimension {dim} of length {block.shape[dim]} does "
                                 f"not split over the mesh's {axis!r} axis of {n} ranks")
            length = block.shape[dim] // n
            block = block.narrow(dim, mesh.axis_index(axis) * length, length)
        out[name] = block.detach().clone().contiguous()
    return out


def shard_bytes(params):
    """The bytes of a dict of tensors: a rank's share under :func:`shard_params`
    beside the whole's."""
    return sum(t.numel() * t.element_size() for t in params.values())


def _rank_entry(target, rank, world_size, out_dir, args, cuda_device):
    import traceback

    try:
        if cuda_device is not None:
            import torch

            torch.cuda.set_device(cuda_device)
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                                world_size=world_size)
        target(rank, *args)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(target, world_size, out_dir, args=(), timeout_s=600, cuda_device=None):
    """Run ``target(rank, *args)`` in ``world_size`` spawned processes joined
    in one gloo group through a ``FileStore`` under ``out_dir`` (no port),
    each on ``cuda_device`` if given (gloo lets several ranks share a card;
    NCCL does not), and join them all: a rank still alive at
    ``timeout_s`` is killed. Raises RuntimeError with each failed rank's
    exit code and traceback. ``target`` and ``args`` must pickle (a
    module-level function)."""
    import multiprocessing
    import os
    import time

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world_size, out_dir, args,
                                                   cuda_device))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = []
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            err = os.path.join(out_dir, f"rank{r}.err")
            trace = "no traceback"
            if os.path.exists(err):
                with open(err) as f:
                    trace = f.read()
            failed.append(f"rank {r} (exit {p.exitcode}):\n{trace}")
    if failed:
        raise RuntimeError("\n".join(failed))
