"""DLRM-style tabular recommender trained from a plain-Parquet store, on the
card.

Counterpart of ``petastorm_tpu/models/tabular_dlrm.py`` (``init_dlrm_params``,
``apply_dlrm``, ``make_dlrm_train_step``), of the Criteo-shaped store of
``petastorm_tpu/benchmark/scenarios.py::make_tabular_dataset``, and of the
trainer ``examples/criteo_dlrm/train_dlrm.py``: ``make_batch_reader`` (seeded
row-group shuffle, optional ``filters``) → ``make_torch_dataloader`` (column
batches re-sliced to the batch size, pinned H2D on the copy stream) →
bottom MLP → hashed embedding lookups → pairwise dot-product interaction →
top MLP → masked BCE-with-logits → plain SGD; the input pipeline
checkpoints with the loader's ``state_dict()`` and resumes with
``resume_state=``, and under a ``torch.distributed`` group each rank reads
its row-group shard, the ranks take the same number of steps, and the
gradients are averaged over the group (data parallel).

Without such a group the SGD step updates only the table rows a batch
names (``ops/sparse_sgd.py``; on the card ``ops/csrc/sparse_sgd.cu``):
under plain SGD every other row's gradient is zero and its value stays, so
the tables end as the dense update leaves them, bit for bit, with no
table-sized gradient made, zeroed, scaled or added. The JAX step updates
the tables densely; under a data-parallel group the port does too, and
all-reduces the dense gradient.

Parameters are float32 and cast to ``compute_dtype`` (bfloat16 by default)
inside the forward, as the reference does; the logits are float32. Dense
kernels keep the JAX layout ``[d_in, d_out]`` (``x @ w``).

Table parallel over a mesh's ``"model"`` axis (:func:`shard_dlrm`, the JAX
``dlrm_partition_specs``): each rank holds ``num_sparse / model`` whole
tables and looks up, for every row of its data-parallel batch, only its
own. An all-to-all over ``"model"`` (``sharding.all_to_all``, its backward
the reverse exchange) turns the ``[B, S/model, D]`` lookups into
``[B/model, S, D]``: each rank then runs the MLPs and the interaction on
its ``B / model`` rows, with every table, and the logits are all-gathered
back to ``[B]`` (backward: the rank's rows). The replicated MLP weights
enter through ``copy_to_group``, so their gradients are summed over the
ranks' rows. No rank holds the whole ``[S, vocab, D]`` stack, and the MLPs
run once per row, not once per rank. So the batch must divide by the
``"model"`` axis, where the JAX specs' replicated batch takes any size. The data-parallel mean over
``"data"`` is ``dlrm_gradients(group=...)``'s, as without the split.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from petastorm_tpu_torch.benchmark.scenarios import (  # noqa: F401  (the store's writer)
    DEFAULT_TABULAR_DAYS,
    DEFAULT_TABULAR_ROWS,
    make_tabular_dataset,
)
from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.ops.sparse_sgd import sparse_sgd
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.torch_utils.sharding import (
    all_reduce_grads,
    all_to_all,
    copy_to_group,
    leave_sequence_parallel,
    rank_slice,
)

NUM_DENSE, NUM_SPARSE = 13, 26
#: The Criteo example's SGD learning rate (examples/criteo_dlrm/train_dlrm.py:56).
LEARNING_RATE = 0.05
_MLP = ("bottom1", "bottom2", "top1", "top2")


class DLRM(nn.Module):
    """Bottom MLP over the dense features (→ one pseudo-embedding), one
    hashed lookup per table, the upper triangle of the pairwise dot
    products of the ``num_sparse + 1`` feature vectors, top MLP → f32
    logits ``[B]``. With a ``mesh``, the rank's table-parallel block:
    ``num_sparse / model`` tables (see the module docstring)."""

    def __init__(self, num_dense=NUM_DENSE, num_sparse=NUM_SPARSE, vocab_size=1024,
                 embed_dim=16, bottom_hidden=64, top_hidden=64,
                 compute_dtype=torch.bfloat16, mesh=None):
        super().__init__()
        features = num_sparse + 1
        interact = features * (features - 1) // 2 + embed_dim
        model = mesh.size("model") if mesh is not None else 1
        if num_sparse % model:
            raise ValueError(f"{num_sparse} tables do not split over the mesh's 'model' axis "
                             f"of {model} ranks")
        self.compute_dtype = compute_dtype
        self._model = model
        self._group = mesh.group("model") if mesh is not None else None
        local = num_sparse // model
        self._first_table = (mesh.axis_index("model") if mesh is not None else 0) * local
        self.embeddings = nn.Parameter(torch.zeros(local, vocab_size, embed_dim))
        shapes = {"bottom1": (num_dense, bottom_hidden), "bottom2": (bottom_hidden, embed_dim),
                  "top1": (interact, top_hidden), "top2": (top_hidden, 1)}
        for name, (d_in, d_out) in shapes.items():
            setattr(self, f"{name}_kernel", nn.Parameter(torch.zeros(d_in, d_out)))
            setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(d_out)))
        self.register_buffer("_triu", torch.triu_indices(features, features, 1),
                             persistent=False)

    def _dense(self, name, x):
        cd = self.compute_dtype
        kernel, bias = (copy_to_group(getattr(self, f"{name}_{part}"), self._group).to(cd)
                        for part in ("kernel", "bias"))
        return x @ kernel + bias

    def _ids(self, sparse_ids):
        """The rank's tables' hashed ids ``[B, S_local]`` (int64)."""
        local, vocab, _ = self.embeddings.shape
        return torch.remainder(sparse_ids[:, self._first_table:self._first_table + local],
                               vocab).long()

    def lookup(self, sparse_ids):
        """``(index, rows)`` for the sparse update: ``index`` ``[B·S_local]``
        is each lookup's row in the rank's tables seen as one
        ``[S_local·vocab, D]`` matrix (``table × vocab + id % vocab``,
        row-major over ``[B, S_local]``), and ``rows`` ``[B, S_local, D]``
        the float32 rows it names, gathered without autograd and set to
        require a gradient: a leaf of their own, for :meth:`forward`'s
        ``rows``."""
        local, vocab, dim = self.embeddings.shape
        ids = self._ids(sparse_ids)
        index = (ids + torch.arange(local, device=ids.device) * vocab).reshape(-1)
        with torch.no_grad():
            rows = self.embeddings.view(-1, dim).index_select(0, index)
        return index, rows.view(*ids.shape, dim).requires_grad_(True)

    def forward(self, dense, sparse_ids, rows=None):
        """``dense`` float ``[B, num_dense]``, ``sparse_ids`` int
        ``[B, num_sparse]`` raw ids (hashed ``% vocab_size`` here). ``rows``:
        the looked-up rows of :meth:`lookup`, in place of looking them up
        (the same values; the gradient then reaches them, not the tables).
        With a mesh, ``B`` must divide by the ``"model"`` axis (the exchange
        splits the batch over it); else ValueError."""
        if self._group is not None and dense.shape[0] % self._model:
            raise ValueError(f"a batch of {dense.shape[0]} rows does not split over the "
                             f"mesh's 'model' axis of {self._model} ranks")
        if rows is None:
            emb = self.embeddings.to(self.compute_dtype)
            ids = self._ids(sparse_ids)                                     # [B, S_local]
            tables = torch.arange(emb.shape[0], device=ids.device)
            looked_up = emb[tables, ids]                                    # [B, S_local, D]
        else:
            looked_up = rows.to(self.compute_dtype)
        if self._group is not None:
            # [B, S/model, D] -> [B/model, S, D], float32 on the wire (bf16
            # values move exactly) since gloo's all-to-all takes no bf16.
            (looked_up,) = all_to_all([looked_up.float()], 0, 1, self._group)
            looked_up = looked_up.to(self.compute_dtype)
            dense = rank_slice(dense, self._group, dim=0)
        x = torch.relu(self._dense("bottom1", dense.to(self.compute_dtype)))
        dense_vec = torch.relu(self._dense("bottom2", x))                  # [B, D]
        feats = torch.cat([dense_vec[:, None], looked_up], dim=1)           # [B, F, D]
        inter = torch.bmm(feats, feats.transpose(1, 2))                     # [B, F, F]
        pairwise = inter[:, self._triu[0], self._triu[1]]
        x = torch.relu(self._dense("top1", torch.cat([dense_vec, pairwise], dim=1)))
        return leave_sequence_parallel(self._dense("top2", x)[:, 0].float(), self._group, dim=0)


def init_dlrm(num_dense=NUM_DENSE, num_sparse=NUM_SPARSE, vocab_size=1024, embed_dim=16,
              bottom_hidden=64, top_hidden=64, compute_dtype=torch.bfloat16, seed=0,
              device="cuda"):
    """A :class:`DLRM` at ``init_dlrm_params``' defaults (13 dense, 26
    tables of 1024 x 16, bottom and top hidden 64) with its initial
    distributions (embeddings N(0, 0.05²), kernels N(0, 1/fan_in), zero
    biases), drawn on the CPU from ``torch.Generator().manual_seed(seed)``."""
    device = resolve_device(device)
    model = DLRM(num_dense, num_sparse, vocab_size, embed_dim, bottom_hidden, top_hidden,
                 compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.embeddings.copy_(torch.randn(model.embeddings.shape, generator=gen) * 0.05)
        for name in _MLP:
            kernel = getattr(model, f"{name}_kernel")
            kernel.copy_(torch.randn(kernel.shape, generator=gen) / math.sqrt(kernel.shape[0]))
    return model.to(device)


def params_from_jax(numpy_params, compute_dtype=torch.bfloat16, device="cuda"):
    """The JAX DLRM's parameter pytree (numpy arrays: ``embeddings``
    ``[S, vocab, D]`` and ``bottom1``/``bottom2``/``top1``/``top2``, each
    ``{kernel, bias}``) as a :class:`DLRM` on ``device``, every array copied
    as it is."""
    device = resolve_device(device)
    emb = np.asarray(numpy_params["embeddings"], np.float32)
    num_sparse, vocab, embed_dim = emb.shape
    model = DLRM(np.shape(numpy_params["bottom1"]["kernel"])[0], num_sparse, vocab, embed_dim,
                 np.shape(numpy_params["bottom1"]["kernel"])[1],
                 np.shape(numpy_params["top1"]["kernel"])[1], compute_dtype)
    tensors = {"embeddings": emb}
    for name in _MLP:
        tensors[f"{name}_kernel"] = numpy_params[name]["kernel"]
        tensors[f"{name}_bias"] = numpy_params[name]["bias"]
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v, np.float32))
                           for k, v in tensors.items()})
    return model.to(device)


def dlrm_partition_specs():
    """Partition specs (``torch_utils/mesh.py``) of a :class:`DLRM`'s
    parameters over a mesh with a ``"model"`` axis: the embedding stack
    split table-wise on its leading axis, the MLPs replicated."""
    return {name: ("model", None, None) if name == "embeddings" else ()
            for name in ["embeddings"] + [f"{m}_{p}" for m in _MLP for p in ("kernel", "bias")]}


def shard_dlrm(model, mesh):
    """The rank's table-parallel block of the whole ``model`` over
    ``mesh``'s ``"model"`` axis, as a new :class:`DLRM` on the model's
    device (shard a model on the CPU to keep the whole stack off the
    card)."""
    from petastorm_tpu_torch.torch_utils.mesh import shard_params

    num_sparse, vocab, embed_dim = model.embeddings.shape
    sharded = DLRM(model.bottom1_kernel.shape[0], num_sparse, vocab, embed_dim,
                   model.bottom1_kernel.shape[1], model.top1_kernel.shape[1],
                   model.compute_dtype, mesh=mesh)
    sharded.load_state_dict(shard_params(model.state_dict(), dlrm_partition_specs(), mesh))
    return sharded.to(model.embeddings.device)


def masked_bce_with_logits(logits, labels, mask):
    """Mean stable BCE-with-logits over the rows where ``mask`` is True."""
    labels = labels.float()
    losses = torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))
    mask = mask.float()
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _gradients(model, dense, sparse_ids, labels, mask, group=None, row_leaf=False):
    """``(loss, index, rows)``: the forward and backward of one batch in
    the spans ``step.forward`` (``zero_grad``, with ``row_leaf`` the
    lookup, and the loss) and ``step.backward`` (the backward and, under
    ``group``, the all-reduce). With ``row_leaf`` the looked-up rows are a
    leaf of their own (:meth:`DLRM.lookup`): their gradient lands in
    ``rows.grad`` and the tables get none; else ``index`` and ``rows`` are
    None and the tables get the dense gradient."""
    with tracing.span("step.forward"):
        model.zero_grad(set_to_none=True)
        index, rows = model.lookup(sparse_ids) if row_leaf else (None, None)
        loss = masked_bce_with_logits(model(dense, sparse_ids, rows=rows), labels, mask)
    with tracing.span("step.backward"):
        loss.backward()
        all_reduce_grads(model.parameters(), group)
    return loss.detach(), index, rows


def dlrm_gradients(model, dense, sparse_ids, labels, mask, group=None):
    """``(loss, {name: gradient})`` of one batch, the tables' gradient dense
    (``[S_local, vocab, D]``); under ``group`` each gradient is summed over
    the ranks (one all-reduce of them all, flattened) and divided by their
    number, the data-parallel mean. The spans ``step.forward`` (``zero_grad``
    and the loss) and ``step.backward`` (the backward and the all-reduce)."""
    loss, _, _ = _gradients(model, dense, sparse_ids, labels, mask, group)
    return loss, {name: p.grad for name, p in model.named_parameters()}


def make_dlrm_train_step(model, learning_rate=0.01, group=None):
    """``step(dense, sparse_ids, labels, mask) -> loss``: one SGD step on
    ``model``'s parameters, in place; ``mask`` is the loader's
    ``__pad_mask__`` (all True when unpadded), so padded rows add nothing.
    The update is the span ``step.update``, after the spans of
    :func:`dlrm_gradients`.

    Without a data-parallel ``group`` (one process, or a table-parallel
    model whose only group is its ``"model"`` axis) the tables take the
    sparse update: the looked-up rows are a leaf of their own, and only the
    rows the batch names change (:func:`~petastorm_tpu_torch.ops.sparse_sgd.sparse_sgd`,
    in the span ``dlrm.sparse_update`` with ``lookups``), to the values the
    dense update gives them; no table-sized gradient is made.
    ``step.last_touched_rows`` then holds the last step's count of changed
    rows, a 0-dim tensor on the model's device (reading it waits for the
    device). Under ``group`` the gradients are the ranks' mean, the tables'
    dense, as :func:`dlrm_gradients` gives them."""

    def step(dense, sparse_ids, labels, mask):
        loss, index, rows = _gradients(model, dense, sparse_ids, labels, mask, group,
                                       row_leaf=group is None)
        with tracing.span("step.update"), torch.no_grad():
            for name, p in model.named_parameters():
                if index is None or name != "embeddings":
                    p -= learning_rate * p.grad
            if index is not None:
                with tracing.span("dlrm.sparse_update", lookups=index.numel()):
                    dim = model.embeddings.shape[-1]
                    step.last_touched_rows = sparse_sgd(
                        model.embeddings.view(-1, dim), index,
                        rows.grad.reshape(-1, dim), learning_rate)
        return loss

    step.last_touched_rows = None
    return step


def collate_dlrm(batch):
    """A loader batch of the tabular store → ``(dense [B, 13], sparse_ids
    [B, 26], labels [B])`` on the batch's device, in the span ``dlrm.collate``."""
    with tracing.span("dlrm.collate"):
        dense = torch.stack([batch[f"dense_{i}"] for i in range(NUM_DENSE)], dim=1)
        sparse = torch.stack([batch[f"cat_{i}"] for i in range(NUM_SPARSE)], dim=1)
    return dense, sparse, batch["label"]


#: Steps left out of the warm clock (the reader's start, the first pinned
#: batches and the first steps' allocations).
WARM_FROM_STEP = 10


def train_dlrm(dataset_url, batch_size=256, epochs=2, interrupt_after=None,
               resume_state=None, model=None, device="cuda", filters=None, group=None,
               checkpoint_dir=None, collect_field=None):
    """The tabular path end to end on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``), as ``examples/criteo_dlrm/train_dlrm.py``:
    ``make_batch_reader(num_epochs=epochs, shuffle_row_groups=True,
    shard_seed=7, filters=..., resume_state=..., workers_count=1)`` →
    ``make_torch_dataloader(batch_size, last_batch="drop")`` → DLRM SGD steps
    (``init_dlrm`` from seed 0 unless ``model`` is given; SGD at
    ``LEARNING_RATE``).

    ``interrupt_after``: stop after that many steps and take the loader's
    ``state_dict()`` (the preemption point); with ``checkpoint_dir`` the
    model's ``state_dict`` and that input state are saved there
    (``save_training_state``). ``group``: each rank reads shard ``rank`` of
    ``world``, the loader derives the equal step count, and the gradients
    are averaged over the group. ``collect_field``: a column whose values
    of every trained batch are returned (e.g. ``"sample_index"``).

    Returns a dict: ``losses``, ``steps``, ``input_state`` (None unless
    interrupted), ``steps_per_s_warm`` and ``rows_per_s_warm`` (from a sync
    at step ``WARM_FROM_STEP`` to a sync at the end; None for shorter
    runs), the loader's ``diagnostics`` (``max_batches`` included), the
    reader's (``reader_diagnostics``), ``batch_devices``,
    ``peak_memory_bytes`` (CUDA only), ``checkpoint_save_ms``,
    ``collected`` and the ``model``."""
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.sharding import group_rank_size

    device = resolve_device(device)
    if model is None:
        model = init_dlrm(device=device)
    step = make_dlrm_train_step(model, LEARNING_RATE, group)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rank, world = group_rank_size(group)
    shard = dict(cur_shard=rank, shard_count=world) if group is not None else {}
    # One decode worker delivers the row groups in the seeded shuffle's
    # order, so a run is repeatable; several publish them as they finish,
    # and the loss curve then differs from run to run.
    reader = make_batch_reader(dataset_url, num_epochs=epochs, shuffle_row_groups=True,
                               shard_seed=7, filters=filters, resume_state=resume_state,
                               workers_count=1, **shard)
    loader = make_torch_dataloader(reader, batch_size, last_batch="drop", device=device,
                                   group=group)
    losses, batch_devices, collected = [], set(), []
    state, save_ms, t0, warm_rows = None, None, None, 0
    with loader:
        for batch in loader:
            if len(losses) == WARM_FROM_STEP:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
            batch_devices.update(str(t.device) for t in batch.values())
            dense, sparse, labels = collate_dlrm(batch)
            mask = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
            losses.append(step(dense, sparse, labels, mask))
            if collect_field is not None:
                collected.append(batch[collect_field])
            if t0 is not None:
                warm_rows += labels.shape[0]
            if interrupt_after and len(losses) >= interrupt_after:
                state = loader.state_dict()
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0 if t0 is not None else None
        diagnostics = loader.diagnostics
        reader_diagnostics = reader.diagnostics
    if state is not None and checkpoint_dir is not None:
        from petastorm_tpu_torch.torch_utils.checkpoint import save_training_state

        t_save = time.perf_counter()
        save_training_state(checkpoint_dir, {"model": model.state_dict()},
                            input_state=state, group=group)
        save_ms = 1e3 * (time.perf_counter() - t_save)
    warm_steps = len(losses) - WARM_FROM_STEP
    return {
        "losses": [float(x) for x in losses],
        "steps": len(losses),
        "input_state": state,
        "steps_per_s_warm": warm_steps / elapsed if elapsed else None,
        "rows_per_s_warm": warm_rows / elapsed if elapsed else None,
        "diagnostics": diagnostics,
        "reader_diagnostics": reader_diagnostics,
        "batch_devices": sorted(batch_devices),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "checkpoint_save_ms": save_ms,
        "collected": (torch.cat(collected).cpu().numpy() if collected else None),
        "model": model,
    }
