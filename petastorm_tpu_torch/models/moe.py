"""Expert-parallel mixture of experts over a ``torch.distributed`` mesh.

Counterpart of ``petastorm_tpu/models/moe.py``, function for function under
its names (GShard / Switch routing: top-k with a fixed per-(expert, token
shard) capacity, one-hot dispatch and combine contractions, the Switch
load-balancing auxiliary loss). The E experts' FFN weights are stacked
``[E, ...]`` and split over the mesh's ``"ep"`` axis; tokens split over
``"ep"`` (and over ``batch_axis`` for dp × ep), so each rank is both a token
shard and the host of ``E / ep`` experts. Two all-to-alls over ``"ep"``
(``sharding.all_to_all``, whose backward is the same exchange with the axes
swapped) move the ``[E, C, d]`` token slots to their experts' ranks and
back.

:func:`moe_ffn` keeps the JAX package's global view, as its ``shard_map``
does: it takes the whole ``[N, d]`` tokens (the same on every rank) and
returns the whole output and the auxiliary loss on every rank. What
``shard_map`` derives for the backward is written out: the rank's token
shard is taken by a slice whose backward all-gathers, the output leaves by
an all-gather whose backward takes the rank's slice, the replicated router
enters through ``copy_to_group`` (its cotangent summed over the token
shards) and the expert slices likewise over ``batch_axis`` (each data
group's ranks hold the same experts). So a loss computed on every rank from
the outputs gives, on every rank, the JAX gradients: the whole of each
replicated parameter's, the rank's block of each split one's.

Parameters are a dict of tensors, as the JAX pytree (``params_from_jax``
carries one across); :func:`shard_params` with
:func:`moe_param_partition_specs` keeps a rank's block, and :func:`moe_ffn`
takes such a rank's dict. ``mesh=None`` is one process (``ep = 1``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.models.image_classifier import masked_cross_entropy, sgd_step
from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.torch_utils.mesh import Mesh
from petastorm_tpu_torch.torch_utils.sharding import (
    all_to_all,
    copy_to_group,
    enter_sequence_parallel,
    leave_sequence_parallel,
    pmean,
)

_PARAMS = ("embed", "router", "w1", "w2", "head")


def init_moe_params(seed, feature_dim, d_model=32, d_hidden=64, num_experts=8,
                    num_classes=10, dtype=torch.float32, device="cuda"):
    """The JAX ``init_moe_params``' pytree and distributions (each weight
    ~ N(0, 1/fan_in)), drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``; keep ``num_experts`` a multiple
    of the mesh's ep size."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shapes = {"embed": ((feature_dim, d_model), feature_dim),
              "router": ((d_model, num_experts), d_model),
              "w1": ((num_experts, d_model, d_hidden), d_model),
              "w2": ((num_experts, d_hidden, d_model), d_hidden),
              "head": ((d_model, num_classes), d_model)}
    return {name: (torch.randn(shape, generator=gen) / math.sqrt(fan)).to(device, dtype)
            for name, (shape, fan) in shapes.items()}


def params_from_jax(numpy_params, device="cuda"):
    """The JAX MoE's parameter pytree (numpy arrays) as tensors on
    ``device``, every array copied as it is."""
    device = resolve_device(device)
    return {name: torch.tensor(np.asarray(numpy_params[name])).to(device) for name in _PARAMS}


def moe_param_partition_specs():
    """Partition specs over a mesh with an ``"ep"`` axis (see
    ``torch_utils/mesh.py``): the expert stacks split on their leading
    (expert) axis; embed, router and head replicated."""
    return {"embed": (), "router": (), "w1": ("ep", None, None), "w2": ("ep", None, None),
            "head": ()}


def _route_topk(gates, capacity, top_k=1):
    """Top-k routing with a fixed per-expert capacity: ``gates`` ``[n, E]``
    (the router softmax) → ``(dispatch [n, E, C], combine [n, E, C],
    aux)``, as the JAX ``_route_topk``.

    Ties go to the lower expert index, as ``lax.top_k``'s do (a stable
    descending sort; ``torch.topk`` promises no order on ties). All first
    choices enqueue before any second choice; a full queue drops that
    assignment. Top-1 weights by the raw gate (Switch), top-k > 1 by the
    chosen gates renormalized (GShard). The bookkeeping is int32 / float32
    whatever the gate dtype, and the aux loss is over first choices in
    float32."""
    n, num_experts = gates.shape
    top_idx = torch.sort(gates, dim=1, descending=True, stable=True).indices[:, :top_k]
    onehots = F.one_hot(top_idx, num_experts).to(torch.int32)            # [n, k, E]
    gate_chosen = torch.gather(gates, 1, top_idx)                         # [n, k]
    if top_k > 1:
        gate_weight = gate_chosen / torch.clamp(gate_chosen.sum(dim=1, keepdim=True), min=1e-9)
    else:
        gate_weight = gate_chosen
    dispatch = gates.new_zeros((n, num_experts, capacity))
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=gates.device)
    for j in range(top_k):
        oh = onehots[:, j]                                                # [n, E]
        # Queue position within the chosen expert, after all earlier rounds' claims.
        pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) - 1) * oh + counts[None, :] * oh
        keep = (pos < capacity) & (oh > 0)
        slot = F.one_hot(torch.clamp(pos, max=capacity - 1).long(), capacity).to(gates.dtype)
        d_j = slot * keep.to(gates.dtype)[..., None]
        dispatch = dispatch + d_j
        combine = combine + d_j * gate_weight[:, j][:, None, None]
        counts = counts + oh.sum(dim=0, dtype=torch.int32)
    fraction = onehots[:, 0].float().mean(dim=0)
    importance = gates.float().mean(dim=0)
    aux = num_experts * torch.sum(fraction * importance)
    return dispatch, combine, aux


def _moe_body(w1, w2, router, x, mesh, axis_name, capacity, batch_axis=None, top_k=1):
    """One rank's MoE layer: ``w1`` / ``w2`` its experts ``[E_local, d, h]``
    / ``[E_local, h, d]``, ``x`` its tokens ``[n_local, d]`` → their output
    (zero rows for dropped tokens) and the aux loss averaged over the token
    shards."""
    group = mesh.group(axis_name)
    gates = torch.softmax(x @ router, dim=-1)
    dispatch, combine, aux = _route_topk(gates, capacity, top_k=top_k)
    # [E, C, d] -> [E_local, ep*C, d]: each rank receives its experts' slots
    # from every token shard of its ep group; the reverse exchange after.
    (expert_in,) = all_to_all([torch.einsum("nec,nd->ecd", dispatch, x)], 0, 1, group)
    h = torch.relu(torch.einsum("egd,edh->egh", expert_in, w1))
    (out,) = all_to_all([torch.einsum("egh,ehd->egd", h, w2)], 1, 0, group)
    y = torch.einsum("ecd,nec->nd", out, combine)
    aux = pmean(aux, group)
    if batch_axis is not None:
        aux = pmean(aux, mesh.group(batch_axis))
    return y, aux


def _capacity(tokens_per_shard, num_experts, capacity_factor, top_k=1):
    """Static per-(expert, token shard) queue length: GShard's C = k·n·f/E."""
    return max(1, int(tokens_per_shard * top_k * capacity_factor / num_experts))


def moe_ffn(params, x, mesh, axis_name="ep", capacity_factor=2.0, batch_axis=None, top_k=1):
    """Routed expert FFN over the tokens ``x`` ``[N, d_model]`` (the whole
    of them, the same on every rank) → ``(y [N, d_model], aux)`` on every
    rank. ``params``: the rank's block (``w1`` / ``w2`` holding its
    ``E / ep`` experts). ``N`` must divide by the token shards (ep × the
    optional ``batch_axis``, whose ranks then hold the same experts)."""
    mesh = mesh if mesh is not None else Mesh((1,), (axis_name,))
    ep = mesh.shape[axis_name]
    num_experts = params["router"].shape[1]
    if num_experts % ep:
        raise ValueError(f"{num_experts} experts do not split over the mesh's "
                         f"{axis_name!r} axis of {ep} devices")
    if params["w1"].shape[0] != num_experts // ep:
        raise ValueError(f"w1 holds {params['w1'].shape[0]} experts, not this rank's "
                         f"{num_experts // ep} of {num_experts}: pass the rank's block, "
                         "shard_params(params, moe_param_partition_specs(), mesh)")
    token_axes = ((batch_axis,) if batch_axis else ()) + (axis_name,)
    shards = mesh.size(token_axes)
    if x.shape[0] % shards:
        raise ValueError(f"{x.shape[0]} tokens do not shard over {shards} "
                         f"devices ({token_axes})")
    capacity = _capacity(x.shape[0] // shards, num_experts, capacity_factor, top_k=top_k)
    tokens = mesh.group(token_axes)
    replicas = mesh.group(batch_axis) if batch_axis else None
    # The rank's token shard, by a slice whose backward all-gathers.
    (x_local,) = enter_sequence_parallel([x], tokens, dim=0)
    y, aux = _moe_body(copy_to_group(params["w1"], replicas),
                       copy_to_group(params["w2"], replicas),
                       copy_to_group(params["router"], tokens), x_local, mesh, axis_name,
                       capacity, batch_axis=batch_axis, top_k=top_k)
    return leave_sequence_parallel(y, tokens, dim=0), aux


def apply_moe_model(params, features, mesh, axis_name="ep", capacity_factor=2.0,
                    batch_axis=None, top_k=1):
    """``features`` ``[B, F]`` → ``(logits [B, C] float32, aux)`` through
    embed → residual MoE FFN → head (dropped tokens pass through the
    residual unchanged)."""
    x = features @ params["embed"]
    y, aux = moe_ffn(params, x, mesh, axis_name=axis_name, capacity_factor=capacity_factor,
                     batch_axis=batch_axis, top_k=top_k)
    return ((x + y) @ params["head"]).float(), aux


def reference_forward(params, features, num_shards=1, capacity_factor=2.0, top_k=1):
    """The dense one-process oracle with the same routing math, capacity
    drops per token shard included when ``num_shards`` is the sharded
    run's token-shard count; ``params`` whole."""
    x = features @ params["embed"]
    n = x.shape[0]
    per = n // num_shards
    capacity = _capacity(per, params["w1"].shape[0], capacity_factor, top_k=top_k)
    outs, auxes = [], []
    for shard in range(num_shards):
        xs = x[shard * per:(shard + 1) * per]
        gates = torch.softmax(xs @ params["router"], dim=-1)
        dispatch, combine, aux = _route_topk(gates, capacity, top_k=top_k)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, xs)
        h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, params["w1"]))
        out = torch.einsum("ech,ehd->ecd", h, params["w2"])
        outs.append(torch.einsum("ecd,nec->nd", out, combine))
        auxes.append(aux)
    logits = ((x + torch.cat(outs, dim=0)) @ params["head"]).float()
    return logits, torch.stack(auxes).mean()


def make_moe_train_step(learning_rate=0.05, aux_weight=0.01, mesh=None, axis_name="ep",
                        capacity_factor=2.0, batch_axis=None, top_k=1):
    """``step(params, features, labels, mask) -> (params, loss)``: masked
    cross-entropy plus ``aux_weight`` times the Switch aux loss, SGD
    through both all-to-alls. Every rank passes the whole batch and its
    block of the params, and gets its block back."""

    def loss_fn(params, features, labels, mask):
        logits, aux = apply_moe_model(params, features, mesh, axis_name=axis_name,
                                      capacity_factor=capacity_factor,
                                      batch_axis=batch_axis, top_k=top_k)
        return masked_cross_entropy(logits, labels, mask) + aux_weight * aux

    def step(params, features, labels, mask):
        return sgd_step(loss_fn, params, learning_rate, features, labels, mask)

    return step
