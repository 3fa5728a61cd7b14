"""Weights drawn on the device from the run's seed, in a few large calls.

The program's modules are filled in place from these draws, and the
reference draws the same values again into tensors of its own, so it
takes no weight the program made. Each group of leaves has a generator
of its own, seeded from the run's seed and the group's name, so a group
can be drawn again without the others.
"""

from __future__ import annotations

import hashlib
import math

import torch


def group_seed(seed, group):
    """A 63-bit seed for one group of leaves of one run."""
    digest = hashlib.blake2b(f"{int(seed)}/{group}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _generator(seed, group, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    return gen


BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "ffn")


def lm_leaf_names(num_layers):
    return (["embed", "pos"]
            + [f"blocks.{i}.{w}" for i in range(num_layers) for w in BLOCK_WEIGHTS])


def fill_lm(leaves, seed, d_model, num_layers):
    """Fill the decoder's leaves (``embed`` [V, d] ~ N(0, 0.05²), ``pos``
    [P, d] ~ N(0, 0.02²), every block weight ~ N(0, 1/d)) in place: one
    draw for each of the three groups, the block weights from one buffer."""
    device = leaves["embed"].device
    with torch.no_grad():
        leaves["embed"].normal_(0.0, 0.05, generator=_generator(seed, "embed", device))
        leaves["pos"].normal_(0.0, 0.02, generator=_generator(seed, "pos", device))
        blocks = torch.empty((num_layers * len(BLOCK_WEIGHTS), d_model, d_model),
                             dtype=leaves["embed"].dtype, device=device)
        blocks.normal_(0.0, 1.0 / math.sqrt(d_model),
                       generator=_generator(seed, "blocks", device))
        for i in range(num_layers):
            for j, w in enumerate(BLOCK_WEIGHTS):
                leaves[f"blocks.{i}.{w}"].copy_(blocks[i * len(BLOCK_WEIGHTS) + j])
    return leaves


def lm_leaves(seed, cfg, device):
    """Fresh f32 leaves of the decoder described by ``cfg``."""
    d, n = cfg["d_model"], cfg["num_layers"]
    shapes = {"embed": (cfg["vocab_size"], d), "pos": (cfg["max_positions"], d)}
    shapes.update({name: (d, d) for name in lm_leaf_names(n)[2:]})
    leaves = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, shape in shapes.items()}
    return fill_lm(leaves, seed, d, n)


MLP_LAYERS = ("bottom1", "bottom2", "top1", "top2")


def dlrm_shapes(cfg):
    """Leaf name → shape of the DLRM described by ``cfg``."""
    features = cfg["num_sparse"] + 1
    interact = features * (features - 1) // 2 + cfg["embed_dim"]
    dims = {"bottom1": (cfg["num_dense"], cfg["bottom_hidden"]),
            "bottom2": (cfg["bottom_hidden"], cfg["embed_dim"]),
            "top1": (interact, cfg["top_hidden"]),
            "top2": (cfg["top_hidden"], 1)}
    shapes = {"embeddings": (cfg["num_sparse"], cfg["table_rows"], cfg["embed_dim"])}
    for name, (d_in, d_out) in dims.items():
        shapes[f"{name}_kernel"] = (d_in, d_out)
        shapes[f"{name}_bias"] = (d_out,)
    return shapes


def fill_dlrm(leaves, seed):
    """Fill the DLRM's leaves in place: the tables ~ N(0, 0.05²) in one
    draw, the kernels ~ N(0, 1/fan_in) from one buffer, biases 0."""
    device = leaves["embeddings"].device
    with torch.no_grad():
        leaves["embeddings"].normal_(0.0, 0.05, generator=_generator(seed, "tables", device))
        kernels = [leaves[f"{name}_kernel"] for name in MLP_LAYERS]
        flat = torch.empty(sum(k.numel() for k in kernels), dtype=torch.float32,
                           device=device)
        flat.normal_(0.0, 1.0, generator=_generator(seed, "mlp", device))
        offset = 0
        for kernel in kernels:
            part = flat[offset:offset + kernel.numel()].view(kernel.shape)
            kernel.copy_(part / math.sqrt(kernel.shape[0]))
            offset += kernel.numel()
        for name in MLP_LAYERS:
            leaves[f"{name}_bias"].zero_()
    return leaves


def dlrm_leaves(seed, cfg, device):
    """Fresh f32 leaves of the DLRM described by ``cfg``."""
    leaves = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, shape in dlrm_shapes(cfg).items()}
    return fill_dlrm(leaves, seed)


def diff_norm(a, b, chunk_elems=1 << 27):
    """``||a - b||`` in float64 from f32 chunks, so a table of many GB
    needs one chunk's room more. A device scalar (no synchronisation)."""
    a, b = a.reshape(-1), b.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for start in range(0, a.numel(), chunk_elems):
        d = a[start:start + chunk_elems] - b[start:start + chunk_elems]
        total += torch.sum(d.double() ** 2)
    return torch.sqrt(total)
