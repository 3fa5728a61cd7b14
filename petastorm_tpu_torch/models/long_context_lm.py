"""Long-context decoder LM trained from packed Parquet documents, on the card.

Counterpart of ``examples/long_context_lm/train_lm.py`` (the JAX package's
capstone): ragged token documents in Parquet → :func:`make_columnar_reader`
→ :func:`make_packed_torch_dataloader` → a causal decoder whose attention
is the flash kernels over packed ``segment_ids`` → next-token loss that
stops at document boundaries → plain SGD.

On one process the attention calls the flash kernels directly (forward,
dQ, dK/dV); ``attn_impl="dense"`` runs the dense oracle instead, for parity.
With a ``torch.distributed`` process group (``group=``) the attention is
the JAX capstone's sequence-parallel path: ring attention over the group's
ranks, causal, striped, the packed ``segment_ids`` riding the K/V ring, its
local attention the flash kernels (``attn_impl="flash"``) or dense blocks
(``"dense"``). Every rank holds the whole batch and the same weights, and
only attention is split over T, so every rank takes the same step.
Weights keep the JAX layout: ``h @ w`` with ``w`` of shape ``[d_in, d_out]``,
and the output head is tied to ``embed`` (``h @ embed.T``), so
:func:`params_from_jax` copies arrays without transposing.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from petastorm_tpu_torch.ops.flash_attention import flash_attention, resolve_device
from petastorm_tpu_torch.torch_utils.sharding import reader_options
from petastorm_tpu_torch.models.sequence_model import attention_reference, ring_attention

VOCAB = 64
_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "ffn")


def generate_corpus(dataset_url, docs=512, max_len=48, seed=17):
    """Ragged integer-token documents (padded on disk + a length column):
    random walks over the vocabulary, so the next token is learnable. With
    the default seed the rows equal the JAX capstone's corpus."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("LmCorpus", [
        UnischemaField("tokens", np.int32, (max_len,), NdarrayCodec(), False),
        UnischemaField("length", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(seed)

    def rows():
        for _ in range(docs):
            n = int(rng.randint(8, max_len + 1))
            toks = np.zeros((max_len,), np.int32)
            toks[:n] = (np.cumsum(rng.randint(0, 3, n)) + rng.randint(VOCAB)) % VOCAB
            yield {"tokens": toks, "length": np.int32(n)}

    materialize_rows(dataset_url, schema, rows(), rows_per_row_group=128)
    return dataset_url


class DecoderBlock(nn.Module):
    """Attention + tanh FFN, both residual; weights ``[d_in, d_out]``."""

    def __init__(self, d_model):
        super().__init__()
        for name in _BLOCK_WEIGHTS:
            setattr(self, name, nn.Parameter(torch.empty(d_model, d_model)))

    def forward(self, h, segment_ids, num_heads, attn_impl, group=None):
        b, t, d_model = h.shape
        dh = d_model // num_heads

        def split(w):
            return (h @ w).reshape(b, t, num_heads, dh)

        q, k, v = split(self.wq), split(self.wk), split(self.wv)
        if group is not None:
            attn = ring_attention(q, k, v, group, causal=True,
                                  segment_ids=segment_ids, local_attn=attn_impl)
        elif attn_impl == "flash":
            attn = flash_attention(q, k, v, causal=True,
                                   segment_ids=segment_ids, device=h.device)
        elif attn_impl == "dense":
            attn = attention_reference(q, k, v, causal=True,
                                       segment_ids=segment_ids)
        else:
            raise ValueError(f"attn_impl must be 'flash' or 'dense', got "
                             f"{attn_impl!r}")
        h = h + attn.reshape(b, t, d_model) @ self.wo
        return h + torch.tanh(h @ self.ffn)


class LongContextLM(nn.Module):
    """Token + within-document position embeddings, decoder blocks, and an
    output head tied to the token embedding."""

    def __init__(self, d_model=64, num_heads=4, num_layers=2, slot_len=128,
                 vocab=VOCAB):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} does not split over "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.embed = nn.Parameter(torch.empty(vocab, d_model))
        self.pos = nn.Parameter(torch.empty(slot_len, d_model))
        self.blocks = nn.ModuleList(DecoderBlock(d_model)
                                    for _ in range(num_layers))

    def forward(self, tokens, positions, segment_ids, attn_impl="flash",
                group=None):
        """``tokens``/``positions``/``segment_ids`` ``[B, T]`` int →
        logits ``[B, T, vocab]`` f32; with ``group``, ring attention over
        its ranks (T must split over them)."""
        h = self.embed[tokens.long()] + self.pos[positions.long()]
        for blk in self.blocks:
            h = blk(h, segment_ids, self.num_heads, attn_impl, group)
        return (h @ self.embed.T).float()


def init_lm_params(seed=0, d_model=64, num_heads=4, num_layers=2,
                   slot_len=128, vocab=VOCAB, device="cuda"):
    """A :class:`LongContextLM` with the JAX capstone's initial
    distributions (embed ~ N(0, 0.05²), pos ~ N(0, 0.02²), block weights ~
    N(0, 1/d_model)), drawn from ``torch.Generator().manual_seed(seed)``."""
    device = resolve_device(device)
    model = LongContextLM(d_model, num_heads, num_layers, slot_len, vocab)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.embed.copy_(torch.randn(model.embed.shape, generator=gen) * 0.05)
        model.pos.copy_(torch.randn(model.pos.shape, generator=gen) * 0.02)
        for blk in model.blocks:
            for name in _BLOCK_WEIGHTS:
                w = getattr(blk, name)
                w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(d_model))
    return model.to(device)


def params_from_jax(numpy_params, num_heads, device="cuda"):
    """The JAX capstone's parameter pytree (numpy arrays: ``embed``, ``pos``,
    ``blocks[i].{wq, wk, wv, wo, ffn}``) as a :class:`LongContextLM` on
    ``device``. Layouts match, so arrays are copied as they are."""
    device = resolve_device(device)
    embed = np.asarray(numpy_params["embed"], np.float32)
    pos = np.asarray(numpy_params["pos"], np.float32)
    model = LongContextLM(d_model=embed.shape[1], num_heads=num_heads,
                          num_layers=len(numpy_params["blocks"]),
                          slot_len=pos.shape[0], vocab=embed.shape[0])
    with torch.no_grad():
        model.embed.copy_(torch.tensor(embed))
        model.pos.copy_(torch.tensor(pos))
        for blk, src in zip(model.blocks, numpy_params["blocks"]):
            for name in _BLOCK_WEIGHTS:
                getattr(blk, name).copy_(
                    torch.tensor(np.asarray(src[name], np.float32)))
    return model.to(device)


def lm_loss(model, tokens, positions, segment_ids, attn_impl="flash",
            group=None):
    """Mean next-token cross-entropy over positions whose next token
    continues the same document."""
    logits = model(tokens, positions, segment_ids, attn_impl=attn_impl,
                   group=group)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, 2, tokens[:, 1:, None].long())[..., 0]
    cont = ((segment_ids[:, 1:] == segment_ids[:, :-1])
            & (segment_ids[:, 1:] >= 0)).float()
    return (nll * cont).sum() / torch.clamp(cont.sum(), min=1.0)


def make_lm_train_step(model, learning_rate=1.0, attn_impl="flash",
                       group=None):
    """``step(tokens, positions, segment_ids) -> loss``: one SGD step on
    ``model``'s parameters, updated in place (sequence-parallel attention
    over ``group`` when one is given)."""

    def step(tokens, positions, segment_ids):
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens, positions, segment_ids, attn_impl, group)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= learning_rate * p.grad
        return loss.detach()

    return step


def train_lm(dataset_url, slot_len=128, slots=4, steps=12, num_heads=4,
             epochs=8, d_model=64, device="cuda", group=None):
    """The whole loop on ``device`` (``"cuda"`` unless the caller asks for
    ``"cpu"``); the row-group shuffle is seeded, so a run is repeatable.
    With ``group`` the attention is the flash-local ring over its ranks:
    every rank runs this loop on the same batches (its reader takes
    ``sharding.reader_options(group)``). Returns a dict:
    ``losses``, ``steps_per_s``, the loader's ``diagnostics``,
    ``batch_devices`` (where every batch arrived), ``logit_parity`` (max
    |flash − dense| logits on the last batch with the final weights: the
    ring's against the one-process dense oracle's with ``group``),
    ``peak_memory_bytes`` (CUDA only) and the ``model``."""
    from petastorm_tpu_torch.reader.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_POSITION_KEY,
        PACK_SEGMENT_KEY,
        make_packed_torch_dataloader,
    )

    device = resolve_device(device)
    model = init_lm_params(0, d_model=d_model, num_heads=num_heads,
                           slot_len=slot_len, device=device)
    step = make_lm_train_step(model, group=group)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reader = make_columnar_reader(dataset_url, num_epochs=epochs,
                                  shuffle_row_groups=True, shard_seed=0,
                                  **reader_options(group))
    loader = make_packed_torch_dataloader(
        reader, slot_len=slot_len, slots=slots, sequence_fields=["tokens"],
        length_field="length", max_batches=steps, device=device)
    losses, batch_devices, last = [], set(), None
    with loader:
        t0 = time.perf_counter()
        for packed in loader:
            tokens, pos, seg = (packed["tokens"], packed[PACK_POSITION_KEY],
                                packed[PACK_SEGMENT_KEY])
            batch_devices.update(str(t.device) for t in packed.values())
            losses.append(step(tokens, pos, seg))
            last = (tokens, pos, seg)
        losses = [float(x) for x in losses]  # one sync, after the loop
        elapsed = time.perf_counter() - t0
        diagnostics = loader.diagnostics
    if last is None:
        raise RuntimeError("the loader yielded no batches")
    with torch.no_grad():
        flash = model(*last, attn_impl="flash", group=group)
        dense = model(*last, attn_impl="dense")
        parity = float((flash - dense).abs().max())
    return {
        "losses": losses,
        "steps_per_s": len(losses) / elapsed,
        "diagnostics": diagnostics,
        "batch_devices": sorted(batch_devices),
        "logit_parity": parity,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "model": model,
    }
