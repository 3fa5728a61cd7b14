"""The sequence-model family's trainers, on the card (counterpart of
``examples/sequence/train_sequence.py``).

- :func:`train_sequence`: timestamped frames → ``NGram`` windows through
  :func:`make_reader` → :func:`make_torch_dataloader` collates
  ``[B, T, ...]`` → the sequence encoder (``models/sequence_model.py``);
- :func:`train_ragged_causal`: ragged sequences stored padded with a
  ``length`` column → causal training that ignores the padded tail;
- :func:`train_packed_causal`: the same documents packed end to end →
  next-step prediction with causal attention over ``segment_ids``.

At these widths (d_model 32, 4 heads) the head dim is 8, which the flash
kernels take zero-padded to 16. Each trainer takes ``group=`` (a
``torch.distributed`` process group) for its sequence-parallel version:
every rank reads the same batches (``sharding.reader_options``) and takes
the same steps, and attention runs as ring (or Ulysses) attention over the
group. Entry points
run on the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from petastorm_tpu_torch.models.sequence_model import (
    attention_reference,
    init_seq_params,
    make_seq_train_step,
    ring_attention,
)
from petastorm_tpu_torch.ops.flash_attention import flash_attention, resolve_device
from petastorm_tpu_torch.torch_utils.sharding import reader_options

WINDOW = 5


def generate_frames_dataset(dataset_url, frames=1024, frame_shape=(8, 8, 1)):
    """Write the timestamped-frame dataset (a video / lidar stand-in):
    ``ts``, an ``NdarrayCodec`` frame and ``ego_speed`` per row, 256 rows per
    row group. With the default seed the rows equal the JAX package's
    ``benchmark/scenarios.py::make_ngram_dataset``'s at the same shape."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("FrameSchema", [
        UnischemaField("ts", np.int64, (), ScalarCodec(), False),
        UnischemaField("frame", np.float32, frame_shape, NdarrayCodec(), False),
        UnischemaField("ego_speed", np.float32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(11)

    def rows():
        for t in range(frames):
            yield {"ts": np.int64(t),
                   "frame": rng.rand(*frame_shape).astype(np.float32),
                   "ego_speed": np.float32(rng.rand())}

    materialize_rows(dataset_url, schema, rows(), rows_per_row_group=256)
    return schema


def frame_windows(batch):
    """A collated NGram batch → ``(windows [B, T, F], labels [B])``: each
    timestep's flattened frame and its speed; the label is the window's
    mean-speed quartile."""
    frames, speed = batch["frame"], batch["ego_speed"]
    b, t = frames.shape[:2]
    windows = torch.cat([frames.reshape(b, t, -1), speed[..., None]], dim=-1)
    labels = torch.clamp((speed.mean(dim=1) * 4).int(), 0, 3)
    return windows, labels


def train_sequence(dataset_url, batch_size=16, steps=8, attn_impl="dense",
                   group=None, local_attn="auto", compute_dtype=torch.bfloat16,
                   device="cuda"):
    """Train the encoder (d_model 32, 4 heads, 4 classes) on ``WINDOW``-frame
    NGram windows; returns ``{"losses": [...]}``. With ``group`` the window
    length must split over its ranks."""
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    device = resolve_device(device)
    ngram = NGram({i: ["ts", "frame", "ego_speed"] for i in range(WINDOW)},
                  delta_threshold=1, timestamp_field="ts")
    reader = make_reader(dataset_url, schema_fields=ngram, num_epochs=None,
                         shuffle_row_groups=True, shard_seed=0,
                         **reader_options(group))
    model = init_seq_params(0, feature_dim=8 * 8 * 1 + 1, d_model=32,
                            num_heads=4, num_classes=4, device=device)
    step = make_seq_train_step(model, 0.05, group=group, attn_impl=attn_impl,
                               local_attn=local_attn, compute_dtype=compute_dtype)
    losses = []
    with make_torch_dataloader(reader, batch_size, max_batches=steps,
                               device=device) as loader:
        for batch in loader:
            windows, labels = frame_windows(batch)
            mask = torch.ones(windows.shape[0], dtype=torch.bool, device=device)
            losses.append(step(windows, labels, mask))
    return {"losses": [float(x) for x in losses]}


def generate_ragged_dataset(dataset_url, rows=256, max_len=24):
    """Variable-length sequences stored padded, with a ``length`` column
    (Parquet shapes are static; the true length rides along as data). With
    the default seed the rows equal the JAX example's."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("RaggedSeq", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("seq", np.float32, (max_len, 6), NdarrayCodec(), False),
        UnischemaField("length", np.int32, (), ScalarCodec(), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(7)

    def rows_gen():
        for i in range(rows):
            n = int(rng.randint(4, max_len + 1))
            seq = np.zeros((max_len, 6), np.float32)
            seq[:n] = rng.randn(n, 6)
            yield {"id": i, "seq": seq, "length": np.int32(n),
                   "label": np.int32(i % 3)}

    materialize_rows(dataset_url, schema, rows_gen(), rows_per_row_group=64)
    return dataset_url


def train_ragged_causal(dataset_url, batch_size=16, steps=8, group=None,
                        attn_impl=None, local_attn="auto",
                        compute_dtype=torch.bfloat16, device="cuda"):
    """Causal training on ragged sequences (d_model 32, 4 heads, 3 classes):
    the ``length`` column flows into the model, so padded positions neither
    attend nor pool. ``attn_impl`` defaults to the flash kernels on one
    process and to ring attention over ``group``. Returns ``{"losses":
    [...]}``."""
    from petastorm_tpu_torch.reader.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    device = resolve_device(device)
    if attn_impl is None:
        attn_impl = "ring" if group is not None else "flash"
    reader = make_columnar_reader(dataset_url, num_epochs=None,
                                  shuffle_row_groups=True, shard_seed=0,
                                  schema_fields=["seq", "length", "label"],
                                  **reader_options(group))
    model = init_seq_params(1, feature_dim=6, d_model=32, num_heads=4,
                            num_classes=3, device=device)
    step = make_seq_train_step(model, 0.05, group=group, attn_impl=attn_impl,
                               causal=True, local_attn=local_attn,
                               compute_dtype=compute_dtype)
    losses = []
    with make_torch_dataloader(reader, batch_size, max_batches=steps,
                               device=device) as loader:
        for batch in loader:
            windows, labels, lengths = batch["seq"], batch["label"], batch["length"]
            mask = torch.ones(windows.shape[0], dtype=torch.bool, device=device)
            losses.append(step(windows, labels, mask, lengths))
    return {"losses": [float(x) for x in losses]}


class PackedNextStep(nn.Module):
    """The packed trainer's model: features + within-document position
    embedding → causal attention within segments → next-step features
    (the JAX example's parameter names and ``[d_in, d_out]`` layouts)."""

    def __init__(self, feature_dim=6, d_model=32, num_heads=4, slot_len=48):
        super().__init__()
        self.num_heads = num_heads
        shapes = {"emb": (feature_dim, d_model), "pos": (slot_len, d_model),
                  "wq": (d_model, d_model), "wk": (d_model, d_model),
                  "wv": (d_model, d_model), "out": (d_model, feature_dim)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))

    def forward(self, x, seg, pos, attn_impl="flash", group=None,
                local_attn="auto"):
        h = x @ self.emb + self.pos[pos.long()]
        b, t, d_model = h.shape
        dh = d_model // self.num_heads
        q, k, v = ((h @ w).reshape(b, t, self.num_heads, dh)
                   for w in (self.wq, self.wk, self.wv))
        if group is not None:
            attn = ring_attention(q, k, v, group, causal=True, segment_ids=seg,
                                  local_attn=local_attn)
        elif attn_impl == "flash":
            attn = flash_attention(q, k, v, causal=True, segment_ids=seg,
                                   device=h.device)
        else:
            attn = attention_reference(q, k, v, causal=True, segment_ids=seg)
        return attn.reshape(b, t, d_model) @ self.out


def packed_next_step_loss(model, x, seg, pos, **kwargs):
    """Mean squared error of the next step's features, only where the next
    position continues the same document."""
    y = model(x, seg, pos, **kwargs)
    cont = ((seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] >= 0)).float()
    err = ((y[:, :-1] - x[:, 1:]) ** 2).mean(dim=-1)
    return (err * cont).sum() / torch.clamp(cont.sum(), min=1.0)


def init_packed_next_step(seed=2, feature_dim=6, d_model=32, num_heads=4,
                          slot_len=48, device="cuda"):
    """A :class:`PackedNextStep` with the JAX example's initial
    distributions (weights ~ N(0, 1/fan_in), pos ~ N(0, 0.02^2))."""
    device = resolve_device(device)
    model = PackedNextStep(feature_dim, d_model, num_heads, slot_len)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, w in model.named_parameters():
            std = 0.02 if name == "pos" else 1.0 / math.sqrt(w.shape[0])
            w.copy_(torch.randn(w.shape, generator=gen) * std)
    return model.to(device)


def train_packed_causal(dataset_url, slot_len=48, slots=4, steps=6,
                        attn_impl="flash", group=None, local_attn="auto",
                        device="cuda"):
    """Next-step prediction over packed documents: ragged rows →
    :func:`make_packed_torch_dataloader` → causal attention within
    ``segment_ids`` (ring attention over ``group`` when one is given).

    Returns ``{"losses", "packed_utilization", "padded_utilization"}``:
    utilization is the share of attention slots that hold real tokens,
    packed and with one padded row per document."""
    from petastorm_tpu_torch.reader.reader import make_columnar_reader
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_POSITION_KEY,
        PACK_SEGMENT_KEY,
        make_packed_torch_dataloader,
    )

    device = resolve_device(device)
    model = init_packed_next_step(slot_len=slot_len, device=device)
    reader = make_columnar_reader(dataset_url, num_epochs=None,
                                  shuffle_row_groups=True, shard_seed=0,
                                  schema_fields=["seq", "length"],
                                  **reader_options(group))
    loader = make_packed_torch_dataloader(
        reader, slot_len=slot_len, slots=slots, sequence_fields=["seq"],
        length_field="length", max_batches=steps, device=device)
    losses, valid, total, doc_lens = [], 0, 0, []
    with loader:
        for packed in loader:
            seg, pos, x = packed[PACK_SEGMENT_KEY], packed[PACK_POSITION_KEY], packed["seq"]
            model.zero_grad(set_to_none=True)
            loss = packed_next_step_loss(model, x, seg, pos, attn_impl=attn_impl,
                                         group=group, local_attn=local_attn)
            loss.backward()
            with torch.no_grad():
                for p in model.parameters():
                    p -= 0.05 * p.grad
            losses.append(loss.detach())
            seg_np = seg.cpu().numpy()
            valid += int((seg_np >= 0).sum())
            total += seg_np.size
            doc_lens.extend(int((row == sid).sum()) for row in seg_np
                            for sid in range(int(row.max()) + 1))
    max_len = max(doc_lens, default=1)
    return {"losses": [float(x) for x in losses],
            "packed_utilization": valid / max(total, 1),
            "padded_utilization": (sum(doc_lens) / (len(doc_lens) * max_len)
                                   if doc_lens else 0.0)}
