"""``DeviceStage``: uint8 image bytes in, model-dtype pixels out, on the card.

Counterpart of ``petastorm_tpu/jax_utils/device_stage.py::DeviceStage``.
The loader stages a batch's raw uint8 image fields as bytes (a quarter of
the H2D bytes of float32 pixels) and the stage runs crop → flip → cast →
normalize on the card, as plain tensor ops on the loader's copy stream:

- crop and flip are one gather (``x[b, rows, cols]``) whose row and column
  indices come from the batch's draws — exact selections;
- the cast is ``Tensor.to``; normalize is ``(x - mean) * inv_std``, two
  IEEE-rounded elementwise ops with ``inv_std`` computed once on the host,
  so the card and the CPU give the same bits.

Randomness is a pure function of (seed, step ordinal, field ordinal): the
draws are made on the host by numpy's counter-based Philox generator keyed
by a blake2b fold of those three (the seed-tree ``fold_in`` of
:mod:`petastorm_tpu_torch.service.seedtree`), as small offset and flip arrays.
So the card and the CPU draw the same whatever the prefetch depth, and
:meth:`DeviceStage.draws` shows them to tests. (The bitstream differs from
the JAX package's threefry draws; the determinism contract is the same.)
"""

from __future__ import annotations

import numpy as np
import torch

from petastorm_tpu_torch.service.seedtree import fold_in

__all__ = ["DeviceStage"]


def _channel_tensor(value, dtype):
    """A normalize mean/std as a scalar or per-channel ``[C]`` CPU tensor."""
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim > 1:
        raise ValueError("normalize mean/std must be scalars or 1-D "
                         f"per-channel sequences, got shape {arr.shape}")
    return torch.tensor(arr.tolist(), dtype=dtype)


class DeviceStage:
    """Crop, flip, cast and normalize of raw uint8 image batches on the
    batch's device.

    :param image_fields: field names to treat as raw image batches. ``None``
        infers them: uint8 arrays of rank >= 3 after collation.
    :param output_dtype: the torch dtype of the output (``torch.float32``;
        ``torch.bfloat16`` halves the decoded bytes).
    :param normalize: ``None`` or ``(mean, std)``, scalars or per-channel
        sequences, applied as ``(x - mean) * (1 / std)`` with the reciprocal
        computed once on the host.
    :param crop: ``None`` or ``(height, width)``: a random crop per image.
    :param flip: a random horizontal flip per image (p = 0.5).
    :param seed: the root of the draws.
    """

    def __init__(self, image_fields=None, output_dtype=torch.float32,
                 normalize=None, crop=None, flip=False, seed=0):
        self._image_fields = None if image_fields is None else tuple(image_fields)
        self._dtype = output_dtype
        if normalize is not None:
            mean, std = normalize
            self._mean = _channel_tensor(mean, output_dtype)
            std_t = _channel_tensor(std, output_dtype)
            if bool((std_t == 0).any()):
                raise ValueError("normalize std must be non-zero")
            self._inv_std = torch.tensor(1.0, dtype=output_dtype) / std_t
        else:
            self._mean = self._inv_std = None
        if crop is not None:
            crop = (int(crop[0]), int(crop[1]))
            if crop[0] < 1 or crop[1] < 1:
                raise ValueError(f"crop must be positive, got {crop}")
        self._crop = crop
        self._flip = bool(flip)
        self._seed = int(seed)
        self._constants = {}  # device -> (mean, inv_std) on that device
        #: Raw bytes the loader staged to the card through this stage.
        self.h2d_bytes = 0

    # -- field routing -----------------------------------------------------

    def is_image_field(self, name, arr):
        if self._image_fields is not None:
            return name in self._image_fields
        return arr.dtype == np.uint8 and arr.ndim >= 3

    def split(self, batch):
        """Partition a collated host batch into (raw image fields, rest)."""
        raw, rest, object_fields = {}, {}, []
        for name, col in batch.items():
            arr = np.asarray(col)
            if arr.dtype == object:
                object_fields.append(name)
                rest[name] = col
            elif self.is_image_field(name, arr):
                raw[name] = arr
            else:
                rest[name] = col
        if self._image_fields is not None:
            wrong_dtype = [f for f in self._image_fields if f in object_fields]
            if wrong_dtype:
                raise TypeError(
                    f"device stage image_fields {wrong_dtype} collated to "
                    "object dtype (ragged or undecoded rows?); the stage needs "
                    "dense same-shape arrays: decode or shape them in the "
                    "reader (codec or TransformSpec) first")
            missing = [f for f in self._image_fields if f not in raw]
            if missing:
                raise KeyError(f"device stage image_fields {missing} absent from "
                               f"the batch (fields: {sorted(batch)})")
        return raw, rest

    # -- the stage ---------------------------------------------------------

    def draws(self, step, index, shape):
        """The draws of field ordinal ``index`` at step ordinal ``step`` for
        a batch of ``shape`` (``[B, H, W, ...]``): ``{"offsets": [B, 2]
        int64 (row, column) crop offsets or None, "flips": [B] bool or
        None}``."""
        key = fold_in(fold_in(self._seed, ("step", int(step))), ("field", int(index)))
        rng = np.random.Generator(np.random.Philox(key=key))
        b, h, w = shape[0], shape[1], shape[2]
        offsets = flips = None
        if self._crop is not None:
            ch, cw = self._crop
            offsets = rng.integers(0, [h - ch + 1, w - cw + 1], size=(b, 2))
        if self._flip:
            flips = rng.random(b) < 0.5
        return {"offsets": offsets, "flips": flips}

    def _select(self, x, step, index):
        """Crop and flip as one gather from the draws."""
        if self._crop is not None:
            if x.dim() != 4:
                raise ValueError(f"crop expects [B, H, W, C] batches, got rank {x.dim()}")
            if self._crop[0] > x.shape[1] or self._crop[1] > x.shape[2]:
                raise ValueError(f"crop {self._crop} larger than image "
                                 f"({x.shape[1]}, {x.shape[2]})")
        elif x.dim() < 3:
            raise ValueError(f"flip expects [B, H, W, ...] batches, got rank {x.dim()}")
        b, h, w = x.shape[:3]
        ch, cw = self._crop or (h, w)
        d = self.draws(step, index, x.shape)
        offsets = d["offsets"] if d["offsets"] is not None else np.zeros((b, 2), np.int64)
        cols = np.arange(cw)
        cols = (np.where(d["flips"][:, None], cols[::-1], cols) if self._flip
                else np.broadcast_to(cols, (b, cw)))
        # One small host tensor per step: [B, ch] rows then [B, cw] columns,
        # pinned for a card so its copy queues without blocking the host.
        idx = torch.from_numpy(np.concatenate(
            [offsets[:, :1] + np.arange(ch), offsets[:, 1:] + cols], axis=1))
        if x.is_cuda:
            idx = idx.pin_memory()
        idx = idx.to(x.device, non_blocking=True)
        rows, cols = idx[:, :ch], idx[:, ch:]
        batch = torch.arange(b, device=x.device)
        return x[batch[:, None, None], rows[:, :, None], cols[:, None, :]]

    def _augment(self, x, step, index):
        if self._crop is not None or self._flip:
            x = self._select(x, step, index)
        x = x.to(self._dtype)
        if self._mean is not None:
            mean, inv_std = self._constants.get(x.device, (None, None))
            if mean is None:
                mean, inv_std = self._mean.to(x.device), self._inv_std.to(x.device)
                self._constants[x.device] = (mean, inv_std)
            x = (x - mean) * inv_std
        return x

    def apply(self, raw, step):
        """Run the stage over raw ``{field: uint8 tensor}`` batches that lie
        on their device; ``step`` is the batch's production ordinal, which
        seeds its draws. Returns ``{field: output_dtype tensor}``."""
        return {name: self._augment(raw[name], step, i)
                for i, name in enumerate(sorted(raw))}

    def describe(self):
        """The stage's configuration as plain data."""
        return {
            "image_fields": (list(self._image_fields)
                             if self._image_fields is not None else None),
            "output_dtype": str(self._dtype).replace("torch.", ""),
            "normalize": self._mean is not None,
            "crop": self._crop,
            "flip": self._flip,
            "seed": self._seed,
        }
