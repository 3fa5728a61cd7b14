"""The packed long-context LM cell: ``make_columnar_reader`` →
``make_packed_torch_dataloader`` → ``LongContextLM`` trained by
``make_lm_train_step``, the attention on the flash kernels."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare, weights, work
from perfbench.reference import lm as reference_lm
from perfbench.reference import packing as reference_packing

UNIT = "tokens"
#: Host ops whose device time the flash roofline metrics read.
HOST_OPS = ("FlashAttentionFn", "FlashAttentionFnBackward")


class Cell:
    def __init__(self, cfg, mix, seed, device, workdir, generator):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.workdir, self.generator = workdir, generator
        self.delivered = []     # every batch the loader gave, on the device
        self.window_first = None
        self.program = None     # the program's readings of the checked steps

    # -- the program -------------------------------------------------------

    def setup(self):
        from petastorm_tpu_torch.models.long_context_lm import LongContextLM, make_lm_train_step
        from petastorm_tpu_torch.reader.reader import make_columnar_reader
        from petastorm_tpu_torch.torch_utils.packing import (
            PACK_POSITION_KEY,
            PACK_SEGMENT_KEY,
            make_packed_torch_dataloader,
        )

        cfg, mix = self.cfg, self.mix
        self.store = self.generator.make_store(mix, cfg, self.seed, self.workdir)
        with self.device:
            self.model = LongContextLM(cfg["d_model"], cfg["num_heads"], cfg["num_layers"],
                                       slot_len=cfg["max_positions"], vocab=cfg["vocab_size"])
        self.leaves = dict(self.model.named_parameters())
        weights.fill_lm(self.leaves, self.seed, cfg["d_model"], cfg["num_layers"])
        self.train_step = make_lm_train_step(self.model, learning_rate=cfg["learning_rate"])
        reader = make_columnar_reader(self.store.url, num_epochs=None, shuffle_row_groups=True,
                                      shard_seed=mix["shuffle_seed"],
                                      workers_count=mix["reader_workers"])
        self.loader = make_packed_torch_dataloader(
            reader, slot_len=mix["slot_len"], slots=mix["slots"], sequence_fields=["tokens"],
            length_field="length", device=self.device)
        self.loader.__enter__()
        self.keys = ("tokens", PACK_POSITION_KEY, PACK_SEGMENT_KEY)

    def step(self, batch):
        tokens, pos, seg = (batch[key] for key in self.keys)
        self.delivered.append((tokens, pos, seg))
        loss = self.train_step(tokens, pos, seg)
        return loss, (seg >= 0).sum()

    def checked_steps(self, batches):
        """The first steps, read for the comparison with the reference."""
        cfg = self.cfg
        losses = (self.step(batch)[0] for batch in batches)
        self.program = compare.read_steps(
            self.leaves, losses, lambda: weights.lm_leaves(self.seed, cfg, self.device),
            cfg["learning_rate"], cfg["checked_steps"])

    def mark_window(self):
        self.window_first = len(self.delivered)

    def close(self):
        self.loader.__exit__(None, None, None)

    def free(self):
        del self.model, self.leaves, self.train_step, self.loader

    # -- what the window did -------------------------------------------------

    def host_batches(self):
        if not hasattr(self, "_host"):
            self._host = [tuple(t.cpu().numpy() for t in b) for b in self.delivered]
            self.delivered = []
        return self._host

    def work(self):
        """Counted work of the window's steps."""
        cfg = self.cfg
        batches = self.host_batches()[self.window_first:]
        tokens = sum(work.real_tokens(seg) for _, _, seg in batches)
        pairs = sum(work.visible_pairs(seg) for _, _, seg in batches)
        fwd_flops, bwd_flops = work.attention_flops(pairs, cfg["num_heads"],
                                                    cfg["d_model"] // cfg["num_heads"])
        fwd_bytes, bwd_bytes = work.flash_bytes(self.mix["slots"], self.mix["slot_len"],
                                                cfg["num_heads"],
                                                cfg["d_model"] // cfg["num_heads"])
        calls = cfg["num_layers"] * len(batches)
        return {
            "steps": len(batches), "tokens": tokens,
            "positions": len(batches) * self.mix["slots"] * self.mix["slot_len"],
            "model_flops": work.lm_model_flops(tokens, pairs, cfg["d_model"],
                                               cfg["num_layers"], cfg["num_heads"],
                                               cfg["vocab_size"]),
            "flash_fwd_flops": cfg["num_layers"] * fwd_flops,
            "flash_bwd_flops": cfg["num_layers"] * bwd_flops,
            "flash_fwd_bytes": calls * fwd_bytes, "flash_bwd_bytes": calls * bwd_bytes,
        }

    # -- correctness -----------------------------------------------------------

    def data_check(self):
        """``(mismatches, reference batches)``: the delivered batches
        against the store (worked out once)."""
        if not hasattr(self, "_data"):
            self._data = reference_packing.check_stream(
                self.store.docs, self.store.docs_per_row_group, self.host_batches(),
                self.mix["slots"], self.mix["slot_len"])
        return self._data

    def reference(self, precision="f32", fault=None):
        """The reference's readings of the checked steps, in ``precision``;
        ``fault="half_batch"`` drops the second half of each batch's slots."""
        cfg, n = self.cfg, self.cfg["checked_steps"]
        _, expected = self.data_check()
        inputs = (expected or self.host_batches())[:n]
        batches = [tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                         for x in batch) for batch in inputs]
        if fault == "half_batch":
            batches = [tuple(x[: self.mix["slots"] // 2] for x in batch) for batch in batches]
        leaves = weights.lm_leaves(self.seed, cfg, self.device)
        readings = compare.read_steps(
            leaves, reference_lm.train(leaves, batches, cfg, cfg["learning_rate"], precision),
            lambda: weights.lm_leaves(self.seed, cfg, self.device), cfg["learning_rate"], n)
        return compare.Readings(*readings)

    def check(self):
        """The numbers compared: the delivered batches against the store,
        and the checked steps against the reference's."""
        values = {"data_mismatches": float(self.data_check()[0])}
        values.update(compare.gaps(compare.Readings(*self.program), self.reference()))
        return values
