"""The Criteo DLRM cell: ``make_batch_reader`` → ``make_torch_dataloader``
→ ``collate_dlrm`` → ``DLRM`` trained by ``make_dlrm_train_step``."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare, weights
from perfbench.reference import dlrm as reference_dlrm
from perfbench.reference import rows as reference_rows

UNIT = "rows"
HOST_OPS = ()
#: Share of the window's batches kept for the data check, and their most.
SAMPLE_SHARE, SAMPLE_MOST = 1 / 16, 64


class Cell:
    def __init__(self, cfg, mix, seed, device, workdir, generator):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.workdir, self.generator = workdir, generator
        self.kept = []          # (label, dense, cat) device batches for the data check
        self.sample = np.random.default_rng(int(seed))
        self.in_window = False
        self.program = None

    # -- the program -------------------------------------------------------

    def setup(self):
        from petastorm_tpu_torch.models.tabular_dlrm import (
            DLRM,
            collate_dlrm,
            make_dlrm_train_step,
        )
        from petastorm_tpu_torch.reader.reader import make_batch_reader
        from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

        cfg, mix = self.cfg, self.mix
        self.store = self.generator.make_store(mix, cfg, self.seed, self.workdir, self.device)
        with self.device:
            self.model = DLRM(cfg["num_dense"], cfg["num_sparse"], cfg["table_rows"],
                              cfg["embed_dim"], cfg["bottom_hidden"], cfg["top_hidden"],
                              compute_dtype=getattr(torch, cfg["compute_dtype"]))
        self.leaves = dict(self.model.named_parameters())
        weights.fill_dlrm(self.leaves, self.seed)
        self.train_step = make_dlrm_train_step(self.model, cfg["learning_rate"])
        reader = make_batch_reader(self.store.url, num_epochs=None, shuffle_row_groups=True,
                                   shard_seed=int(self.seed) % (2 ** 32),
                                   workers_count=mix["reader_workers"])
        self.loader = make_torch_dataloader(reader, mix["batch"], last_batch="drop",
                                            device=self.device)
        self.loader.__enter__()
        self.collate = collate_dlrm

    def step(self, batch):
        dense, sparse, labels = self.collate(batch)
        keep = not self.in_window or (self.sample.random() < SAMPLE_SHARE
                                      and len(self.kept) < self.cfg["checked_steps"] + SAMPLE_MOST)
        if keep:
            self.kept.append((labels, dense, sparse))
        mask = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
        return self.train_step(dense, sparse, labels, mask), labels.shape[0]

    def checked_steps(self, batches):
        cfg = self.cfg
        losses = (self.step(batch)[0] for batch in batches)
        self.program = compare.read_steps(
            self.leaves, losses, lambda: weights.dlrm_leaves(self.seed, cfg, self.device),
            cfg["learning_rate"], cfg["checked_steps"])

    def mark_window(self):
        self.in_window = True

    def close(self):
        self.loader.__exit__(None, None, None)

    def free(self):
        del self.model, self.leaves, self.train_step, self.loader

    def work(self):
        return {}

    # -- correctness -----------------------------------------------------------

    def data_check(self):
        """``(mismatched rows, starts)`` of the kept batches (worked out once)."""
        if not hasattr(self, "_data"):
            host = [tuple(t.cpu().numpy() for t in b) for b in self.kept]
            self.kept = []
            s = self.store
            self._data = reference_rows.check_batches(s.label, s.dense, s.cat, host,
                                                      self.mix["batch"])
            self._host = host
        return self._data

    def reference(self, precision="f32", fault=None):
        """The reference's readings of the checked steps, in ``precision``;
        ``fault="half_batch"`` drops each batch's second half."""
        cfg, n, batch = self.cfg, self.cfg["checked_steps"], self.mix["batch"]
        _, starts = self.data_check()
        s, inputs = self.store, []
        for k in range(n):
            if starts[k] is None:
                label, dense, cat = self._host[k]
            else:
                rows = slice(starts[k], starts[k] + batch)
                label, dense, cat = s.label[rows], s.dense[rows], s.cat[rows]
            if fault == "half_batch":
                label, dense, cat = label[:batch // 2], dense[:batch // 2], cat[:batch // 2]
            inputs.append(tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                                for x in (dense, cat, label)))
        leaves = weights.dlrm_leaves(self.seed, cfg, self.device)
        readings = compare.read_steps(
            leaves, reference_dlrm.train(leaves, inputs, cfg["learning_rate"], precision),
            lambda: weights.dlrm_leaves(self.seed, cfg, self.device), cfg["learning_rate"], n)
        return compare.Readings(*readings)

    def check(self):
        values = {"data_mismatches": float(self.data_check()[0])}
        values.update(compare.gaps(compare.Readings(*self.program), self.reference()))
        return values
