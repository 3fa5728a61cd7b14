"""Token documents with log-normal lengths, in a petastorm store of the
port's corpus layout (``tokens`` padded to the slot length, ``length``).

The lengths are the mix's: drawn from ``length_seed`` alone, so every
run packs the same documents in the same order and does the same work.
The run's seed draws the tokens, uniform over the configuration's
vocabulary.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class DocumentStore:
    url: str
    docs: list            # one int32 array of tokens a document, in store order
    docs_per_row_group: int


def document_lengths(mix):
    """The mix's document lengths: round(exp(N(ln median, sigma²))),
    clipped to [min_len, max_len]."""
    rng = np.random.RandomState(mix["length_seed"])
    raw = np.exp(np.log(mix["median"]) + mix["sigma"] * rng.standard_normal(mix["docs"]))
    return np.clip(np.rint(raw), mix["min_len"], mix["max_len"]).astype(np.int64)


def make_documents(mix, vocab, seed):
    lengths = document_lengths(mix)
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    tokens = rng.integers(0, vocab, size=int(lengths.sum()), dtype=np.int32)
    return np.split(tokens, np.cumsum(lengths)[:-1])


def make_store(mix, cfg, seed, workdir):
    """Write the corpus under ``workdir`` and return it with its documents."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.models.long_context_lm import corpus_schema

    docs = make_documents(mix, cfg["vocab_size"], seed)
    slot_len = mix["slot_len"]

    def rows():
        for doc in docs:
            padded = np.zeros(slot_len, np.int32)
            padded[:len(doc)] = doc
            yield {"tokens": padded, "length": np.int32(len(doc))}

    url = "file://" + os.path.join(os.path.abspath(workdir), "corpus")
    materialize_rows(url, corpus_schema(slot_len, encoded=False), rows(),
                     rows_per_row_group=mix["docs_per_row_group"])
    return DocumentStore(url, docs, mix["docs_per_row_group"])
