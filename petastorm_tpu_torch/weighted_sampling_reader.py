"""Mix several readers with given sampling probabilities (the port's own
copy of ``petastorm_tpu/weighted_sampling_reader.py``).

Each ``next()`` draws ``random.Random(seed).random()`` once and reads from
the first reader whose cumulative normalized weight exceeds the draw: the
JAX package's draw sequence, so one seed picks the same sources in both.
"""

from __future__ import annotations

import logging
import random

logger = logging.getLogger(__name__)


class WeightedSamplingReader:
    """``next()`` reads from ``readers[i]`` with probability
    ``probabilities[i]`` (normalized). Iteration stops when the drawn reader
    is exhausted: its StopIteration propagates."""

    def __init__(self, readers, probabilities, random_seed=None):
        if len(readers) != len(probabilities):
            raise ValueError(
                f"len(readers)={len(readers)} != len(probabilities)={len(probabilities)}")
        if not readers:
            raise ValueError("At least one reader is required")
        total = float(sum(probabilities))
        if total <= 0:
            raise ValueError("Probabilities must sum to a positive value")
        self._readers = list(readers)
        self._cum = []
        acc = 0.0
        for p in probabilities:
            acc += p / total
            self._cum.append(acc)
        if random_seed is None:
            logger.warning("WeightedSamplingReader(random_seed=None) draws from an "
                           "unseeded RNG: the mix is not reproducible. Pass an explicit "
                           "seed.")
        self._random = random.Random(random_seed)
        # The mixed readers must yield compatible rows; the first reader's
        # schema and ngram stand for the mix, as a plain reader's do.
        first = readers[0]
        self.schema = getattr(first, "schema", None)
        self.ngram = getattr(first, "ngram", None)
        self.batched_output = getattr(first, "batched_output", False)

    def __iter__(self):
        return self

    def __next__(self):
        draw = self._random.random()
        for index, threshold in enumerate(self._cum):
            if draw < threshold:
                return next(self._readers[index])
        return next(self._readers[-1])  # a draw at the rounded top of the last weight

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()

    def stop(self):
        for reader in self._readers:
            reader.stop()

    def join(self):
        for reader in self._readers:
            reader.join()
