"""``make_packed_torch_dataloader(device="cpu")`` against
``make_packed_jax_dataloader(stage_to_device=False)``: the same packed
tokens / positions / segment ids step for step, plus ``max_batches``, thread
shutdown and the diagnostics the trainer reads."""

import threading

import numpy as np
import pytest
import torch

from examples.long_context_lm.train_lm import generate_corpus as jax_generate_corpus
from petastorm_tpu.jax_utils.packing import make_packed_jax_dataloader
from petastorm_tpu.jax_utils.packing import pack_ragged as jax_pack_ragged
from petastorm_tpu.reader.reader import make_columnar_reader as jax_reader
from petastorm_tpu_torch.reader.reader import make_columnar_reader
from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader
from petastorm_tpu_torch.torch_utils.packing import (
    PACK_POSITION_KEY,
    PACK_SEGMENT_KEY,
    make_packed_torch_dataloader,
    pack_ragged,
    packed_valid_mask,
)

KEYS = ("tokens", PACK_POSITION_KEY, PACK_SEGMENT_KEY)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('packed')}/corpus"
    jax_generate_corpus(url, docs=400, max_len=32)
    return url


def _jax_batches(url, **reader_kwargs):
    reader = jax_reader(url, reader_pool_type="dummy", **reader_kwargs)
    loader = make_packed_jax_dataloader(reader, slot_len=64, slots=4,
                                        sequence_fields=["tokens"],
                                        length_field="length",
                                        stage_to_device=False)
    with loader:
        return [{k: np.asarray(b[k]) for k in KEYS} for b in loader]


def _port_loader(url, max_batches=None, **reader_kwargs):
    reader = make_columnar_reader(url, reader_pool_type="dummy", **reader_kwargs)
    return make_packed_torch_dataloader(reader, slot_len=64, slots=4,
                                        sequence_fields=["tokens"],
                                        length_field="length",
                                        max_batches=max_batches, device="cpu")


@pytest.mark.parametrize("reader_kwargs", [
    dict(shuffle_row_groups=False),
    dict(shuffle_row_groups=True, shard_seed=5, num_epochs=2),
], ids=["in_order", "seeded_shuffle_two_epochs"])
def test_packed_batches_match_jax_step_for_step(corpus, reader_kwargs):
    want = _jax_batches(corpus, **reader_kwargs)
    with _port_loader(corpus, **reader_kwargs) as loader:
        got = list(loader)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for key in KEYS:
            assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), w[key])
            assert g[key].numpy().dtype == w[key].dtype


def test_max_batches_and_diagnostics(corpus):
    with _port_loader(corpus, max_batches=3, shuffle_row_groups=False) as loader:
        got = list(loader)
        diag = loader.diagnostics
    assert len(got) == 3
    assert diag["batches"] == 3 and diag["max_batches"] == 3
    assert 0.0 <= diag["input_stall_pct"] <= 100.0
    assert diag["wall_s"] > 0 and diag["h2d_bytes"] == 0  # no H2D on the CPU


def test_threads_are_joined_on_close(corpus):
    reader = make_columnar_reader(corpus, reader_pool_type="thread",
                                  workers_count=2, shuffle_row_groups=False,
                                  num_epochs=None)
    loader = make_packed_torch_dataloader(reader, slot_len=64, slots=4,
                                          sequence_fields=["tokens"],
                                          length_field="length", device="cpu",
                                          host_prefetch=1)
    with loader:
        for i, _ in enumerate(loader):
            if i == 2:
                break  # abandon an infinite stream mid-way
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("torch-loader-producer", "petastorm-tpu-worker-torch",
                                   "petastorm-torch-ventilator"))]
    assert alive == []


def test_reiteration_restarts_the_source(corpus):
    reader = make_columnar_reader(corpus, reader_pool_type="dummy",
                                  shuffle_row_groups=False)
    calls = []

    def source():
        calls.append(1)
        return iter([{"x": np.arange(4)}, {"x": np.arange(4) + 1}])

    with TorchDataLoader(reader, source, device="cpu") as loader:
        assert [b["x"].tolist() for b in loader] == [[0, 1, 2, 3], [1, 2, 3, 4]]
        assert len(list(loader)) == 2
    assert len(calls) == 2


def test_producer_errors_reach_the_consumer(corpus):
    reader = make_columnar_reader(corpus, reader_pool_type="dummy")

    def source():
        yield {"x": np.arange(3)}
        raise KeyError("boom")

    with TorchDataLoader(reader, source, device="cpu") as loader:
        with pytest.raises(KeyError, match="boom"):
            list(loader)


def test_pack_ragged_matches_jax():
    rng = np.random.RandomState(11)
    rows = [{"tokens": rng.randint(0, 50, rng.randint(0, 20)).astype(np.int32),
             "extra": np.int32(1)} for _ in range(60)]
    got = list(pack_ragged(iter(rows), slot_len=24, slots=3, keys=["tokens"]))
    want = list(jax_pack_ragged(iter(rows), slot_len=24, slots=3, keys=["tokens"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
        np.testing.assert_array_equal(packed_valid_mask(g[PACK_SEGMENT_KEY]),
                                      w[PACK_SEGMENT_KEY] >= 0)
    with pytest.raises(ValueError, match="does not fit slot_len"):
        list(pack_ragged([{"tokens": np.zeros(30)}], slot_len=24, slots=1))

