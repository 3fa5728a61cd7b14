"""The port's batcher and row loader against the JAX package's:
``batch_iterator`` yields the same batches as the JAX one for drop, pad and
keep, ``max_batches``, a seeded shuffle buffer and column-batch
rebatching; ``make_torch_dataloader(device="cpu")`` yields, batch for
batch, what ``make_jax_dataloader(stage_to_device=False)`` yields, with
``non_tensor_policy`` and the JAX loader's diagnostics keys. Values compare
exactly (the same rows, collated the same way)."""

import threading

import numpy as np
import pytest
import torch

from petastorm_tpu.jax_utils.batcher import batch_iterator as jax_batch_iterator
from petastorm_tpu.jax_utils.loader import make_jax_dataloader
from petastorm_tpu.reader.reader import make_columnar_reader as jax_columnar_reader
from petastorm_tpu.reader.reader import make_reader as jax_make_reader
from petastorm_tpu.reader_impl.shuffling_buffer import (
    NoopShufflingBuffer as JaxNoopShufflingBuffer,
)
from petastorm_tpu.reader_impl.shuffling_buffer import (
    RandomShufflingBuffer as JaxRandomShufflingBuffer,
)
from petastorm_tpu.schema.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu_torch.etl.metadata import materialize_rows
from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
from petastorm_tpu_torch.reader_impl.shuffling_buffer import (
    NoopShufflingBuffer,
    RandomShufflingBuffer,
)
from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.schema.transform import TransformSpec
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY, batch_iterator
from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader, make_torch_dataloader

ROWS, GROUP, SHAPE = 70, 16, (16, 16, 3)  # 5 row groups, the last one short


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('batches')}/ds"
    schema = Unischema("Img", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, SHAPE, CompressedImageCodec("png"), False),
        UnischemaField("features", np.float32, (4,), NdarrayCodec(), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(2)
    materialize_rows(url, schema, ({"id": np.int64(i),
                                    "image": rng.randint(0, 256, SHAPE, dtype=np.uint8),
                                    "features": rng.rand(4).astype(np.float32),
                                    "label": np.int32(i % 10)} for i in range(ROWS)),
                     rows_per_row_group=GROUP)
    return url


def _readers(url, columnar=False, **kwargs):
    kwargs = dict(dict(reader_pool_type="dummy", shuffle_row_groups=False), **kwargs)
    if columnar:
        return make_columnar_reader(url, **kwargs), jax_columnar_reader(url, **kwargs)
    return make_reader(url, **kwargs), jax_make_reader(url, **kwargs)


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for name in w:
            gv = g[name].numpy() if torch.is_tensor(g[name]) else np.asarray(g[name])
            wv = np.asarray(w[name])
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
            np.testing.assert_array_equal(gv, wv)


# name -> batch_iterator kwargs
ITERATOR_CASES = {
    "drop": dict(batch_size=16, last_batch="drop"),
    "pad": dict(batch_size=16, last_batch="pad"),
    "keep": dict(batch_size=16, last_batch="keep"),
    "pad_max_batches": dict(batch_size=12, last_batch="pad", max_batches=3),
    "keep_shuffle_buffer": dict(batch_size=16, last_batch="keep", shuffle_buffer_size=24,
                                shuffle_seed=7),
    "pad_shuffle_buffer_max_batches": dict(batch_size=32, last_batch="pad",
                                           shuffle_buffer_size=40, shuffle_seed=1,
                                           max_batches=2),
}


@pytest.mark.parametrize("case", sorted(ITERATOR_CASES))
def test_batch_iterator_matches_jax_on_rows(url, case):
    port, jax = _readers(url)
    with port, jax:
        _same(list(batch_iterator(port, **ITERATOR_CASES[case])),
              list(jax_batch_iterator(jax, **ITERATOR_CASES[case])))


@pytest.mark.parametrize("last_batch", ["drop", "pad", "keep"])
def test_batch_iterator_matches_jax_on_column_batches(url, last_batch):
    port, jax = _readers(url, columnar=True, shuffle_row_groups=True, shard_seed=2,
                         num_epochs=2)
    with port, jax:
        _same(list(batch_iterator(port, 24, last_batch=last_batch)),
              list(jax_batch_iterator(jax, 24, last_batch=last_batch)))


def test_batch_iterator_errors(url):
    port, _ = _readers(url, columnar=True)
    with port:
        with pytest.raises(ValueError, match="row reader"):
            next(batch_iterator(port, 8, shuffle_buffer_size=4))
        with pytest.raises(ValueError, match="last_batch"):
            next(batch_iterator(port, 8, last_batch="wrap"))
        with pytest.raises(ValueError, match="positive"):
            next(batch_iterator(port, 0))


def test_pad_marks_the_real_rows(url):
    port, _ = _readers(url)
    with port:
        batches = list(batch_iterator(port, 16, last_batch="pad"))
    assert all(PAD_MASK_KEY not in b for b in batches[:-1])
    last = batches[-1]
    assert last[PAD_MASK_KEY].tolist() == [True] * (ROWS % 16) + [False] * (16 - ROWS % 16)
    np.testing.assert_array_equal(last["id"][ROWS % 16:], last["id"][:16 - ROWS % 16])


@pytest.mark.parametrize("buffer", ["random", "noop"])
def test_shuffling_buffers_match_jax(buffer):
    if buffer == "random":
        port, jax = (RandomShufflingBuffer(10, 4, extra_capacity=20, random_seed=9),
                     JaxRandomShufflingBuffer(10, 4, extra_capacity=20, random_seed=9))
    else:
        port, jax = NoopShufflingBuffer(), JaxNoopShufflingBuffer()
    out = {"port": [], "jax": []}
    for start in range(0, 60, 6):
        for name, buf in (("port", port), ("jax", jax)):
            buf.add_many(range(start, start + 6))
            while buf.can_retrieve() and (not buf.can_add() or buf.size > 8):
                out[name].append(buf.retrieve())
    for name, buf in (("port", port), ("jax", jax)):
        buf.finish()
        while buf.can_retrieve():
            out[name].append(buf.retrieve())
    assert out["port"] == out["jax"] and sorted(out["port"]) == list(range(60))


def _add_name(row):
    row["name"] = f"row-{row['id']}"
    return row


# name -> (reader kwargs, loader kwargs)
LOADER_CASES = {
    "drop": (dict(), dict(batch_size=16, last_batch="drop")),
    "pad": (dict(shuffle_row_groups=True, shard_seed=4, num_epochs=2),
            dict(batch_size=32, last_batch="pad")),
    "keep_max_batches": (dict(), dict(batch_size=20, last_batch="keep", max_batches=3)),
    "shuffle_buffer": (dict(), dict(batch_size=16, last_batch="pad", shuffle_buffer_size=30,
                                    shuffle_seed=3)),
    "host_strings": (dict(transform=True), dict(batch_size=16, last_batch="keep")),
}


def _loader_batches(url, reader_kwargs, loader_kwargs):
    kwargs = dict(dict(reader_pool_type="dummy", shuffle_row_groups=False), **reader_kwargs)
    spec = (dict(func=_add_name, edit_fields=[("name", str, (), False)])
            if kwargs.pop("transform", False) else None)
    port = make_reader(url, transform_spec=spec and TransformSpec(**spec), **kwargs)
    jax = jax_make_reader(url, transform_spec=spec and JaxTransformSpec(**spec), **kwargs)
    with make_torch_dataloader(port, device="cpu", **loader_kwargs) as loader:
        got = list(loader)
        diag = loader.diagnostics
    with make_jax_dataloader(jax, stage_to_device=False, **loader_kwargs) as jax_loader:
        want = list(jax_loader)
        jax_diag = jax_loader.diagnostics
    return got, want, diag, jax_diag


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_matches_jax_loader_batch_for_batch(url, case):
    got, want, diag, jax_diag = _loader_batches(url, *LOADER_CASES[case])
    _same(got, want)
    for batch in got:
        for name, col in batch.items():
            if name == "name":  # strings stay on the host as numpy
                assert isinstance(col, np.ndarray) and col.dtype == object
            else:
                assert isinstance(col, torch.Tensor) and col.device.type == "cpu"
    assert set(diag) == set(jax_diag)
    for key in ("batches", "rows", "max_batches", "h2d_bytes"):
        assert diag[key] == (jax_diag[key] if key != "h2d_bytes" else 0), key


@pytest.mark.parametrize("policy", ["drop", "error"])
def test_non_tensor_policy(url, policy):
    reader = make_reader(url, reader_pool_type="dummy", transform_spec=TransformSpec(
        func=_add_name, edit_fields=[("name", str, (), False)]))
    with make_torch_dataloader(reader, 16, device="cpu", non_tensor_policy=policy) as loader:
        if policy == "error":
            with pytest.raises(TypeError, match="non-tensor dtype"):
                list(loader)
        else:
            assert all("name" not in b and "id" in b for b in loader)


def test_loader_argument_errors(url):
    reader = make_reader(url, reader_pool_type="dummy")
    with reader:
        with pytest.raises(TypeError, match="batch_source"):
            TorchDataLoader(reader, device="cpu")
        with pytest.raises(ValueError, match="device_prefetch"):
            make_torch_dataloader(reader, 8, device="cpu", device_prefetch=0)
        with pytest.raises(ValueError, match="host\\|drop\\|error"):
            make_torch_dataloader(reader, 8, device="cpu", non_tensor_policy="keep")


def test_loader_joins_its_threads_when_abandoned(url):
    reader = make_reader(url, reader_pool_type="thread", workers_count=2, num_epochs=None)
    with make_torch_dataloader(reader, 8, device="cpu", host_prefetch=1) as loader:
        for i, _ in enumerate(loader):
            if i == 3:
                break
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("torch-loader-producer", "petastorm-tpu-worker-torch",
                                   "petastorm-torch-ventilator"))]
    assert alive == []
