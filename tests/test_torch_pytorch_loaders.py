"""The port's classic PyTorch loaders (``petastorm_tpu_torch.pytorch``)
against ``petastorm_tpu.pytorch`` on the same readers and seeds, with
``device="cpu"``: ``DataLoader`` (with and without its row shuffling
buffer, over uint16/uint32/uint64 and Decimal fields),
``BatchedDataLoader`` (FIFO and shuffled, ``transform_fn``) and
``InMemBatchedDataLoader`` (batch and row readers) yield tensors equal in
value, dtype and order; the batched shuffling buffers match the JAX ones
call for call; ``WeightedSamplingReader`` draws the same sources for a seed
and stops where the JAX one stops; and the MNIST example's path as a whole
(reader with the example's transform, a predicate, row-drop partitions and
the local-disk cache → ``DataLoader`` → the example's MLP) gives the same
batches and losses in both packages.

Tolerance: none; everything is compared exactly.
"""

import decimal
import random

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu.pytorch as jax_pt
import petastorm_tpu_torch.pytorch as port_pt
from petastorm_tpu_torch import predicates as port_predicates
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu.reader_impl import pytorch_shuffling_buffer as jax_buffers
from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.reader_impl import pytorch_shuffling_buffer as port_buffers

ROWS = 150


@pytest.fixture(scope="module")
def row_store(tmp_path_factory):
    """A petastorm store (port-written) with the dtypes torch lacks, a
    Decimal, an image and a float matrix; row groups of 25."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import (
        CompressedImageCodec,
        NdarrayCodec,
        ScalarCodec,
    )
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("LoaderSchema", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("u16", np.uint16, (), ScalarCodec(), False),
        UnischemaField("u32", np.uint32, (), ScalarCodec(), False),
        UnischemaField("u64", np.uint64, (), ScalarCodec(), False),
        UnischemaField("price", decimal.Decimal, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, (6, 6), CompressedImageCodec("png"), False),
        UnischemaField("m", np.float32, (2, 3), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(21)
    url = f"file://{tmp_path_factory.mktemp('loaders')}/rows"
    materialize_rows(url, schema, ({
        "idx": i, "u16": np.uint16(rng.randint(0, 2**16)), "u32": np.uint32(rng.randint(0, 2**31)),
        "u64": np.uint64(rng.randint(0, 2**40)), "price": decimal.Decimal(f"{i}.{i % 7}5"),
        "image": rng.randint(0, 256, (6, 6), dtype=np.uint8),
        "m": rng.rand(2, 3).astype(np.float32)} for i in range(ROWS)), rows_per_row_group=25)
    return url


@pytest.fixture(scope="module")
def batch_store(tmp_path_factory):
    """A plain Parquet store of numeric columns (unsigned ones included),
    row groups of 40."""
    rng = np.random.RandomState(22)
    path = tmp_path_factory.mktemp("loaders_plain") / "plain"
    path.mkdir()
    n = 400
    pq.write_table(pa.table({
        "k": np.arange(n, dtype=np.int64), "u16": rng.randint(0, 2**16, n).astype(np.uint16),
        "u32": rng.randint(0, 2**31, n).astype(np.uint32), "x": rng.rand(n).astype(np.float32),
        "flag": rng.rand(n) > 0.5}), path / "part-0.parquet", row_group_size=40)
    return f"file://{path}"


def _assert_same(got, want):
    """Batches equal in structure, value and dtype (strings as lists)."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and got.device.type == "cpu"
        assert torch.equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


def _assert_streams_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)


READER = dict(reader_pool_type="dummy", shuffle_row_groups=True, shard_seed=3)


@pytest.mark.parametrize("capacity,seed", [(0, None), (40, 9), (200, 1)])
def test_dataloader_matches_jax(row_store, capacity, seed):
    def run(pt, factory):
        with pt.DataLoader(factory(row_store, **READER), batch_size=16,
                           shuffling_queue_capacity=capacity, shuffling_queue_seed=seed,
                           **({"device": "cpu"} if pt is port_pt else {})) as loader:
            return list(loader)

    got, want = run(port_pt, make_reader), run(jax_pt, jax_make_reader)
    _assert_streams_equal(got, want)
    assert got[0]["u16"].dtype == torch.int32 and got[0]["u64"].dtype == torch.int64
    assert isinstance(got[0]["price"], list) and isinstance(got[0]["price"][0], str)
    assert sum(len(b["idx"]) for b in got) == ROWS


@pytest.mark.parametrize("capacity,seed,transform", [(0, None, False), (120, 4, False),
                                                      (300, 8, True)])
def test_batched_dataloader_matches_jax(batch_store, capacity, seed, transform):
    def scale(batch):
        return {**batch, "x": batch["x"] * 2}

    def run(pt, factory):
        with pt.BatchedDataLoader(factory(batch_store, num_epochs=2, **READER), batch_size=32,
                                  shuffling_queue_capacity=capacity, shuffling_queue_seed=seed,
                                  transform_fn=scale if transform else None,
                                  **({"device": "cpu"} if pt is port_pt else {})) as loader:
            return list(loader)

    got, want = run(port_pt, make_batch_reader), run(jax_pt, jax_make_batch_reader)
    _assert_streams_equal(got, want)
    assert sorted(torch.cat([b["k"] for b in got]).tolist()) == sorted(list(range(400)) * 2)
    assert got[0]["u32"].dtype == torch.int64 and got[0]["flag"].dtype == torch.bool


@pytest.mark.parametrize("kind", ["batch", "rows", "rows_capacity", "no_shuffle"])
def test_inmem_batched_dataloader_matches_jax(row_store, batch_store, kind):
    def run(pt, factory, url, **kwargs):
        extra = {"device": "cpu"} if pt is port_pt else {}
        loader = pt.InMemBatchedDataLoader(factory(url, **READER), batch_size=24, num_epochs=3,
                                           random_seed=6, **kwargs, **extra)
        with loader:
            return list(loader)

    if kind == "batch":
        # The JAX loader keeps a batch reader's unsigned columns, which torch
        # cannot index_select: the parity run leaves them out.
        args = (batch_store, {})
        factories = tuple(lambda u, f=f, **kw: f(u, schema_fields=["k", "x", "flag"], **kw)
                          for f in (make_batch_reader, jax_make_batch_reader))
    else:
        args = (row_store, {"rows_capacity": 100} if kind == "rows_capacity"
                else {"shuffle": False} if kind == "no_shuffle" else {})
        factories = (make_reader, jax_make_reader)
    url, kwargs = args
    if kind != "batch":
        # Row readers' Decimal field cannot become a tensor: take the rest.
        fields = ["idx", "u16", "u32", "u64", "image", "m"]
        factories = tuple(lambda u, f=f, **kw: f(u, schema_fields=fields, **kw)
                          for f in factories)
    got = run(port_pt, factories[0], url, **kwargs)
    want = run(jax_pt, factories[1], url, **kwargs)
    _assert_streams_equal(got, want)
    key = "k" if kind == "batch" else "idx"
    n = {"batch": 400, "rows_capacity": 100}.get(kind, ROWS)
    per_epoch = -(-n // 24)
    epochs = [torch.cat([b[key] for b in got[e * per_epoch:(e + 1) * per_epoch]])
              for e in range(3)]
    assert all(sorted(e.tolist()) == sorted(epochs[0].tolist()) for e in epochs)
    assert len(set(epochs[0].tolist())) == n


def test_inmem_batched_dataloader_promotes_unsigned_columns(batch_store):
    with port_pt.InMemBatchedDataLoader(make_batch_reader(batch_store, **READER), batch_size=64,
                                        random_seed=2, device="cpu") as loader:
        batches = list(loader)
    table = pq.read_table(batch_store[len("file://"):])
    order = torch.cat([b["k"] for b in batches])
    for name, dtype in (("u16", torch.int32), ("u32", torch.int64)):
        got = torch.cat([b[name] for b in batches])
        assert got.dtype == dtype
        want = table.column(name).to_numpy().astype(np.int64)[order.numpy()]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("buffer", ["noop", "random"])
def test_batched_shuffling_buffers_match_jax_call_for_call(buffer):
    rng = np.random.RandomState(30)
    chunks = [{"a": rng.randint(0, 1000, n), "b": rng.rand(n, 2).astype(np.float32)}
              for n in rng.randint(5, 40, 12)]

    def make(m, **kw):
        if buffer == "noop":
            return m.BatchedNoopShufflingBuffer(batch_size=7, **kw)
        return m.BatchedRandomShufflingBuffer(60, min_after_retrieve=20, extra_capacity=100,
                                              batch_size=7, random_seed=12, **kw)

    def drive(buf):
        out = []
        for chunk in chunks:
            buf.add_many({k: torch.as_tensor(v.copy()) for k, v in chunk.items()})
            while buf.should_drain():
                out.append(buf.retrieve())
        buf.finish()
        while buf.can_retrieve():
            out.append(buf.retrieve())
        return out

    got, want = drive(make(port_buffers, device="cpu")), drive(make(jax_buffers))
    _assert_streams_equal(got, want)


def test_sanitize_and_collate_match_jax():
    row = {"u16": np.uint16(7), "u32": np.array([1, 2], np.uint32), "u64": np.uint64(2**40),
           "i": np.int8(3), "s": "text", "d": decimal.Decimal("1.50")}
    got = port_pt._sanitize_pytorch_types(dict(row))
    want = jax_pt._sanitize_pytorch_types(dict(row))
    assert {k: (type(v), getattr(v, "dtype", None)) for k, v in got.items()} == \
        {k: (type(v), getattr(v, "dtype", None)) for k, v in want.items()}
    batch = [{"x": np.float32(i), "d": decimal.Decimal(f"{i}.5"), "s": f"s{i}",
              "t": (np.int64(i), [np.int32(i), np.int32(2 * i)])} for i in range(4)]
    _assert_same(port_pt.decimal_friendly_collate(batch), jax_pt.decimal_friendly_collate(batch))
    for pt in (port_pt, jax_pt):
        with pytest.raises(TypeError, match="Cannot collate None"):
            pt.decimal_friendly_collate([None, None])


def test_loaders_refuse_the_wrong_reader_kind(row_store, batch_store):
    with make_batch_reader(batch_store) as reader:
        with pytest.raises(ValueError, match="expects a row reader"):
            port_pt.DataLoader(reader, device="cpu")
    with make_reader(row_store) as reader:
        with pytest.raises(ValueError, match="expects a batch reader"):
            port_pt.BatchedDataLoader(reader, device="cpu")
    with make_batch_reader(f"{row_store}", reader_pool_type="dummy") as reader:
        loader = port_pt.BatchedDataLoader(reader, batch_size=8, device="cpu")
        with pytest.raises(TypeError, match="cannot become a torch tensor"):
            next(iter(loader))


class _Source:
    """A reader stand-in yielding ``(name, i)`` for ``n`` items."""

    def __init__(self, name, n):
        self._it = iter([(name, i) for i in range(n)])
        self.stopped = False

    def __next__(self):
        return next(self._it)

    def stop(self):
        self.stopped = True

    def join(self):
        pass


@pytest.mark.parametrize("weights,seed", [([0.75, 0.25], 7), ([1, 2, 3], 0), ([0.5, 0.0], 3)])
def test_weighted_sampling_reader_draws_the_jax_sources(weights, seed):
    from petastorm_tpu.weighted_sampling_reader import WeightedSamplingReader as JaxMix
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    def drain(cls):
        sources = [_Source(f"r{i}", 60) for i in range(len(weights))]
        mix = cls(sources, weights, random_seed=seed)
        out = []
        while True:
            try:
                out.append(next(mix))
            except StopIteration:
                break
        mix.stop()
        assert all(s.stopped for s in sources)
        return out

    got = drain(WeightedSamplingReader)
    assert got == drain(JaxMix)
    # A host replay of random.Random(seed) over the cumulative weights.
    rnd, total = random.Random(seed), sum(weights)
    cum = np.cumsum([w / total for w in weights])
    counts = [0] * len(weights)
    for name, i in got:
        draw = rnd.random()
        pick = next((j for j, c in enumerate(cum) if draw < c), len(weights) - 1)
        assert (name, i) == (f"r{pick}", counts[pick])
        counts[pick] += 1


def test_weighted_sampling_reader_validation():
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    with pytest.raises(ValueError, match="len\\(readers\\)"):
        WeightedSamplingReader([_Source("a", 1)], [0.5, 0.5])
    with pytest.raises(ValueError, match="At least one reader"):
        WeightedSamplingReader([], [])
    with pytest.raises(ValueError, match="positive"):
        WeightedSamplingReader([_Source("a", 1)], [0.0])


def test_mnist_rows_are_the_examples():
    from examples.mnist.generate_petastorm_mnist import mnist_rows as example_rows
    from petastorm_tpu_torch.models.mnist import mnist_rows

    for got, want in zip(mnist_rows(50), example_rows(count=50), strict=True):
        assert got["idx"] == want["idx"] and got["digit"] == want["digit"]
        np.testing.assert_array_equal(got["image"], want["image"])


def test_mnist_example_path_matches_jax(tmp_path):
    """The slice as a whole, at a small size: the MNIST example's reader
    (the example's transform, a pseudorandom-split predicate, row-drop
    partitions, the local-disk cache) → ``DataLoader`` with a shuffling
    buffer → the example's MLP, two epochs, in both packages: the same
    batches and the same losses, bit for bit; the port's second epoch
    served from its cache."""
    from examples.mnist.pytorch_example import _to_float as example_to_float
    from petastorm_tpu.schema.transform import TransformSpec as JaxSpec
    from petastorm_tpu_torch.models import mnist

    url = f"file://{tmp_path}/mnist"
    mnist.generate_mnist_dataset(url, count=400, rows_per_row_group=50)

    def run(pt, factory, predicates, spec, extra):
        model = mnist.init_mnist_mlp(seed=0, device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.01)
        batches, losses = [], []
        for epoch in range(2):
            reader = factory(url, schema_fields=["idx", "image", "digit"], transform_spec=spec,
                             predicate=predicates.in_pseudorandom_split([0.8, 0.2], 0, "idx"),
                             shuffle_row_drop_partitions=2, cache_type="local-disk",
                             cache_location=str(tmp_path / f"cache_{pt.__name__}"),
                             cache_size_limit=2**28, reader_pool_type="dummy", shard_seed=epoch,
                             num_epochs=1)
            with pt.DataLoader(reader, batch_size=16, shuffling_queue_capacity=64,
                               shuffling_queue_seed=epoch, **extra) as loader:
                for batch in loader:
                    opt.zero_grad()
                    loss = torch.nn.functional.cross_entropy(model(batch["image"]),
                                                             batch["digit"])
                    loss.backward()
                    opt.step()
                    losses.append(loss.item())
                    batches.append(batch)
        return batches, losses

    port_spec = mnist.MNIST_TRANSFORM
    jax_spec = JaxSpec(example_to_float, edit_fields=[("image", np.float32, (28, 28), False)])
    got, got_losses = run(port_pt, make_reader, port_predicates, port_spec, {"device": "cpu"})
    want, want_losses = run(jax_pt, jax_make_reader, jax_predicates, jax_spec, {})
    _assert_streams_equal(got, want)
    assert got_losses == want_losses and all(np.isfinite(got_losses))
    kept = {i for i in range(400)
            if port_predicates.in_pseudorandom_split([0.8, 0.2], 0, "idx").do_include({"idx": i})}
    per_epoch = len(got) // 2
    for epoch in range(2):
        idx = torch.cat([b["idx"] for b in got[epoch * per_epoch:(epoch + 1) * per_epoch]])
        assert sorted(idx.tolist()) == sorted(kept)
    assert got[0]["image"].dtype == torch.float32 and float(got[0]["image"].max()) <= 1.0


def test_chip_smoke_reader_phase_runs_on_the_cpu(capsys):
    """``chip_smoke.py``'s phase 8, every check in it, at a small size on
    the CPU (the card runs the same code at 60,000 rows)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg = dict(chip_smoke.READER, rows=2000, mix_draws=300, dlrm_steps=3, inmem_epochs=2)
    chip_smoke.reader_phase("cpu", cfg, "cpu")
    out = capsys.readouterr().out
    assert "rows=2000 (each of those row groups' rows once)" in out
    assert "every item a cache hit, images bit-equal" in out
    assert "equal to the host replay" in out
