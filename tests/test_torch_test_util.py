"""The port's ``test_util`` package and its last two packing functions
against the JAX package's.

- Each dataset factory writes a store byte-identical to the JAX factory's
  (every file) and returns equal rows.
- ``ReaderMock`` yields the JAX mock's rows, and
  ``make_torch_dataloader(..., device="cpu")`` batches them.
- ``compute_correlation_distance_metric`` equals the JAX metric.
- ``count_packed_batches`` and ``unpack`` equal the JAX functions on the
  same reader arguments; both refuse an endless reader.

Each test writes its own stores under ``tmp_path``. Everything is compared
exactly.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from petastorm_tpu.jax_utils import packing as jax_packing
from petastorm_tpu.test_util import dataset_factory as jax_factory
from petastorm_tpu.test_util import reader_mock as jax_reader_mock
from petastorm_tpu.test_util import shuffling_analysis as jax_shuffling
from petastorm_tpu_torch.test_util import dataset_factory, reader_mock, shuffling_analysis
from petastorm_tpu_torch.torch_utils import packing


def _digests(directory):
    return {name: hashlib.md5(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))}


def _same_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for key in x:
            if isinstance(x[key], np.ndarray):
                np.testing.assert_array_equal(x[key], y[key])
                assert x[key].dtype == y[key].dtype
            else:
                assert x[key] == y[key] and type(x[key]) is type(y[key])


@pytest.mark.parametrize("factory,kwargs", [
    ("create_test_dataset", dict(rows_count=24, rows_per_row_group=5, rows_per_file=10)),
    ("create_test_token_dataset", dict(rows_count=50, rows_per_row_group=8)),
    ("create_test_token_dataset", dict(rows_count=20, max_len=16, skew=1.0)),
    ("create_test_selective_dataset", dict(rows_count=30, payload_shape=(8, 8, 3))),
    ("create_test_scalar_dataset", dict(rows_count=25, rows_per_row_group=7)),
    ("create_test_scalar_dataset", dict(compression="zstd")),
])
def test_factory_store_is_byte_identical_to_jax(tmp_path, factory, kwargs):
    port_rows = getattr(dataset_factory, factory)(f"file://{tmp_path}/port", **kwargs)
    jax_rows = getattr(jax_factory, factory)(f"file://{tmp_path}/jax", **kwargs)
    _same_rows(port_rows, jax_rows)
    port = _digests(tmp_path / "port")
    assert port == _digests(tmp_path / "jax")
    assert ("_common_metadata" in port) == (factory != "create_test_scalar_dataset")


def test_factory_schemas_match_jax():
    for name in ("TestSchema", "TokenSchema", "SelectiveSchema", "ScalarSchema"):
        assert repr(getattr(dataset_factory, name)) == repr(getattr(jax_factory, name))
    assert dataset_factory.TOKEN_MAX_LEN == jax_factory.TOKEN_MAX_LEN
    _same_rows([dataset_factory.make_test_row(7)], [jax_factory.make_test_row(7)])
    _same_rows([dataset_factory.make_selective_row(9)], [jax_factory.make_selective_row(9)])


def _mock_rows(i):
    return {"id": np.int64(i), "vec": np.arange(3, dtype=np.float32) + i, "name": f"r{i}"}


def test_reader_mock_matches_jax_and_feeds_the_loader():
    from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
    from petastorm_tpu.schema.unischema import UnischemaField as JaxField
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    def fields(cls):
        return [cls("id", np.int64, ()), cls("vec", np.float32, (3,)), cls("name", str, ())]

    port = reader_mock.ReaderMock(Unischema("Mock", fields(UnischemaField)), _mock_rows,
                                  num_rows=10)
    jax = jax_reader_mock.ReaderMock(JaxUnischema("Mock", fields(JaxField)), _mock_rows,
                                     num_rows=10)
    _same_rows([r._asdict() for r in port], [r._asdict() for r in jax])
    assert port.last_row_consumed and jax.last_row_consumed
    port.reset()
    with make_torch_dataloader(port, 4, last_batch="keep", device="cpu") as loader:
        batches = list(loader)
    assert [len(b["id"]) for b in batches] == [4, 4, 2]
    assert torch.equal(torch.cat([b["id"] for b in batches]), torch.arange(10))
    assert torch.equal(torch.cat([b["vec"] for b in batches]),
                       torch.arange(3.0)[None] + torch.arange(10.0)[:, None])
    assert [n for b in batches for n in b["name"]] == [f"r{i}" for i in range(10)]
    endless = reader_mock.ReaderMock(port.schema, _mock_rows)
    assert [int(next(endless).id) for _ in range(25)] == list(range(25))


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_correlation_distance_matches_jax(seed):
    ids = np.arange(200) if seed is None else np.random.RandomState(seed).permutation(200)
    got = shuffling_analysis.compute_correlation_distance_metric(ids)
    assert got == jax_shuffling.compute_correlation_distance_metric(ids)
    assert (got == 0.0) == (seed is None)
    assert shuffling_analysis.compute_correlation_distance_metric([5]) == 0.0


@pytest.mark.parametrize("slots,slot_len", [(2, 48), (4, 64), (3, 100)])
def test_count_packed_batches_and_unpack_match_jax(tmp_path, slots, slot_len):
    from petastorm_tpu import make_columnar_reader as jax_make_columnar_reader
    from petastorm_tpu_torch.reader.reader import make_columnar_reader

    url = f"file://{tmp_path}/tokens"
    rows = dataset_factory.create_test_token_dataset(url, rows_count=60, rows_per_row_group=10)
    kwargs = dict(reader_pool_type="dummy", shard_seed=5, num_epochs=1)
    args = dict(slot_len=slot_len, slots=slots, sequence_fields=["tokens"],
                length_field="length")
    count = packing.count_packed_batches(make_columnar_reader(url, **kwargs), **args)
    assert count == jax_packing.count_packed_batches(jax_make_columnar_reader(url, **kwargs),
                                                     **args)
    with make_columnar_reader(url, **kwargs) as reader:
        batches = list(packing.pack_ragged(
            packing.iter_ragged_rows(reader, ["tokens"], "length"),
            slot_len=slot_len, slots=slots))
    assert len(batches) == count
    docs = [d for b in batches for d in packing.unpack(b, "tokens")]
    jax_docs = [d for b in batches for d in jax_packing.unpack(b, "tokens")]
    assert len(docs) == len(jax_docs) == len(rows)
    for got, want in zip(docs, jax_docs):
        np.testing.assert_array_equal(got, want)
    assert sorted(tuple(d.tolist()) for d in docs) == \
        sorted(tuple(r["tokens"][:r["length"]].tolist()) for r in rows)
    # A delivered batch comes back as CPU tensors.
    as_tensors = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    for got, want in zip(packing.unpack(as_tensors, "tokens"), packing.unpack(batches[0],
                                                                               "tokens")):
        np.testing.assert_array_equal(got, want)


def test_count_packed_batches_refuses_an_endless_reader(tmp_path):
    from petastorm_tpu import make_columnar_reader as jax_make_columnar_reader
    from petastorm_tpu_torch.reader.reader import make_columnar_reader

    url = f"file://{tmp_path}/tokens"
    dataset_factory.create_test_token_dataset(url, rows_count=20)
    for make, count in ((make_columnar_reader, packing.count_packed_batches),
                        (jax_make_columnar_reader, jax_packing.count_packed_batches)):
        with make(url, reader_pool_type="dummy", num_epochs=None) as reader:
            with pytest.raises(ValueError, match="never terminate"):
                count(reader, slot_len=48, slots=2, sequence_fields=["tokens"])
