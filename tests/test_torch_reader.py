"""The port's ETL and columnar reader against the JAX package's: datasets
written by either package read identically in the other (byte-identical
token/length arrays, the same row-group set), and seeded shuffling,
num_epochs and sharding plan the same row groups in the same order."""

import numpy as np
import pytest

from examples.long_context_lm.train_lm import generate_corpus as jax_generate_corpus
from petastorm_tpu.etl.metadata import unischema_to_json as jax_unischema_to_json
from petastorm_tpu.reader.reader import make_columnar_reader as jax_reader
from petastorm_tpu.schema.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.schema.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
from petastorm_tpu.schema.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.etl.metadata import load_row_groups, unischema_to_json
from petastorm_tpu_torch.fs_utils import FilesystemResolver
from petastorm_tpu_torch.models.long_context_lm import generate_corpus
from petastorm_tpu_torch.reader.reader import make_columnar_reader
from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

DOCS, MAX_LEN = 300, 24  # 3 row groups of 128 rows (the last one short)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    jax_url = f"file://{root}/jax"
    port_url = f"file://{root}/port"
    jax_generate_corpus(jax_url, docs=DOCS, max_len=MAX_LEN)
    generate_corpus(port_url, docs=DOCS, max_len=MAX_LEN)
    return {"jax": jax_url, "port": port_url}


def _read(factory, url, **kwargs):
    kwargs.setdefault("reader_pool_type", "dummy")
    kwargs.setdefault("shuffle_row_groups", False)
    with factory(url, **kwargs) as reader:
        return [(np.asarray(b.tokens), np.asarray(b.length)) for b in reader]


def _same_batches(a, b):
    assert len(a) == len(b)
    for (tok_a, len_a), (tok_b, len_b) in zip(a, b):
        assert tok_a.dtype == tok_b.dtype and len_a.dtype == len_b.dtype
        assert tok_a.tobytes() == tok_b.tobytes()
        assert len_a.tobytes() == len_b.tobytes()


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_both_readers_read_both_writers_identically(corpora, written_by):
    url = corpora[written_by]
    port = _read(make_columnar_reader, url)
    jax = _read(jax_reader, url)
    _same_batches(port, jax)
    assert sum(len(lengths) for _, lengths in port) == DOCS


def test_writers_produce_the_same_rows_and_row_groups(corpora):
    _same_batches(_read(make_columnar_reader, corpora["port"]),
                  _read(make_columnar_reader, corpora["jax"]))
    plans = []
    for url in corpora.values():
        resolver = FilesystemResolver(url)
        base = resolver.get_dataset_path()
        plans.append([(p.path[len(base):], p.row_group, p.num_rows)
                      for p in load_row_groups(resolver.filesystem(), base)])
    assert plans[0] == plans[1]
    assert [rows for _, _, rows in plans[0]] == [128, 128, 44]


def test_schema_json_is_identical():
    port = Unischema("S", [
        UnischemaField("tokens", np.int32, (7,), NdarrayCodec(), False),
        UnischemaField("length", np.int32, (), ScalarCodec(), False),
        UnischemaField("score", np.float32, (), None, True),
    ])
    jax = JaxUnischema("S", [
        JaxField("tokens", np.int32, (7,), JaxNdarrayCodec(), False),
        JaxField("length", np.int32, (), JaxScalarCodec(), False),
        JaxField("score", np.float32, (), None, True),
    ])
    assert unischema_to_json(port) == jax_unischema_to_json(jax)
    assert port.as_arrow_schema() == jax.as_arrow_schema()


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_shuffle_orders_row_groups_as_jax(corpora, seed):
    kwargs = dict(shuffle_row_groups=True, shard_seed=seed, num_epochs=3)
    _same_batches(_read(make_columnar_reader, corpora["port"], **kwargs),
                  _read(jax_reader, corpora["port"], **kwargs))


def test_num_epochs_repeats_every_row_group(corpora):
    batches = _read(make_columnar_reader, corpora["port"], num_epochs=2)
    assert len(batches) == 6
    _same_batches(batches[:3], batches[3:])


@pytest.mark.parametrize("shard_seed", [None, 3])
def test_shards_are_disjoint_and_match_jax(corpora, shard_seed):
    url = corpora["port"]
    seen = []
    for shard in range(2):
        kwargs = dict(cur_shard=shard, shard_count=2, shard_seed=shard_seed)
        port = _read(make_columnar_reader, url, **kwargs)
        _same_batches(port, _read(jax_reader, url, **kwargs))
        seen.extend(t.tobytes() for tokens, _ in port for t in tokens)
    assert len(seen) == len(set(seen)) == DOCS


def test_thread_pool_delivers_every_row_group(corpora):
    batches = _read(make_columnar_reader, corpora["port"],
                    reader_pool_type="thread", workers_count=3, num_epochs=2)
    assert sorted(len(lengths) for _, lengths in batches) == [44, 44, 128, 128, 128, 128]


def test_unsupported_pool_type_raises(corpora):
    """An unknown pool name raises; the process pool delivers every row
    group, as the thread pool does."""
    with pytest.raises(ValueError, match="reader_pool_type"):
        make_columnar_reader(corpora["port"], reader_pool_type="processes")
    batches = _read(make_columnar_reader, corpora["port"],
                    reader_pool_type="process", workers_count=2, num_epochs=2)
    assert sorted(len(lengths) for _, lengths in batches) == [44, 44, 128, 128, 128, 128]


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.int32),
    np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
    np.asfortranarray(np.arange(6, dtype=np.int64).reshape(2, 3)),
], ids=["int32", "float32_2d", "fortran_int64"])
def test_ndarray_codec_bytes_match_jax(value):
    port_field = UnischemaField("x", value.dtype, value.shape, NdarrayCodec(), False)
    jax_field = JaxField("x", value.dtype, value.shape, JaxNdarrayCodec(), False)
    cell = NdarrayCodec().encode(port_field, value)
    assert cell == JaxNdarrayCodec().encode(jax_field, value)
    cells = np.array([cell, cell], dtype=object)
    got = NdarrayCodec().decode_column(port_field, cells)
    want = JaxNdarrayCodec().decode_column(jax_field, cells)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2,) + value.shape
    np.testing.assert_array_equal(NdarrayCodec().decode(port_field, cell), value)


def test_scalar_codec_matches_jax():
    port_field = UnischemaField("n", np.int32, (), ScalarCodec(), True)
    jax_field = JaxField("n", np.int32, (), JaxScalarCodec(), True)
    assert ScalarCodec().encode(port_field, np.int32(7)) == \
        JaxScalarCodec().encode(jax_field, np.int32(7))
    for cells in (np.array([1.0, 2.0]), np.array([1.0, np.nan])):
        got = ScalarCodec().decode_column(port_field, cells)
        want = JaxScalarCodec().decode_column(jax_field, cells)
        assert got.dtype == want.dtype and list(got) == list(want)
