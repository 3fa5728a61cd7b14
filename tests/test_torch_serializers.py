"""The process pool's two serializers against the JAX package's, on the same
inputs: pickle (bytes and protocol-5 frames) and Arrow IPC (bytes and the
one-buffer frame). Each package must read what the other wrote, the bytes
must agree where the format is deterministic, and the work-item tag the
batch worker puts in a table's schema metadata must survive the round trip
(resume and the delivery tracker read it on the consumer's side).

Tolerance: none; everything here is compared exactly.
"""

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.reader_impl.arrow_table_serializer import (
    ArrowTableSerializer as JaxArrowTableSerializer,
)
from petastorm_tpu.reader_impl.pickle_serializer import PickleSerializer as JaxPickleSerializer
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.delivery_tracker import (
    item_key,
    read_table_tag,
    tag_table,
)
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer


def _payloads():
    """Seeded payloads of the shapes the port's workers publish: a row
    worker's ``(item_key, [row dict, ...])`` pair and a columnar worker's
    ``(item_key, {field: [N, ...]})`` pair, with a large array that goes
    out of band as a frame of its own."""
    rng = np.random.RandomState(0)
    rows = [{"id": np.int64(i), "image": rng.randint(0, 256, (8, 8, 3), dtype=np.uint8),
             "name": f"row-{i}", "vec": rng.rand(3).astype(np.float32)} for i in range(4)]
    columns = {"id": np.arange(64, dtype=np.int64),
               "big": rng.rand(512, 257).astype(np.float32),
               "fortran": np.asfortranarray(rng.rand(6, 5)),
               "strings": np.array([f"s{i}" for i in range(64)], dtype=object)}
    return {"rows": (item_key(3, 0), rows), "columns": (item_key(7, 1), columns)}


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("payload", ["rows", "columns"])
def test_pickle_bytes_equal_jax_and_cross_read(payload):
    value = _payloads()[payload]
    port, jax = PickleSerializer(), JaxPickleSerializer()
    data = port.serialize(value)
    assert data == jax.serialize(value)
    _assert_same(port.deserialize(data), value)
    _assert_same(jax.deserialize(data), value)


@pytest.mark.parametrize("wire", ["bytes", "memoryview"])
@pytest.mark.parametrize("payload", ["rows", "columns"])
def test_pickle_frames_equal_jax_and_cross_read(payload, wire):
    value = _payloads()[payload]
    port, jax = PickleSerializer(), JaxPickleSerializer()
    frames = port.serialize_to_frames(value)
    jax_frames = jax.serialize_to_frames(value)
    assert [bytes(f) for f in frames] == [bytes(f) for f in jax_frames]
    if payload == "columns":
        # head + the out-of-band numeric arrays; the big one as its own frame
        assert len(frames) >= 3
        assert any(memoryview(f).nbytes == 512 * 257 * 4 for f in frames[1:])
    received = [bytes(f) if wire == "bytes" else memoryview(bytes(f)) for f in frames]
    _assert_same(port.deserialize_from_frames(received), value)
    _assert_same(jax.deserialize_from_frames(received), value)
    _assert_same(port.deserialize_from_frames([bytes(f) for f in jax_frames]), value)


def _table():
    rng = np.random.RandomState(1)
    table = pa.table({"x": np.arange(1000, dtype=np.int64),
                      "y": pa.array([f"s{i}" if i % 7 else None for i in range(1000)]),
                      "z": rng.rand(1000).astype(np.float32),
                      "l": pa.array([[i, i + 1] for i in range(1000)], pa.list_(pa.int32()))})
    return tag_table(table, item_key(5, 2))


def test_arrow_bytes_equal_jax_and_cross_read():
    table = _table()
    port, jax = ArrowTableSerializer(), JaxArrowTableSerializer()
    data = port.serialize(table)
    assert data == jax.serialize(table)
    for restored in (port.deserialize(data), jax.deserialize(data)):
        assert restored.equals(table, check_metadata=True)
        assert read_table_tag(restored) == "5:2"


@pytest.mark.parametrize("wire", ["bytes", "memoryview", "split"])
def test_arrow_frames_equal_jax_and_keep_the_tag(wire):
    table = _table()
    port, jax = ArrowTableSerializer(), JaxArrowTableSerializer()
    frames = port.serialize_to_frames(table)
    assert len(frames) == 1 and isinstance(frames[0], pa.Buffer)
    assert frames[0].to_pybytes() == jax.serialize_to_frames(table)[0].to_pybytes()
    raw = frames[0].to_pybytes()
    received = {"bytes": [raw], "memoryview": [memoryview(raw)],
                "split": [raw[:100], raw[100:]]}[wire]
    for restored in (port.deserialize_from_frames(received),
                     jax.deserialize_from_frames(received)):
        assert restored.equals(table, check_metadata=True)
        assert read_table_tag(restored) == "5:2"


def test_arrow_serializer_refuses_what_is_not_a_table():
    for serializer in (ArrowTableSerializer(), JaxArrowTableSerializer()):
        with pytest.raises(ValueError, match="pa.Table"):
            serializer.serialize({"x": [1]})
        with pytest.raises(ValueError, match="pa.Table"):
            serializer.serialize_to_frames([1])
