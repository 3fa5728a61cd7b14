"""The port's ``utils.decode_row`` and ``utils.run_in_subprocess`` against
the JAX package's: the same stored rows decode to the same values, value
for value and type for type (nulls, codecs, codec-less lists and scalars,
fields outside the schema); the same call in a spawned child returns the
same result, and a child's error reaches the caller. Tolerance: none."""

import os

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.schema import codecs as jax_codecs
from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
from petastorm_tpu.schema.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.schema import codecs
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField


def _fields():
    """(port field, JAX field, values) of each column kind."""
    rng = np.random.RandomState(11)
    n = 5
    cases = [
        ("image", np.uint8, (6, 6, 3), lambda m: m.CompressedImageCodec("png"),
         [None if i == 1 else rng.randint(0, 256, (6, 6, 3), dtype=np.uint8)
          for i in range(n)]),
        ("matrix", np.float32, (2, 3), lambda m: m.NdarrayCodec(),
         [rng.rand(2, 3).astype(np.float32) for _ in range(n)]),
        ("packed", np.float64, (4,), lambda m: m.CompressedNdarrayCodec(),
         [None if i == 3 else rng.rand(4) for i in range(n)]),
        ("count", np.int32, (), lambda m: m.ScalarCodec(),
         [None if i == 2 else np.int32(i * 7) for i in range(n)]),
        ("name", np.str_, (), lambda m: m.ScalarCodec(), [f"r{i}" for i in range(n)]),
        ("pair", np.int64, (2,), lambda m: None, [[i, -i] for i in range(n)]),
        ("ratio", np.float64, (), lambda m: None, [i / 7 for i in range(n)]),
    ]
    out = []
    for name, dtype, shape, make, values in cases:
        port = UnischemaField(name, dtype, shape, make(codecs), True)
        jax = JaxField(name, dtype, shape, make(jax_codecs), True)
        if port.codec is not None:
            values = [None if v is None else port.codec.encode(port, v) for v in values]
        out.append((port, jax, values))
    return out


def test_decode_row_equals_jax():
    from petastorm_tpu.utils import decode_row as jax_decode_row
    from petastorm_tpu_torch.utils import decode_row

    fields = _fields()
    table = pa.table({port.name: pa.array(values) for port, _, values in fields}
                     | {"not_in_schema": pa.array(range(5))})
    port_schema = Unischema("S", [port for port, _, _ in fields])
    jax_schema = JaxUnischema("S", [jax for _, jax, _ in fields])
    for row in table.to_pylist():
        got, want = decode_row(row, port_schema), jax_decode_row(row, jax_schema)
        assert list(got) == list(want) == [port.name for port, _, _ in fields]
        for name in want:
            if want[name] is None:
                assert got[name] is None, name
                continue
            assert type(got[name]) is type(want[name]), name
            assert np.asarray(got[name]).dtype == np.asarray(want[name]).dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_decode_row_names_the_field_that_fails():
    from petastorm_tpu.utils import DecodeFieldError as JaxDecodeFieldError
    from petastorm_tpu.utils import decode_row as jax_decode_row
    from petastorm_tpu_torch.utils import DecodeFieldError, decode_row

    port, jax, _ = _fields()[1]
    with pytest.raises(DecodeFieldError, match="'matrix'") as port_error:
        decode_row({"matrix": b"not an npy"}, Unischema("S", [port]))
    with pytest.raises(JaxDecodeFieldError) as jax_error:
        jax_decode_row({"matrix": b"not an npy"}, JaxUnischema("S", [jax]))
    assert str(port_error.value).split(":")[0] == str(jax_error.value).split(":")[0]


@pytest.mark.parametrize("func,args,kwargs", [
    (sum, ([1, 2, 3],), {}),
    (int, ("ff",), {"base": 16}),
    (os.path.join, ("a", "b"), {}),
], ids=["sum", "kwargs", "path"])
def test_run_in_subprocess_equals_jax(func, args, kwargs):
    from petastorm_tpu.utils import run_in_subprocess as jax_run
    from petastorm_tpu_torch.utils import run_in_subprocess

    assert run_in_subprocess(func, *args, **kwargs) == jax_run(func, *args, **kwargs) == \
        func(*args, **kwargs)


def test_run_in_subprocess_runs_in_a_child_and_reraises():
    from petastorm_tpu_torch.utils import run_in_subprocess

    assert run_in_subprocess(os.getpid) != os.getpid()
    with pytest.raises(ValueError, match="invalid literal"):
        run_in_subprocess(int, "not a number")
