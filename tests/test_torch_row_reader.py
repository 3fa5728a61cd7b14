"""``make_reader`` in the port against the JAX package's: over one image
dataset (16x16x3 png images, 96 rows in row groups of 16), written by
either package, both readers yield the same rows in the same order — with
the dummy pool, a seeded ``shuffle_row_groups``, several epochs,
``schema_fields`` (names, regexes, fields), a ``TransformSpec`` and
``cur_shard``/``shard_count`` — and the same post-transform schema. Values
compare exactly."""

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.etl.metadata import materialize_rows as jax_materialize_rows
from petastorm_tpu.reader.reader import make_reader as jax_make_reader
from petastorm_tpu.schema import codecs as jax_codecs
from petastorm_tpu.schema.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
from petastorm_tpu.schema.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.etl.metadata import materialize_rows
from petastorm_tpu_torch.reader.reader import make_reader
from petastorm_tpu_torch.schema import codecs
from petastorm_tpu_torch.schema.transform import TransformSpec, transform_schema
from petastorm_tpu_torch.schema.unischema import (
    Unischema,
    UnischemaField,
    match_unischema_fields,
)

ROWS, GROUP, SHAPE = 96, 16, (16, 16, 3)


def _fields(field_cls, mod):
    return [field_cls("id", np.int64, (), mod.ScalarCodec(), False),
            field_cls("image", np.uint8, SHAPE, mod.CompressedImageCodec("png"), False),
            field_cls("features", np.float32, (4,), mod.NdarrayCodec(), False),
            field_cls("label", np.int32, (), mod.ScalarCodec(), False)]


def _rows():
    rng = np.random.RandomState(4)
    for i in range(ROWS):
        yield {"id": np.int64(i), "image": rng.randint(0, 256, SHAPE, dtype=np.uint8),
               "features": rng.rand(4).astype(np.float32), "label": np.int32(i % 10)}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("rows")
    urls = {"jax": f"file://{root}/jax", "port": f"file://{root}/port"}
    jax_materialize_rows(urls["jax"], JaxUnischema("Img", _fields(JaxField, jax_codecs)),
                         _rows(), rows_per_row_group=GROUP)
    materialize_rows(urls["port"], Unischema("Img", _fields(UnischemaField, codecs)),
                     _rows(), rows_per_row_group=GROUP)
    return urls


def _mean_pixel(row):
    row["mean"] = np.float32(row["image"].mean())
    return row


# name -> (reader kwargs, TransformSpec kwargs or None)
CASES = {
    "plain": (dict(shuffle_row_groups=False), None),
    "seeded_shuffle_2_epochs": (dict(shuffle_row_groups=True, shard_seed=3, num_epochs=2), None),
    "schema_fields_regex": (dict(shuffle_row_groups=False, schema_fields=["image", "lab.*"]), None),
    "transform": (dict(shuffle_row_groups=True, shard_seed=1),
                  dict(func=_mean_pixel, edit_fields=[("mean", np.float32, (), False)],
                       removed_fields=["features"])),
    "transform_selected": (dict(shuffle_row_groups=False, schema_fields=["id", "image"]),
                           dict(func=_mean_pixel, edit_fields=[("mean", np.float32, (), False)],
                                selected_fields=["mean", "id"])),
    "shard_1_of_3": (dict(shuffle_row_groups=True, shard_seed=5, cur_shard=1, shard_count=3),
                     None),
}


def _read(factory, spec_cls, url, reader_kwargs, transform):
    kwargs = dict(reader_kwargs, reader_pool_type="dummy")
    if transform is not None:
        kwargs["transform_spec"] = spec_cls(**transform)
    with factory(url, **kwargs) as reader:
        return list(reader.schema.fields), list(reader)


@pytest.mark.parametrize("written_by", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_match_the_jax_reader(datasets, written_by, case):
    reader_kwargs, transform = CASES[case]
    url = datasets[written_by]
    port_fields, port_rows = _read(make_reader, TransformSpec, url, reader_kwargs, transform)
    jax_fields, jax_rows = _read(jax_make_reader, JaxTransformSpec, url, reader_kwargs,
                                 transform)
    assert port_fields == jax_fields
    assert len(port_rows) == len(jax_rows) > 0
    for got, want in zip(port_rows, jax_rows):
        assert got._fields == want._fields
        for name in want._fields:
            g, w = getattr(got, name), getattr(want, name)
            assert type(g) is type(w) and np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def test_whole_dataset_once_per_epoch_on_the_thread_pool(datasets):
    with make_reader(datasets["port"], reader_pool_type="thread", workers_count=3,
                     num_epochs=2) as reader:
        ids = sorted(int(row.id) for row in reader)
    assert ids == sorted(list(range(ROWS)) * 2)


def test_shards_partition_the_rows(datasets):
    seen = []
    for shard in range(3):
        with make_reader(datasets["port"], reader_pool_type="dummy", cur_shard=shard,
                         shard_count=3, schema_fields=["id"]) as reader:
            seen.extend(int(row.id) for row in reader)
    assert sorted(seen) == list(range(ROWS))


def test_schema_views_and_transform_schema():
    schema = Unischema("Img", _fields(UnischemaField, codecs))
    view = schema.create_schema_view([schema.label, "im.*"])
    assert list(view.fields) == ["image", "label"]  # the schema's order
    assert [f.name for f in match_unischema_fields(schema, ["i.*"])] == ["id", "image"]
    assert match_unischema_fields(schema, ["imag"]) == []  # full match only
    assert schema.resolve_schema_view(None) is schema
    with pytest.raises(ValueError, match="matched no fields"):
        schema.create_schema_view(["nothing"])
    with pytest.raises(ValueError, match="does not belong"):
        schema.create_schema_view([UnischemaField("other", np.int32)])
    spec = TransformSpec(edit_fields=[UnischemaField("label", np.int64),
                                      ("extra", np.float32, (2,), False)],
                         removed_fields=["features"])
    out = transform_schema(schema, spec)
    assert list(out.fields) == ["id", "image", "label", "extra"]
    assert out.label.numpy_dtype == np.int64 and out.extra.shape == (2,)
    with pytest.raises(ValueError, match="only one of"):
        TransformSpec(removed_fields=["a"], selected_fields=["b"])
    with pytest.raises(ValueError, match="not in post-transform schema"):
        transform_schema(schema, TransformSpec(selected_fields=["missing"]))


def test_reader_rejects_unknown_pool(datasets):
    """An unknown pool name raises; the process pool delivers every row."""
    with pytest.raises(ValueError, match="reader_pool_type"):
        make_reader(datasets["port"], reader_pool_type="processes")
    with make_reader(datasets["port"], reader_pool_type="dummy") as reader:
        want = sorted(int(row.id) for row in reader)
    with make_reader(datasets["port"], reader_pool_type="process", workers_count=2) as reader:
        assert sorted(int(row.id) for row in reader) == want


def _decode_table_case(kind):
    """(port field, JAX field, arrow column) of one column kind, nulls in
    the nullable ones."""
    rng = np.random.RandomState(7)
    n = 6
    if kind == "image_with_null":
        dtype, shape, make = np.uint8, (8, 8, 3), lambda m: m.CompressedImageCodec("png")
        values = [None if i == 2 else rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)
                  for i in range(n)]
    elif kind == "ndarray_with_null":
        dtype, shape, make = np.float32, (3,), lambda m: m.NdarrayCodec()
        values = [None if i == 4 else rng.rand(3).astype(np.float32) for i in range(n)]
    elif kind == "int_with_null":
        dtype, shape, make = np.int32, (), lambda m: m.ScalarCodec()
        values = [None if i == 1 else np.int32(i) for i in range(n)]
    elif kind == "string":
        dtype, shape, make = np.str_, (), lambda m: m.ScalarCodec()
        values = [f"row{i}" for i in range(n)]
    elif kind == "codecless_list":
        dtype, shape, make = np.int64, (2,), lambda m: None
        values = [[i, 2 * i] for i in range(n)]
    else:  # codecless_scalar
        dtype, shape, make = np.float64, (), lambda m: None
        values = [float(i) / 3 for i in range(n)]
    port = UnischemaField("col", dtype, shape, make(codecs), True)
    jax = JaxField("col", dtype, shape, make(jax_codecs), True)
    if port.codec is not None:
        values = [None if v is None else port.codec.encode(port, v) for v in values]
    return port, jax, pa.array(values)


@pytest.mark.parametrize("kind", ["image_with_null", "ndarray_with_null", "int_with_null",
                                  "string", "codecless_list", "codecless_scalar"])
def test_decode_table_equals_jax_decode_row(kind):
    """The row worker's column-wise decode gives, value for value and type
    for type, what the JAX package's per-row ``decode_row`` gives."""
    from petastorm_tpu.utils import decode_row as jax_decode_row
    from petastorm_tpu_torch.utils import decode_table

    port, jax, column = _decode_table_case(kind)
    table = pa.table({"col": column, "other": pa.array(range(len(column)))})
    got = decode_table(table, Unischema("S", [port]))
    want = [jax_decode_row(row, JaxUnischema("S", [jax])) for row in table.to_pylist()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["col"]
        if w["col"] is None:
            assert g["col"] is None
        else:
            assert type(g["col"]) is type(w["col"])
            np.testing.assert_array_equal(g["col"], w["col"])
            assert np.asarray(g["col"]).dtype == np.asarray(w["col"]).dtype
