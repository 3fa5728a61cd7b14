"""The port's dataset writer against the JAX package's, on the same rows.

- Every write form of ``write_rows`` (rows or megabytes per row group,
  files capped in rows, each compression, file names, parallel encoding, a
  generator, a nullable field left out) inside ``materialize_dataset(None,
  ...)``: each package writes the same rows (made from a numpy seed) and
  every file — the data files and ``_common_metadata`` — must be
  byte-identical; each package then reads the other's store row for row.
- ``encode_workers > 1`` is byte-equal to ``encode_workers=1``.
- The reference call forms run (no TypeError), a positional 4th argument
  of ``write_rows`` means megabytes in both; ``storage_options``,
  ``filesystem``, ``filesystem_factory``, ``hdfs_driver`` and a Spark
  session write the JAX writer's files, and the session sees the JAX
  writer's Hadoop conf calls.
- ``get_schema`` in both call forms and ``infer_or_load_unischema``
  (stored and inferred) equal the JAX results field by field; the
  Unischema's equality, hash, repr and ``insert_explicit_nulls`` match.

Tolerance: none; everything here is compared exactly.
"""

import hashlib
import os
from decimal import Decimal

import numpy as np
import pyarrow.fs as pafs
import pytest

from petastorm_tpu.etl import metadata as jax_metadata
from petastorm_tpu.schema import codecs as jax_codecs
from petastorm_tpu.schema import unischema as jax_unischema
from petastorm_tpu_torch.etl import metadata
from petastorm_tpu_torch.schema import codecs
from petastorm_tpu_torch.schema import unischema
from test_torch_spark_shim import _Session

ROWS = 40


def _fields(field_cls, codec_mod, image_shape):
    return [
        field_cls("id", np.int64, (), codec_mod.ScalarCodec(), False),
        field_cls("image", np.uint8, image_shape, codec_mod.CompressedImageCodec("png"), False),
        field_cls("matrix", np.float32, (2, 3), codec_mod.NdarrayCodec(), False),
        field_cls("maybe", np.float64, (2,), codec_mod.CompressedNdarrayCodec(), True),
        field_cls("price", Decimal, (), codec_mod.ScalarCodec(), False),
        field_cls("name", str, (), codec_mod.ScalarCodec(), False),
        field_cls("vec", np.int32, (4,), None, False),
    ]


def _schemas(image_shape=(8, 8, 3)):
    """The same schema in each package: ``(port, jax)``."""
    return (unischema.Unischema("Written", _fields(unischema.UnischemaField, codecs,
                                                    image_shape)),
            jax_unischema.Unischema("Written", _fields(jax_unischema.UnischemaField,
                                                        jax_codecs, image_shape)))


def _rows(count=ROWS, image_shape=(8, 8, 3), seed=0, leave_out_nullable=False):
    """Seeded rows (a generator); ``maybe`` is None on every third row, or
    left out of every row."""
    rng = np.random.RandomState(seed)
    for i in range(count):
        row = {"id": i, "image": rng.randint(0, 256, image_shape, dtype=np.uint8),
               "matrix": rng.rand(2, 3).astype(np.float32),
               "maybe": rng.rand(2) if i % 3 else None,
               "price": Decimal(f"{i}.{i % 7}5"), "name": f"row {i}",
               "vec": rng.randint(-50, 50, 4).astype(np.int32)}
        if leave_out_nullable:
            del row["maybe"]
        yield row


# name -> (write_rows kwargs, rows, image shape, row input form, nullable left out)
FORMS = {
    "rows_per_row_group": (dict(rows_per_row_group=7), ROWS, (8, 8, 3), "list", False),
    "row_group_size_mb": (dict(row_group_size_mb=1), 160, (48, 64, 3), "list", False),
    "rows_per_file": (dict(rows_per_row_group=6, rows_per_file=15), ROWS, (8, 8, 3), "list",
                      False),
    "rows_per_file_alone": (dict(rows_per_file=15), ROWS, (8, 8, 3), "list", False),
    "compression_snappy": (dict(rows_per_row_group=10, compression="snappy"), ROWS, (8, 8, 3),
                           "list", False),
    "compression_zstd": (dict(rows_per_row_group=10, compression="zstd"), ROWS, (8, 8, 3),
                         "list", False),
    "compression_none": (dict(rows_per_row_group=10, compression="none"), ROWS, (8, 8, 3),
                         "list", False),
    "basename_template": (dict(rows_per_row_group=10, rows_per_file=20,
                               basename_template="shard-{:03d}.parquet"), ROWS, (8, 8, 3),
                          "list", False),
    "encode_workers_1": (dict(rows_per_row_group=3, encode_workers=1), ROWS, (8, 8, 3), "list",
                         False),
    "encode_workers_4": (dict(rows_per_row_group=3, encode_workers=4), ROWS, (8, 8, 3), "list",
                         False),
    "generator": (dict(rows_per_row_group=9), ROWS, (8, 8, 3), "generator", False),
    "nullable_left_out": (dict(rows_per_row_group=10), ROWS, (8, 8, 3), "list", True),
}

#: Files written where not one: groups never span files, and a file closes
#: at the first group boundary at or past ``rows_per_file``.
FILES = {"rows_per_file": 3, "rows_per_file_alone": 3, "basename_template": 2}


def _write(package, url, form):
    kwargs, count, shape, kind, leave_out = FORMS[form]
    port_schema, jax_schema = _schemas(shape)
    rows = _rows(count, shape, leave_out_nullable=leave_out)
    if kind == "list":
        rows = list(rows)
    module, schema = (metadata, port_schema) if package == "port" else (jax_metadata, jax_schema)
    with module.materialize_dataset(None, url, schema):
        written = module.write_rows(url, schema, rows, **kwargs)
    return [os.path.basename(path) for path in written]


def _digests(directory):
    return {name: hashlib.md5(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))}


def _read_rows(make_reader, url):
    with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        return [row._asdict() for row in reader]


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert int(g["id"]) == w["id"] and g["name"] == w["name"] and g["price"] == w["price"]
        for key in ("image", "matrix", "vec"):
            assert g[key].dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], w[key])
        if w.get("maybe") is None:
            assert g["maybe"] is None
        else:
            np.testing.assert_array_equal(g["maybe"], w["maybe"])


@pytest.mark.parametrize("form", list(FORMS))
def test_write_form_is_byte_identical_and_reads_across(tmp_path, form):
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu_torch.reader.reader import make_reader

    names = {p: _write(p, f"file://{tmp_path}/{p}", form) for p in ("port", "jax")}
    assert names["port"] == names["jax"]
    port_files, jax_files = _digests(tmp_path / "port"), _digests(tmp_path / "jax")
    assert "_common_metadata" in port_files
    assert set(names["port"]) | {"_common_metadata"} == set(port_files)
    assert port_files == jax_files

    kwargs, count, shape, _, leave_out = FORMS[form]
    want = list(_rows(count, shape, leave_out_nullable=leave_out))
    _assert_rows_equal(_read_rows(make_reader, f"file://{tmp_path}/jax"), want)
    _assert_rows_equal(_read_rows(jax_make_reader, f"file://{tmp_path}/port"), want)
    groups = metadata.load_row_groups(pafs.LocalFileSystem(), str(tmp_path / "port"))
    sizes = [g.num_rows for g in groups]
    assert sum(sizes) == count
    if form == "row_group_size_mb":
        assert len(sizes) > 1  # the probe split the rows
    assert len(names["port"]) == FILES.get(form, 1)


def test_parallel_encoding_is_byte_equal_to_serial(tmp_path):
    """20 groups against at most 8 in flight: order and bytes held."""
    port_schema, _ = _schemas()
    rows = list(_rows())
    for workers in (1, 4):
        url = f"file://{tmp_path}/w{workers}"
        with metadata.materialize_dataset(None, url, port_schema):
            metadata.write_rows(url, port_schema, rows, rows_per_row_group=2,
                                encode_workers=workers)
    assert _digests(tmp_path / "w1") == _digests(tmp_path / "w4")
    assert len(metadata.load_row_groups(pafs.LocalFileSystem(), str(tmp_path / "w4"))) == 20


def test_reference_call_forms_run_in_the_port(tmp_path):
    """The reference forms: materialize_rows with row_group_size_mb, the
    three-argument materialize_dataset, write_rows with compression, and
    get_schema of a metadata dict, each byte-equal or equal to the JAX
    package's; a positional 4th write_rows argument is megabytes in both."""
    port_schema, jax_schema = _schemas()
    rows = list(_rows())
    for package, module, schema in (("port", metadata, port_schema),
                                    ("jax", jax_metadata, jax_schema)):
        module.materialize_rows(f"file://{tmp_path}/{package}_mb", schema, rows,
                                row_group_size_mb=64)
        with module.materialize_dataset(None, f"file://{tmp_path}/{package}_zstd", schema):
            module.write_rows(f"file://{tmp_path}/{package}_zstd", schema, rows,
                              compression="zstd")
        module.write_rows(f"file://{tmp_path}/{package}_pos", schema, rows, 1)
    for form in ("mb", "zstd", "pos"):
        assert _digests(tmp_path / f"port_{form}") == _digests(tmp_path / f"jax_{form}"), form
    assert len(metadata.load_row_groups(pafs.LocalFileSystem(), str(tmp_path / "port_mb"))) == 1
    fs = pafs.LocalFileSystem()
    port_meta = metadata.read_dataset_metadata(fs, str(tmp_path / "port_mb"))
    jax_meta = jax_metadata.read_dataset_metadata(fs, str(tmp_path / "jax_mb"))
    assert port_meta == jax_meta
    assert _field_keys(metadata.get_schema(port_meta)) == \
        _field_keys(jax_metadata.get_schema(jax_meta)) == _field_keys(port_schema)


def test_megabyte_groups_smaller_than_the_probe(tmp_path):
    """Rows larger than ``row_group_size_mb`` / 64: the port writes groups
    of the probe rule's size (one row here), where the JAX writer's islice
    raises ValueError (a JAX fault the port does not copy)."""
    port_schema, jax_schema = _schemas((512, 512, 3))  # ~790 KB png rows
    rows = list(_rows(3, (512, 512, 3)))
    metadata.write_rows(f"file://{tmp_path}/port", port_schema, rows, row_group_size_mb=1)
    groups = metadata.load_row_groups(pafs.LocalFileSystem(), str(tmp_path / "port"))
    assert [g.num_rows for g in groups] == [1, 1, 1]
    with pytest.raises(ValueError, match="islice"):
        jax_metadata.write_rows(f"file://{tmp_path}/jax", jax_schema, rows, row_group_size_mb=1)


def test_imagenet_example_store_is_byte_identical(tmp_path):
    """The port's copy of the ImageNet example's schema and synthetic rows,
    written as the example writes them (``row_group_size_mb=64``), gives
    the JAX example's store; three rows of the 512 the card writes."""
    from examples.imagenet.generate_petastorm_imagenet import _synthetic_rows
    from examples.imagenet.schema import ImagenetSchema as JaxImagenetSchema
    from petastorm_tpu_torch.models import imagenet

    assert repr(imagenet.ImagenetSchema) == repr(JaxImagenetSchema)
    port_rows, jax_rows = list(imagenet.synthetic_rows(3)), list(_synthetic_rows(3))
    for got, want in zip(port_rows, jax_rows):
        assert got["noun_id"] == want["noun_id"] and got["text"] == want["text"]
        np.testing.assert_array_equal(got["image"], want["image"])
    metadata.materialize_rows(f"file://{tmp_path}/port", imagenet.ImagenetSchema,
                              iter(port_rows), row_group_size_mb=64)
    jax_metadata.materialize_rows(f"file://{tmp_path}/jax", JaxImagenetSchema, iter(jax_rows),
                                  row_group_size_mb=64)
    assert _digests(tmp_path / "port") == _digests(tmp_path / "jax")


def test_a_failed_write_attaches_no_metadata(tmp_path):
    port_schema, jax_schema = _schemas()
    for package, module, schema in (("port", metadata, port_schema),
                                    ("jax", jax_metadata, jax_schema)):
        url = f"file://{tmp_path}/{package}"
        with pytest.raises(RuntimeError, match="interrupted"):
            with module.materialize_dataset(None, url, schema):
                module.write_rows(url, schema, list(_rows(10)), rows_per_row_group=5)
                raise RuntimeError("interrupted")
        assert sorted(os.listdir(tmp_path / package)) == ["part-00000.parquet"]


def test_write_rows_without_rows_raises_like_jax(tmp_path):
    port_schema, jax_schema = _schemas()
    for module, schema in ((metadata, port_schema), (jax_metadata, jax_schema)):
        for kwargs in ({}, {"row_group_size_mb": 1}):
            with pytest.raises(ValueError, match="at least one row"):
                module.write_rows(f"file://{tmp_path}/empty", schema, iter(()), **kwargs)


def _refusals(module, url, schema):
    """The writer's filesystem arguments, each written through ``module``
    (a package's ``etl.metadata``): ten rows in groups of five, or the
    schema read back; with a Spark session, its Hadoop conf calls."""
    fs = pafs.LocalFileSystem()
    rows = list(_rows(10))

    def enter(write_kwargs=None, **kwargs):
        with module.materialize_dataset(kwargs.pop("spark", None), url, schema, **kwargs):
            module.write_rows(url, schema, rows, rows_per_row_group=5, **(write_kwargs or {}))

    def with_session():
        session = _Session({"parquet.block.size": "134217728"})
        enter(spark=session, row_group_size_mb=4)
        return session.calls, session.values

    return {
        "spark": with_session,
        "filesystem_factory": lambda: enter(filesystem_factory=pafs.LocalFileSystem),
        "storage_options": lambda: enter(storage_options={"anon": True}),
        "filesystem": lambda: enter(filesystem=fs),
        "write_rows storage_options": lambda: enter({"storage_options": {"anon": True}}),
        "write_rows filesystem": lambda: enter({"filesystem": fs}),
        "materialize_rows filesystem": lambda: module.materialize_rows(
            url, schema, rows, rows_per_row_group=5, filesystem=fs),
        "get_schema_from_dataset_url hdfs_driver": lambda: (
            enter(), module.get_schema_from_dataset_url(url, hdfs_driver="libhdfs3"))[1],
        "get_schema_from_dataset_url storage_options": lambda: (
            enter(), module.get_schema_from_dataset_url(url, storage_options={"anon": True}))[1],
    }


@pytest.mark.parametrize("case", list(_refusals(metadata, "", None)))
def test_unported_arguments_raise_not_implemented_by_name(tmp_path, case):
    """Every filesystem argument, ``hdfs_driver`` and a Spark session write
    the JAX writer's files byte for byte (or read the same schema back); the
    session sees the JAX writer's Hadoop conf calls and keeps its values."""
    results = {}
    for package, module, schema in (("port", metadata, _schemas()[0]),
                                    ("jax", jax_metadata, _schemas()[1])):
        results[package] = _refusals(module, f"file://{tmp_path}/{package}", schema)[case]()
    assert _digests(tmp_path / "port") == _digests(tmp_path / "jax")
    assert len(_digests(tmp_path / "port")) == 2  # one data file and _common_metadata
    if case.startswith("get_schema"):
        assert _field_keys(results["port"]) == _field_keys(results["jax"])
    if case == "spark":
        assert results["port"] == results["jax"]
        assert results["port"][1] == {"parquet.block.size": "134217728"}


def _field_keys(schema):
    """Each field as comparable plain values, across packages."""
    return [(f.name, unischema._dtype_token(f.numpy_dtype), tuple(f.shape),
             type(f.codec).__name__ if f.codec else None,
             sorted((k, str(v)) for k, v in vars(f.codec).items()) if f.codec else None,
             f.nullable)
            for f in schema.fields.values()]


def test_get_schema_and_inference_equal_jax(tmp_path):
    port_schema, jax_schema = _schemas()
    fs = pafs.LocalFileSystem()
    paths = {}
    for package, module, schema in (("port", metadata, port_schema),
                                    ("jax", jax_metadata, jax_schema)):
        module.materialize_rows(f"file://{tmp_path}/{package}", schema, list(_rows()),
                                rows_per_row_group=10)
        paths[package] = str(tmp_path / package)
    stored = metadata.get_schema(fs, paths["port"])
    assert stored == port_schema and hash(stored) == hash(port_schema)
    assert _field_keys(stored) == _field_keys(jax_metadata.get_schema(fs, paths["jax"]))
    assert _field_keys(metadata.get_schema(metadata.read_dataset_metadata(fs, paths["jax"]))) \
        == _field_keys(stored)
    assert _field_keys(metadata.get_schema_from_dataset_url(f"file://{paths['jax']}")) == \
        _field_keys(stored)
    got, jax_got = (metadata.infer_or_load_unischema(fs, paths["port"]),
                    jax_metadata.infer_or_load_unischema(fs, paths["jax"]))
    assert got[1] is jax_got[1] is True and got[0] == port_schema
    for path in paths.values():
        os.remove(os.path.join(path, "_common_metadata"))
    with pytest.raises(metadata.PetastormMetadataError):
        metadata.get_schema(fs, paths["port"])
    got, jax_got = (metadata.infer_or_load_unischema(fs, paths["port"]),
                    jax_metadata.infer_or_load_unischema(fs, paths["jax"]))
    assert got[1] is jax_got[1] is False
    assert _field_keys(got[0]) == _field_keys(jax_got[0])
    assert repr(got[0]) == repr(jax_got[0])
    assert [f.codec for f in got[0].fields.values()] == [None] * 7


def test_unischema_equality_repr_and_names_match_jax():
    port_a, jax_schema = _schemas()
    port_b = metadata.unischema_from_json(metadata.unischema_to_json(port_a))
    assert port_a == port_b and hash(port_a) == hash(port_b) and port_a is not port_b
    assert port_a != _schemas((4, 4, 3))[0]
    assert repr(port_a) == repr(jax_schema)
    assert port_a.field_names == jax_schema.field_names == tuple(port_a.fields)
    assert unischema.UnischemaField("x", np.int32) == unischema.UnischemaField("x", np.dtype("<i4"))
    assert codecs.CompressedImageCodec("png") == codecs.CompressedImageCodec("png")
    assert codecs.CompressedImageCodec("png") != codecs.CompressedImageCodec("jpeg")


@pytest.mark.parametrize("leave_out", [(), ("maybe",), ("id",)])
def test_insert_explicit_nulls_and_encode_row_match_jax(leave_out):
    port_schema, jax_schema = _schemas()
    row = list(_rows(2))[1]  # row 1 carries a value in the nullable field
    row = {k: v for k, v in row.items() if k not in leave_out}
    if "id" in leave_out:
        for module, schema in ((unischema, port_schema), (jax_unischema, jax_schema)):
            with pytest.raises(ValueError, match="not nullable"):
                module.insert_explicit_nulls(schema, dict(row))
            with pytest.raises(ValueError, match="not nullable"):
                module.encode_row(schema, row)
        return
    before = dict(row)
    port = unischema.encode_row(port_schema, row)
    assert row.keys() == before.keys()  # the caller's dict is untouched
    assert port == jax_unischema.encode_row(jax_schema, row)
    filled = unischema.insert_explicit_nulls(port_schema, dict(row))
    assert list(filled) == list(jax_unischema.insert_explicit_nulls(jax_schema, dict(row)))
    assert ("maybe" in leave_out) == (filled["maybe"] is None)
