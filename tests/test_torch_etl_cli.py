"""The port's three ETL CLIs against the JAX package's, through ``main(argv)``.

- ``metadata_util``: the same printed lines as the JAX CLI for
  ``--schema``, ``--index``, ``--print-values`` and ``--skip-index`` on the
  same store (with a ``FieldNotNullIndexer`` in it, where the JAX CLI
  raises AttributeError, the port prints the indexer's row groups);
- ``petastorm_generate_metadata``: regeneration restores a deleted
  ``_common_metadata`` byte for byte from a named Unischema, infers one
  when none is named (the same file as the JAX CLI writes), and keeps a
  stored schema;
- ``copy_dataset``: a field subset, a not-null filter and a re-split into
  files give the JAX tool's store byte for byte; a non-empty target is
  refused unless overwritten; ``storage_options``, ``hdfs_driver``, a Spark
  session (``copy_dataset``) and ``filesystem`` (the metadata CLI) give the
  JAX files.

Each test writes its own stores under ``tmp_path`` (the factories'
``TestSchema`` store, 30 rows in 3 row groups, byte-equal in both
packages). Everything is compared exactly.
"""

import hashlib
import os
import shutil

import pytest

from petastorm_tpu.etl import metadata_util as jax_metadata_util
from petastorm_tpu.etl import petastorm_generate_metadata as jax_generate
from petastorm_tpu.test_util import dataset_factory as jax_factory
from petastorm_tpu.tools import copy_dataset as jax_copy
from petastorm_tpu_torch.etl import metadata_util, petastorm_generate_metadata
from petastorm_tpu_torch.test_util import dataset_factory
from petastorm_tpu_torch.tools import copy_dataset


def _digests(directory):
    return {name: hashlib.md5(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))}


def _stores(tmp_path):
    """The factories' store written by each package: ``{package: path}``."""
    paths = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    dataset_factory.create_test_dataset(f"file://{paths['port']}")
    jax_factory.create_test_dataset(f"file://{paths['jax']}")
    assert _digests(paths["port"]) == _digests(paths["jax"])
    return paths


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flags", [[], ["--schema"], ["--index"], ["--index", "--print-values"],
                                   ["--schema", "--index", "--print-values", "--skip-index",
                                    "by_sensor"]])
def test_metadata_util_prints_the_jax_lines(tmp_path, capsys, flags):
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index

    url = f"file://{_stores(tmp_path)['port']}"
    build_rowgroup_index(url, [SingleFieldIndexer("by_sensor", "sensor_name"),
                               SingleFieldIndexer("by_partition", "partition_key")])
    port = _run(metadata_util.main, [url] + flags, capsys)
    assert port == _run(jax_metadata_util.main, [url] + flags, capsys)
    assert port[:2] == [f"Dataset: {url}", "Files: 1  Row groups: 3  Rows: 30"]
    if "--schema" in flags:
        assert "Unischema: TestSchema" in port and len([l for l in port if "dtype=" in l]) == 11
    if "--print-values" in flags:
        assert "    'p_1' -> [0, 1, 2]" in port


def test_metadata_util_without_schema_or_index(tmp_path, capsys):
    url = f"file://{tmp_path}/plain"
    dataset_factory.create_test_scalar_dataset(url)
    port = _run(metadata_util.main, [url, "--schema", "--index"], capsys)
    jax = _run(jax_metadata_util.main, [url, "--schema", "--index"], capsys)
    # The same lines, bar the hint: the port's CLIs are ``python -m`` entry points.
    assert len(port) == len(jax) and port[:3] + port[4:] == jax[:3] + jax[4:]
    assert port[3].split("(not a petastorm dataset?)")[0] == \
        jax[3].split("(not a petastorm dataset?)")[0]
    assert "python -m petastorm_tpu_torch.etl.petastorm_generate_metadata" in port[3]


def test_metadata_util_prints_a_not_null_index(tmp_path, capsys):
    from petastorm_tpu_torch.etl.rowgroup_indexers import FieldNotNullIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index

    url = f"file://{tmp_path}/store"
    dataset_factory.create_test_dataset(url, rows_count=40, rows_per_row_group=5)
    build_rowgroup_index(url, [FieldNotNullIndexer("nullable", "matrix_nullable")])
    lines = _run(metadata_util.main, [url, "--index", "--print-values"], capsys)
    assert lines[-1] == ("  nullable: columns=['matrix_nullable'], "
                         "row_groups=[0, 1, 2, 3, 4, 5, 6, 7]")
    with pytest.raises(AttributeError):  # the JAX CLI's known fault on this index
        jax_metadata_util.main([url, "--index"])


@pytest.mark.parametrize("how", ["named", "inferred", "stored"])
def test_generate_metadata_regenerates_like_jax(tmp_path, capsys, how):
    paths = _stores(tmp_path)
    original = _digests(paths["port"])["_common_metadata"]
    argv = {"named": ["--unischema-class",
                      "petastorm_tpu_torch.test_util.dataset_factory.TestSchema"],
            "inferred": [], "stored": []}[how]
    jax_argv = [a.replace("petastorm_tpu_torch", "petastorm_tpu") for a in argv]
    if how != "stored":
        for path in paths.values():
            os.remove(os.path.join(path, "_common_metadata"))
    url = f"file://{paths['port']}"
    assert _run(petastorm_generate_metadata.main, [url] + argv, capsys) == \
        [f"Metadata written for {url}"]
    _run(jax_generate.main, [f"file://{paths['jax']}"] + jax_argv, capsys)
    port, jax = _digests(paths["port"]), _digests(paths["jax"])
    assert port == jax
    assert (port["_common_metadata"] == original) == (how != "inferred")
    from petastorm_tpu_torch.etl.metadata import get_schema_from_dataset_url

    schema = get_schema_from_dataset_url(url)
    if how == "inferred":
        assert schema._name == "inferred_schema" and len(schema.fields) == 11
    else:
        assert schema == dataset_factory.TestSchema


def test_generate_metadata_refusals(tmp_path):
    """``hdfs_driver``, ``storage_options`` and ``filesystem`` regenerate a
    deleted ``_common_metadata`` byte for byte as the JAX package does."""
    import pyarrow.fs as pafs

    paths = _stores(tmp_path)
    for kwargs in ({"hdfs_driver": "libhdfs3"}, {"storage_options": {"anon": True}},
                   {"filesystem": pafs.LocalFileSystem()}):
        for path in paths.values():
            os.remove(os.path.join(path, "_common_metadata"))
        petastorm_generate_metadata.generate_petastorm_metadata(
            f"file://{paths['port']}", unischema_class=dataset_factory.TestSchema, **kwargs)
        jax_generate.generate_petastorm_metadata(
            f"file://{paths['jax']}", unischema_class=jax_factory.TestSchema, **kwargs)
        assert _digests(paths["port"]) == _digests(paths["jax"])
        assert "_common_metadata" in _digests(paths["port"])


@pytest.mark.parametrize("args", [
    dict(field_regex=["id", "image_png", "matrix_nullable"],
         not_null_fields=["matrix_nullable"], partitions_count=2),
    dict(field_regex=["id.*", "decimal"], rows_per_row_group=4),
    dict(row_group_size_mb=1),
])
def test_copy_dataset_is_byte_identical_to_jax(tmp_path, args):
    paths = _stores(tmp_path)
    copy_dataset.copy_dataset(None, f"file://{paths['port']}", f"file://{tmp_path}/port_copy",
                              **args)
    jax_copy.copy_dataset(None, f"file://{paths['jax']}", f"file://{tmp_path}/jax_copy", **args)
    port = _digests(tmp_path / "port_copy")
    assert port == _digests(tmp_path / "jax_copy")
    from petastorm_tpu_torch.reader.reader import make_reader

    with make_reader(f"file://{tmp_path}/port_copy", reader_pool_type="dummy",
                     shuffle_row_groups=False) as reader:
        rows = [r._asdict() for r in reader]
    if "not_null_fields" in args:
        assert len(port) == 3  # two files and _common_metadata
        assert [r["id"] for r in rows] == [i for i in range(30) if i % 3]
        assert all(r["matrix_nullable"] is not None for r in rows)
    assert list(rows[0]) == list(reader.schema.fields)


def test_copy_dataset_cli_and_target_refusal(tmp_path, capsys):
    paths = _stores(tmp_path)
    source, target = f"file://{paths['port']}", f"file://{tmp_path}/copy"
    argv = [source, target, "--field-regex", "id", "string_value", "--partitions-count", "3"]
    assert _run(copy_dataset.main, argv, capsys) == [f"Copied {source} -> {target}"]
    first = _digests(tmp_path / "copy")
    assert len(first) == 4
    with pytest.raises(ValueError, match="is not empty"):
        copy_dataset.main(argv)
    shutil.rmtree(tmp_path / "copy")
    os.makedirs(tmp_path / "copy")  # an empty target is not refused
    _run(copy_dataset.main, argv, capsys)
    _run(copy_dataset.main, argv + ["--overwrite-output"], capsys)
    assert _digests(tmp_path / "copy") == first


@pytest.mark.parametrize("kwargs,name", [({"spark": object()}, "spark"),
                                         ({"storage_options": {"anon": True}},
                                          "storage_options"),
                                         ({"hdfs_driver": "libhdfs3"}, "hdfs_driver")])
def test_copy_dataset_refusals(tmp_path, kwargs, name):
    """A Spark session (taken and unused), ``storage_options`` and
    ``hdfs_driver`` copy the JAX tool's store byte for byte."""
    kwargs = dict(kwargs)
    spark = kwargs.pop("spark", None)
    paths = _stores(tmp_path)
    args = dict(field_regex=["id.*", "decimal"], rows_per_row_group=4, **kwargs)
    copy_dataset.copy_dataset(spark, f"file://{paths['port']}", f"file://{tmp_path}/port_copy",
                              **args)
    jax_copy.copy_dataset(spark, f"file://{paths['jax']}", f"file://{tmp_path}/jax_copy", **args)
    assert _digests(tmp_path / "port_copy") == _digests(tmp_path / "jax_copy")
