"""Copy a petastorm dataset, optionally keeping some fields, dropping rows
with nulls and re-splitting rows into files and row groups (the port's own
copy of ``petastorm_tpu/tools/copy_dataset.py``): rows stream through
:func:`~petastorm_tpu_torch.reader.reader.make_reader` (dummy pool, the
stored order) into :func:`~petastorm_tpu_torch.etl.metadata.materialize_rows`.

Run: ``python -m petastorm_tpu_torch.tools.copy_dataset SOURCE TARGET
[--field-regex RE ...] [--not-null-fields NAME ...] [--overwrite-output]
[--partitions-count N] [--row-group-size-mb MB]``.
"""

from __future__ import annotations

import argparse
import sys

import pyarrow.fs as pafs

from petastorm_tpu_torch.etl import metadata as etl_metadata
from petastorm_tpu_torch.fs_utils import FilesystemResolver
from petastorm_tpu_torch.schema.unischema import match_unischema_fields


def copy_dataset(spark, source_url, target_url, field_regex=None, not_null_fields=None,
                 overwrite_output=False, partitions_count=None, row_group_size_mb=None,
                 rows_per_row_group=None, hdfs_driver="libhdfs", storage_options=None):
    """Copy ``source_url`` to ``target_url``: the fields matching any of
    ``field_regex`` (full-match regexes; all when None), without the rows
    holding a null in one of ``not_null_fields``, into
    ``partitions_count`` files (rows split evenly) of row groups sized by
    ``row_group_size_mb`` or ``rows_per_row_group``. A non-empty target
    raises ValueError unless ``overwrite_output``. ``hdfs_driver`` and
    ``storage_options`` apply to both stores. ``spark`` is taken for the
    JAX package's signature and unused: the copy streams through pyarrow."""
    from petastorm_tpu_torch.reader.reader import make_reader

    target = FilesystemResolver(target_url, hdfs_driver=hdfs_driver,
                                storage_options=storage_options)
    if not overwrite_output:
        try:
            if target.filesystem().get_file_info(pafs.FileSelector(target.get_dataset_path())):
                raise ValueError(f"Target {target_url!r} is not empty; pass "
                                 "overwrite_output=True to overwrite")
        except FileNotFoundError:
            pass

    source = FilesystemResolver(source_url, hdfs_driver=hdfs_driver,
                                storage_options=storage_options)
    source_fs, source_path = source.filesystem(), source.get_dataset_path()
    schema = etl_metadata.get_schema(source_fs, source_path)
    if field_regex:
        subset = match_unischema_fields(schema, field_regex)
        if not subset:
            raise ValueError(f"field_regex {field_regex!r} matched no fields of "
                             f"{list(schema.fields)}")
        schema = schema.create_schema_view(subset)
    not_null = set(not_null_fields or [])
    unknown = not_null - set(schema.fields)
    if unknown:
        raise ValueError(f"not_null_fields not in copied schema: {unknown}")

    reader = make_reader(source_url, schema_fields=list(schema.fields),
                         reader_pool_type="dummy", num_epochs=1, shuffle_row_groups=False,
                         storage_options=storage_options)

    def rows():
        with reader:
            for row in reader:
                row_dict = row._asdict()
                if not any(row_dict[f] is None for f in not_null):
                    yield row_dict

    write_kwargs = {"storage_options": storage_options}
    if row_group_size_mb is not None:
        write_kwargs["row_group_size_mb"] = row_group_size_mb
    if rows_per_row_group is not None:
        write_kwargs["rows_per_row_group"] = rows_per_row_group
    if partitions_count:
        total = sum(etl_metadata.piece_row_counts(
            source_fs, etl_metadata.load_row_groups(source_fs, source_path)).values())
        write_kwargs["rows_per_file"] = max(1, -(-total // partitions_count))
    etl_metadata.materialize_rows(target_url, schema, rows(), **write_kwargs)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Copy a petastorm dataset, optionally subsetting")
    parser.add_argument("source_url")
    parser.add_argument("target_url")
    parser.add_argument("--field-regex", nargs="*", default=None)
    parser.add_argument("--not-null-fields", nargs="*", default=None)
    parser.add_argument("--overwrite-output", action="store_true")
    parser.add_argument("--partitions-count", type=int, default=None)
    parser.add_argument("--row-group-size-mb", type=int, default=None)
    args = parser.parse_args(argv)
    copy_dataset(None, args.source_url, args.target_url, field_regex=args.field_regex,
                 not_null_fields=args.not_null_fields, overwrite_output=args.overwrite_output,
                 partitions_count=args.partitions_count,
                 row_group_size_mb=args.row_group_size_mb)
    print(f"Copied {args.source_url} -> {args.target_url}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
