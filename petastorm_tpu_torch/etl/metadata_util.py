"""Print a dataset's metadata: files, row groups and rows, the Unischema,
the row-group indexes (the port's own copy of
``petastorm_tpu/etl/metadata_util.py``, with the same output lines).

Run: ``python -m petastorm_tpu_torch.etl.metadata_util URL [--schema]
[--index] [--print-values] [--skip-index NAME ...]``.
"""

from __future__ import annotations

import argparse
import sys

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.etl import metadata as etl_metadata
from petastorm_tpu_torch.fs_utils import FilesystemResolver


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Print schema / row-group / index info for a dataset")
    parser.add_argument("dataset_url")
    parser.add_argument("--schema", action="store_true", help="print the Unischema fields")
    parser.add_argument("--index", action="store_true", help="print rowgroup index summary")
    parser.add_argument("--print-values", action="store_true",
                        help="with --index: print indexed values")
    parser.add_argument("--skip-index", nargs="*", default=[], help="index names to omit")
    args = parser.parse_args(argv)

    resolver = FilesystemResolver(args.dataset_url)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    pieces = etl_metadata.load_row_groups(fs, path)
    counts = [p.num_rows for p in pieces]
    rows = sum(counts) if all(c is not None for c in counts) else "unknown"
    print(f"Dataset: {args.dataset_url}")
    print(f"Files: {len({p.path for p in pieces})}  Row groups: {len(pieces)}  Rows: {rows}")

    if args.schema:
        try:
            schema = etl_metadata.get_schema(fs, path)
        except PetastormMetadataError as exc:
            print(f"\nNo Unischema metadata: {exc}")
        else:
            print(f"\nUnischema: {schema._name}")
            for name, field in schema.fields.items():
                codec = type(field.codec).__name__ if field.codec else None
                print(f"  {name}: dtype={field.numpy_dtype}, shape={field.shape}, "
                      f"codec={codec}, nullable={field.nullable}")

    if args.index:
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes

        try:
            indexes = get_row_group_indexes(fs, path)
        except PetastormMetadataError as exc:
            print(f"\nNo rowgroup index: {exc}")
            return 0
        print("\nRowgroup indexes:")
        for name, indexer in indexes.items():
            if name in args.skip_index:
                continue
            if not hasattr(indexer, "indexed_values"):
                # A FieldNotNullIndexer keeps row groups only (the JAX CLI
                # raises AttributeError on it).
                print(f"  {name}: columns={indexer.column_names}, "
                      f"row_groups={sorted(indexer.get_row_group_indexes())}")
                continue
            print(f"  {name}: columns={indexer.column_names}, "
                  f"values={len(indexer.indexed_values)}")
            if args.print_values:
                for value in indexer.indexed_values:
                    print(f"    {value!r} -> {sorted(indexer.get_row_group_indexes(value))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
