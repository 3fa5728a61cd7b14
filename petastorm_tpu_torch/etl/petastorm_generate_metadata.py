"""(Re)attach petastorm metadata to an existing Parquet dataset (the port's
own copy of ``petastorm_tpu/etl/petastorm_generate_metadata.py``).

The Unischema is, in order: an explicitly named ``module.Class`` (a
Unischema instance), the schema the dataset already stores
(regeneration), or one inferred from the Parquet files' Arrow schema.

Run: ``python -m petastorm_tpu_torch.etl.petastorm_generate_metadata URL
[--unischema-class module.Name] [--use-summary-metadata]``.
"""

from __future__ import annotations

import argparse
import importlib
import sys

from petastorm_tpu_torch.etl import metadata as etl_metadata
from petastorm_tpu_torch.fs_utils import FilesystemResolver


def _load_unischema_by_name(qualified_name):
    module_name, _, attr = qualified_name.rpartition(".")
    if not module_name:
        raise ValueError("--unischema-class must be a fully qualified name "
                         f"(module.ClassName), got {qualified_name!r}")
    return getattr(importlib.import_module(module_name), attr)


def generate_petastorm_metadata(dataset_url, unischema_class=None,
                                use_summary_metadata=False, hdfs_driver="libhdfs",
                                storage_options=None, filesystem=None):
    """Write ``_common_metadata`` (schema and row-group counts) for the
    dataset at ``dataset_url``. ``unischema_class``: a Unischema, or the
    ``module.Name`` of one; None reuses the stored schema or infers one.
    ``use_summary_metadata`` changes nothing on the pyarrow path (as in the
    JAX package). ``hdfs_driver``, ``storage_options`` and ``filesystem``
    select the filesystem, as for the readers."""
    resolver = FilesystemResolver(dataset_url, hdfs_driver=hdfs_driver,
                                  storage_options=storage_options, filesystem=filesystem)
    if unischema_class is not None:
        schema = (_load_unischema_by_name(unischema_class)
                  if isinstance(unischema_class, str) else unischema_class)
    else:
        schema, _ = etl_metadata.infer_or_load_unischema(resolver.filesystem(),
                                                         resolver.get_dataset_path())
    with etl_metadata.materialize_dataset(None, dataset_url, schema,
                                          use_summary_metadata=use_summary_metadata,
                                          storage_options=storage_options,
                                          filesystem=filesystem):
        pass  # the dataset is written; leaving the block attaches the metadata


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Add petastorm metadata to an existing Parquet dataset")
    parser.add_argument("dataset_url")
    parser.add_argument("--unischema-class", default=None,
                        help="fully qualified module.Class of the Unischema "
                             "(default: reuse stored schema or infer)")
    parser.add_argument("--use-summary-metadata", action="store_true")
    args = parser.parse_args(argv)
    generate_petastorm_metadata(args.dataset_url, unischema_class=args.unischema_class,
                                use_summary_metadata=args.use_summary_metadata)
    print(f"Metadata written for {args.dataset_url}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
