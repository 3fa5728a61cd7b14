"""Build and load the row-group index store kept in ``_common_metadata``
(the port's own copy of ``petastorm_tpu/etl/rowgroup_indexing.py``).

The store is ``{index_name: indexer}`` pickled under
:data:`ROWGROUPS_INDEX_KEY`, the key both packages use. It loads through a
restricted unpickler: the indexer classes of this package and of the JAX
package (``petastorm_tpu.etl.rowgroup_indexers``) map to this package's
classes, numpy's scalar machinery and plain builtins are allowed, and any
other class the pickle names is refused without importing its module.
"""

from __future__ import annotations

import io
import pickle
from concurrent.futures import ThreadPoolExecutor

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.etl import rowgroup_indexers
from petastorm_tpu_torch.etl.metadata import (
    add_to_dataset_metadata,
    allowlisted_class,
    get_schema,
    load_row_groups,
    read_dataset_metadata,
)
from petastorm_tpu_torch.fs_utils import FilesystemResolver
from petastorm_tpu_torch.utils import decode_table

ROWGROUPS_INDEX_KEY = b"dataset-toolkit.rowgroups_index.v1"

_INDEXER_MODULES = ("petastorm_tpu_torch.etl.rowgroup_indexers",
                    "petastorm_tpu.etl.rowgroup_indexers")
_INDEXER_CLASSES = ("SingleFieldIndexer", "FieldNotNullIndexer")


class _IndexUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _INDEXER_MODULES and name in _INDEXER_CLASSES:
            return getattr(rowgroup_indexers, name)
        return allowlisted_class(module, name)


def load_index_store(payload):
    """``{index_name: indexer}`` from a pickled index store, through the
    restricted unpickler."""
    return _IndexUnpickler(io.BytesIO(payload)).load()


def build_rowgroup_index(dataset_url, indexers, hdfs_driver="libhdfs",
                         storage_options=None, filesystem=None, workers_count=4):
    """Scan every row group of a petastorm dataset, feed the indexers the
    decoded rows of their columns, and store them in the footer. Returns
    ``{index_name: indexer}``. ``hdfs_driver``, ``storage_options`` and
    ``filesystem`` select the filesystem, as for the readers."""
    resolver = FilesystemResolver(dataset_url, hdfs_driver=hdfs_driver,
                                  storage_options=storage_options, filesystem=filesystem)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    schema = get_schema(fs, path)
    pieces = load_row_groups(fs, path)
    columns = sorted({name for indexer in indexers for name in indexer.column_names})
    missing = [c for c in columns if c not in schema.fields]
    if missing:
        raise ValueError(f"Indexed fields not in schema: {missing}")
    view = schema.create_schema_view([schema.fields[c] for c in columns])

    def read_piece(piece_index):
        table = pieces[piece_index].read(fs, columns=columns)
        return piece_index, decode_table(table, view)

    with ThreadPoolExecutor(max_workers=workers_count) as executor:
        for piece_index, rows in executor.map(read_piece, range(len(pieces))):
            for indexer in indexers:
                indexer.build_index(rows, piece_index)
    index_dict = {indexer.index_name: indexer for indexer in indexers}
    add_to_dataset_metadata(fs, path, ROWGROUPS_INDEX_KEY,
                            pickle.dumps(index_dict, protocol=pickle.HIGHEST_PROTOCOL))
    return index_dict


def get_row_group_indexes(filesystem, dataset_path, metadata=None):
    """The dataset's index store, ``{index_name: indexer}``."""
    if metadata is None:
        metadata = read_dataset_metadata(filesystem, dataset_path)
    if ROWGROUPS_INDEX_KEY not in metadata:
        raise PetastormMetadataError(
            "Dataset has no rowgroup index; build one with build_rowgroup_index")
    return load_index_store(metadata[ROWGROUPS_INDEX_KEY])
