"""Row-group indexers (the port's own copy of
``petastorm_tpu/etl/rowgroup_indexers.py``): an indexer maps field values
to the set of canonical row-group ordinals that hold them, and selectors
use it to prune row groups before any I/O.

The attribute layout is the JAX package's, so an index store pickled by
either package loads in the other
(:func:`petastorm_tpu_torch.etl.rowgroup_indexing.get_row_group_indexes`
maps the JAX classes to these).
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class RowGroupIndexerBase(ABC):
    """Builds and serves one value→row-groups index."""

    @property
    @abstractmethod
    def index_name(self):
        ...

    @property
    @abstractmethod
    def column_names(self):
        """Columns this indexer must read while building."""

    @abstractmethod
    def build_index(self, decoded_rows, piece_index):
        """Feed one row group's (decoded) rows during the build pass."""

    @abstractmethod
    def get_row_group_indexes(self, value=None):
        """Set of row-group ordinals for ``value`` (indexer-specific)."""


class SingleFieldIndexer(RowGroupIndexerBase):
    """value-of-field → set of row-group ordinals."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._column_name = index_field
        self._index_data = {}

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._column_name]

    @property
    def indexed_values(self):
        return list(self._index_data.keys())

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            value = row.get(self._column_name)
            if value is None:
                continue
            self._index_data.setdefault(value, set()).add(piece_index)

    def get_row_group_indexes(self, value=None):
        if value is None:
            all_groups = set()
            for groups in self._index_data.values():
                all_groups |= groups
            return all_groups
        return set(self._index_data.get(value, set()))

    def __setstate__(self, state):
        # Tolerate stores written with another attribute layout.
        self.__dict__.update(state)
        self.__dict__.setdefault("_index_data", {})


class FieldNotNullIndexer(RowGroupIndexerBase):
    """Row groups where ``index_field`` has at least one non-null value."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._column_name = index_field
        self._row_groups = set()

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._column_name]

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            if row.get(self._column_name) is not None:
                self._row_groups.add(piece_index)
                return

    def get_row_group_indexes(self, value=None):
        return set(self._row_groups)
