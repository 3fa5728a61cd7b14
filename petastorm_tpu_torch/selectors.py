"""Row-group selectors: prune row groups through pre-built field indexes
(the port's own copy of ``petastorm_tpu/selectors.py``).

A selector reads the index store that
:func:`petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index`
writes and returns the canonical ordinals of the row groups worth reading,
before any of them is opened. Its ``repr`` goes into the reader's planning
fingerprint, ``repr((filters, rowgroup_selector))``, which a
``resume_state`` must match: it is the JAX package's string, so a state
written by either package resumes in the other.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class RowGroupSelectorBase(ABC):
    """Maps a pre-built rowgroup index store to a set of row-group ordinals."""

    @abstractmethod
    def get_index_names(self):
        """Names of the indexes this selector needs."""

    @abstractmethod
    def select_row_groups(self, index_dict):
        """``index_dict`` maps index name → indexer; return set of row-group
        ordinals to keep."""


class SingleIndexSelector(RowGroupSelectorBase):
    """Row groups containing any of ``values_list`` per one index."""

    def __init__(self, index_name, values_list):
        self._index_name = index_name
        self._values = list(values_list)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        indexer = index_dict.get(self._index_name)
        if indexer is None:
            raise ValueError(f"Dataset has no rowgroup index named {self._index_name!r}")
        row_groups = set()
        for value in self._values:
            row_groups |= indexer.get_row_group_indexes(value)
        return row_groups

    def __repr__(self):
        # Stable (no object address): selectors are part of the resume-state
        # fingerprint (Reader._planning_repr).
        return (f"SingleIndexSelector({self._index_name!r}, "
                f"{self._values!r})")


class IntersectIndexSelector(RowGroupSelectorBase):
    """Row groups selected by ALL of the given single-index selectors."""

    def __init__(self, single_index_selectors):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]

    def select_row_groups(self, index_dict):
        sets = [s.select_row_groups(index_dict) for s in self._selectors]
        return set.intersection(*sets) if sets else set()

    def __repr__(self):
        return f"IntersectIndexSelector({self._selectors!r})"


class UnionIndexSelector(RowGroupSelectorBase):
    """Row groups selected by ANY of the given single-index selectors."""

    def __init__(self, single_index_selectors):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]

    def select_row_groups(self, index_dict):
        result = set()
        for selector in self._selectors:
            result |= selector.select_row_groups(index_dict)
        return result

    def __repr__(self):
        return f"UnionIndexSelector({self._selectors!r})"
