"""Row-level predicates, evaluated in the decode workers before the full
decode (the port's own copy of ``petastorm_tpu/predicates.py``).

Predicates declare the columns they need (:meth:`PredicateBase.get_fields`);
the reader's workers read those columns first, compute a keep-mask, and
read and decode the other columns only for the rows that survive.

``repr(predicate)`` is part of the local-disk cache key and of nothing
else a user sees; it is the JAX package's string, character for character
(the same class names, the same fingerprints of functions and constants),
so a cache directory filled by one package serves the other.
"""

from __future__ import annotations

import hashlib
import re
import uuid
from abc import ABC, abstractmethod


class PredicateBase(ABC):
    """A row filter: which fields it needs + per-row inclusion decision.

    Subclasses define deterministic ``__repr__`` s: the repr is part of the
    disk-cache key (``LocalDiskCache`` persists across runs, so an
    address-bearing default repr would both defeat cache hits and risk
    aliasing different predicates).
    """

    @abstractmethod
    def get_fields(self):
        """Set of field names :meth:`do_include` reads."""

    @abstractmethod
    def do_include(self, values):
        """``values`` maps each field from :meth:`get_fields` to the row's
        value; return True to keep the row."""

    def do_include_vectorized(self, columns, num_rows):
        """Optional columnar evaluation: ``columns`` maps each field to a
        whole numpy column; return a bool mask of ``num_rows``, or ``None``
        to signal "evaluate row by row" (the default). Batch/columnar
        workers try this first — on wide tabular scans the per-row Python
        loop is the predicate cost, not the comparison itself."""
        return None


def _func_fingerprint(func):
    """Stable fingerprint of a callable: qualname + bytecode + consts +
    captured state (closure cells, defaults) digest.

    Closure cells matter: ``lambda v: v['id'] > t`` compiled with ``t=5`` and
    ``t=10`` shares bytecode — only the cell value distinguishes them, and the
    disk-cache key must too."""
    code = getattr(func, "__code__", None)
    if code is None:  # builtins (e.g. all/any) have no __code__
        return getattr(func, "__qualname__", repr(func))
    cells = tuple(_stable_repr(cell.cell_contents)
                  for cell in (func.__closure__ or ()))
    defaults = _stable_repr(getattr(func, "__defaults__", None))
    # Referenced globals by VALUE, not just name: ``lambda v: v > THRESHOLD``
    # must change key when THRESHOLD changes.
    func_globals = getattr(func, "__globals__", {})
    globals_used = tuple(
        (name, _stable_repr(func_globals[name]))
        for name in code.co_names if name in func_globals)
    digest = hashlib.sha256(
        code.co_code + _consts_fingerprint(code.co_consts).encode("utf-8")
        + repr(code.co_names).encode("utf-8")  # attribute/builtin names
        + repr(globals_used).encode("utf-8")
        + repr(cells).encode("utf-8") + defaults.encode("utf-8")
    ).hexdigest()[:16]
    return f"{getattr(func, '__qualname__', '<fn>')}:{digest}"


def _consts_fingerprint(consts):
    """Address-free fingerprint of ``co_consts``. Nested lambdas and
    comprehensions place code objects in co_consts whose repr embeds a memory
    address — recurse into their own code/consts instead, or the persistent
    disk cache misses on every new process."""
    parts = []
    for const in consts:
        if hasattr(const, "co_code"):  # a nested code object
            parts.append(f"code({const.co_name},"
                         f"{const.co_code!r},"
                         f"{_consts_fingerprint(const.co_consts)},"
                         f"{const.co_names!r})")
        elif isinstance(const, frozenset):
            # repr order follows randomized string hashing — sort, or the
            # fingerprint changes per process (`x in {...}` lambdas).
            parts.append("frozenset(" + ",".join(sorted(
                repr(item) for item in const)) + ")")
        else:
            parts.append(repr(const))
    return "(" + ",".join(parts) + ")"


_DEFAULT_OBJECT_REPR = re.compile(r"<.+ at 0x[0-9a-fA-F]+>")

_PROCESS_SALT = uuid.uuid4().hex[:12]


def _stable_repr(obj):
    """repr(), except address-bearing default reprs become content digests.

    ``<Foo object at 0x7f...>`` changes every process — useless (and
    alias-prone, if stripped) in a persistent cache key. Pickle the object
    instead: contents-based, cross-run stable. Unpicklable objects fall back
    to the class name alone (cache misses, never aliases wrong data because
    the rest of the key still distinguishes dataset/row-group/fields)."""
    r = repr(obj)
    if not _DEFAULT_OBJECT_REPR.search(r):
        return r
    import pickle

    try:
        digest = hashlib.sha256(
            pickle.dumps(obj, protocol=4)).hexdigest()[:16]
        return f"<{type(obj).__qualname__} pickle:{digest}>"
    except Exception:
        # Unpicklable: id() distinguishes objects within this process; the
        # per-process salt guarantees a cross-run cache MISS (ids can recur
        # across runs — a miss is safe, an alias serves wrong rows).
        return (f"<{type(obj).__qualname__} "
                f"unpicklable:{id(obj)}:{_PROCESS_SALT}>")


#: The declarative comparison vocabulary of :class:`ColumnPredicate` —
#: every op has a scalar form (``do_include``), a numpy columnar form
#: (``do_include_vectorized``), and a pyarrow-compute form (``pa_mask``),
#: all three bit-equivalent on scalar columns.
COLUMN_PREDICATE_OPS = ("eq", "ne", "lt", "le", "gt", "ge", "in", "not-in",
                        "mod-eq")


class ColumnPredicate(PredicateBase):
    """A declarative single-column row filter that can cross the wire.

    Unlike the ``in_lambda``-family predicates (arbitrary Python — only
    usable in the process that constructed them), a ``ColumnPredicate`` is
    pure data: ``(field, op, value[, modulus])``, so it crosses process
    and package boundaries (:meth:`to_wire` / :meth:`from_wire`, the JAX
    package's wire form) and signs a cache key canonically.

    Ops (see :data:`COLUMN_PREDICATE_OPS`): the six comparisons, ``in`` /
    ``not-in`` (membership in ``value``, a list), and ``mod-eq`` — keep
    rows where ``field % modulus == value`` (the selectivity-dial used by
    predicate-heavy benchmarks and tests).

    All three evaluation forms are provided: per-row ``do_include``,
    columnar ``do_include_vectorized`` (numpy), and ``pa_mask`` (pyarrow
    compute on the raw Arrow table — what the two-phase predicate read
    uses to mask a row group without materializing dropped rows). They
    operate on **stored scalar values**: the reader only takes the
    column-level fast path for scalar-codec fields, where stored and
    decoded values compare identically.
    """

    def __init__(self, field, op, value, modulus=None):
        if op not in COLUMN_PREDICATE_OPS:
            raise ValueError(
                f"op must be one of {COLUMN_PREDICATE_OPS}, got {op!r}")
        if op == "mod-eq":
            if modulus is None or int(modulus) <= 0:
                raise ValueError("op='mod-eq' needs a positive modulus")
            modulus = int(modulus)
        elif modulus is not None:
            raise ValueError(f"modulus only applies to op='mod-eq', "
                             f"not {op!r}")
        if op in ("in", "not-in"):
            value = list(value)
        self._field = str(field)
        self._op = op
        self._value = value
        self._modulus = modulus

    # -- the PredicateBase contract ---------------------------------------

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        v = values[self._field]
        op, want = self._op, self._value
        if op == "eq":
            return v == want
        if op == "ne":
            return v != want
        if op == "lt":
            return v < want
        if op == "le":
            return v <= want
        if op == "gt":
            return v > want
        if op == "ge":
            return v >= want
        if op == "in":
            return v in want
        if op == "not-in":
            return v not in want
        return v % self._modulus == want  # mod-eq

    def do_include_vectorized(self, columns, num_rows):
        import numpy as np

        column = np.asarray(columns[self._field])
        op, want = self._op, self._value
        if op == "eq":
            return column == want
        if op == "ne":
            return column != want
        if op == "lt":
            return column < want
        if op == "le":
            return column <= want
        if op == "gt":
            return column > want
        if op == "ge":
            return column >= want
        if op in ("in", "not-in"):
            mask = np.isin(column, np.asarray(want))
            return ~mask if op == "not-in" else mask
        return column % self._modulus == want  # mod-eq

    # -- the column-level (pyarrow compute) form ---------------------------

    def pa_mask(self, table):
        """Boolean keep-mask over ``table`` (which holds this predicate's
        column), computed with pyarrow compute kernels — no Python-object
        materialization of any row. The two-phase predicate read uses this
        to filter BOTH column reads down to survivors while they are still
        Arrow (dropped rows never decode, never materialize)."""
        import numpy as np
        import pyarrow.compute as pc

        column = table.column(self._field)
        op, want = self._op, self._value
        if op == "eq":
            mask = pc.equal(column, want)
        elif op == "ne":
            mask = pc.not_equal(column, want)
        elif op == "lt":
            mask = pc.less(column, want)
        elif op == "le":
            mask = pc.less_equal(column, want)
        elif op == "gt":
            mask = pc.greater(column, want)
        elif op == "ge":
            mask = pc.greater_equal(column, want)
        elif op in ("in", "not-in"):
            import pyarrow as pa

            mask = pc.is_in(column, value_set=pa.array(want))
            if op == "not-in":
                mask = pc.invert(mask)
        else:  # mod-eq: modulo has no stable pc kernel name across
            # pyarrow versions — evaluate in numpy, same result.
            values = np.asarray(column.to_numpy(zero_copy_only=False))
            return np.asarray(values % self._modulus == want)
        # Null storage values compare to null; a filter mask must be
        # definite — nulls drop, matching the row path's False.
        return np.asarray(mask.combine_chunks().to_numpy(
            zero_copy_only=False) if hasattr(mask, "combine_chunks")
            else mask.to_numpy(zero_copy_only=False)) == True  # noqa: E712

    # -- wire form (stream requests, cache-key ingredient) -----------------

    def to_wire(self):
        """JSON-safe canonical dict — the stream-request field and the
        cache-fingerprint ingredient (stable across processes)."""
        out = {"field": self._field, "op": self._op, "value": self._value}
        if self._modulus is not None:
            out["modulus"] = self._modulus
        return out

    @classmethod
    def from_wire(cls, wire):
        """Reconstruct from :meth:`to_wire` output (validates shape)."""
        if not isinstance(wire, dict) or "field" not in wire \
                or "op" not in wire:
            raise ValueError(
                f"ColumnPredicate wire form must be a dict with "
                f"field/op/value, got {wire!r}")
        return cls(wire["field"], wire["op"], wire.get("value"),
                   modulus=wire.get("modulus"))

    def __repr__(self):
        return (f"ColumnPredicate({self._field!r}, {self._op!r}, "
                f"{self._value!r}, modulus={self._modulus!r})")


class in_set(PredicateBase):
    """Keep rows whose ``predicate_field`` value is in ``inclusion_values``."""

    def __init__(self, inclusion_values, predicate_field):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        return values[self._predicate_field] in self._inclusion_values

    def do_include_vectorized(self, columns, num_rows):
        import numpy as np

        column = np.asarray(columns[self._predicate_field])
        if column.dtype == object:
            # Object cells may be unhashable (lists): np.isin would silently
            # compare elementwise to all-False where the row path raises a
            # loud TypeError — decline and keep the row-path semantics.
            return None
        values = list(self._inclusion_values)
        try:
            values_arr = np.asarray(values)
        except (TypeError, ValueError):
            return None
        if values_arr.dtype == object:
            return None
        # np.isin compares in the promoted dtype; when that promotion turns
        # ints into float64, magnitudes past 2**53 collapse
        # (9007199254740993 -> ...992.0) and the mask matches rows the exact
        # Python comparison of the row path rejects. Both directions are
        # lossy (int column vs float values, float column vs int values) —
        # decline whenever any int on either side exceeds the exact range.
        limit = 2 ** 53
        try:
            # result_type raises DTypePromotionError (a TypeError) for
            # non-promotable pairs (e.g. datetime64 vs float) — decline to
            # the exact row path, same as np.isin failures.
            promoted = np.result_type(column.dtype, values_arr.dtype)
            if promoted.kind == "f":
                if any(isinstance(v, (int, np.integer))
                       and not isinstance(v, bool) and abs(int(v)) > limit
                       for v in values):
                    return None
                if (column.dtype.kind in "iu" and column.size
                        and int(np.abs(column).max()) > limit):
                    return None
            return np.isin(column, values_arr)
        except (TypeError, ValueError):  # exotic value types: row path
            return None

    def __repr__(self):
        return (f"in_set({sorted(map(repr, self._inclusion_values))}, "
                f"{self._predicate_field!r})")


class in_intersection(PredicateBase):
    """Keep rows whose ITERABLE ``predicate_field`` value shares at least
    one element with ``inclusion_values`` — the collection-valued
    counterpart of :class:`in_set` (a tag/category array column: keep the
    row if ANY tag is in the inclusion set): non-empty set intersection. A
    scalar field value degrades to :class:`in_set` membership."""

    def __init__(self, inclusion_values, predicate_field):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        import numpy as np

        value = values[self._predicate_field]
        items = np.asarray(value).ravel().tolist()
        return not self._inclusion_values.isdisjoint(items)

    def __repr__(self):
        return (f"in_intersection("
                f"{sorted(map(repr, self._inclusion_values))}, "
                f"{self._predicate_field!r})")


class in_lambda(PredicateBase):
    """Keep rows for which ``predicate_func(values [, state])`` is truthy.

    ``vectorized=True`` declares that
    ``predicate_func`` operates on whole numpy columns and returns a boolean
    mask — batch/columnar workers then evaluate it in one call instead of
    once per row: ``in_lambda(["x"], lambda cols: cols["x"] % 2 == 0,
    vectorized=True)``. Row readers still call it per row with scalar
    values; a numpy-ufunc-style function works for both.
    """

    def __init__(self, predicate_fields, predicate_func, state_arg=None,
                 vectorized=False):
        if not isinstance(predicate_fields, (list, tuple, set)):
            raise ValueError("predicate_fields must be a list/tuple/set of names")
        self._predicate_fields = set(predicate_fields)
        self._predicate_func = predicate_func
        self._state_arg = state_arg
        self._vectorized = vectorized

    def get_fields(self):
        return set(self._predicate_fields)

    def do_include(self, values):
        if self._state_arg is not None:
            return self._predicate_func(values, self._state_arg)
        return self._predicate_func(values)

    def do_include_vectorized(self, columns, num_rows):
        if not self._vectorized:
            return None
        import numpy as np

        if self._state_arg is not None:
            mask = self._predicate_func(columns, self._state_arg)
        else:
            mask = self._predicate_func(columns)
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (num_rows,):
            raise ValueError(
                f"vectorized predicate_func returned shape {mask.shape}, "
                f"expected ({num_rows},)")
        return mask

    def __repr__(self):
        return (f"in_lambda({sorted(self._predicate_fields)}, "
                f"{_func_fingerprint(self._predicate_func)}, "
                f"{_stable_repr(self._state_arg)}, "
                f"vectorized={self._vectorized})")


class in_negate(PredicateBase):
    """Logical NOT of another predicate."""

    def __init__(self, predicate):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)

    def do_include_vectorized(self, columns, num_rows):
        import numpy as np

        mask = self._predicate.do_include_vectorized(columns, num_rows)
        # asarray: the contract allows any bool-mask sequence (a list would
        # crash unary ~).
        return None if mask is None else ~np.asarray(mask, dtype=bool)

    def __repr__(self):
        return f"in_negate({self._predicate!r})"


class in_reduce(PredicateBase):
    """Combine several predicates with a reduction (``all``/``any``-style).

    ``reduce_func`` receives the list of per-predicate booleans.
    """

    def __init__(self, predicate_list, reduce_func):
        self._predicate_list = list(predicate_list)
        self._reduce_func = reduce_func

    def get_fields(self):
        fields = set()
        for predicate in self._predicate_list:
            fields |= predicate.get_fields()
        return fields

    def do_include(self, values):
        return self._reduce_func(
            [p.do_include(values) for p in self._predicate_list]
        )

    def do_include_vectorized(self, columns, num_rows):
        # Vectorizable only for the all/any builtins (arbitrary reductions
        # see a list of booleans, not arrays).
        import builtins

        import numpy as np

        if self._reduce_func is builtins.all:
            combine = np.logical_and.reduce
        elif self._reduce_func is builtins.any:
            combine = np.logical_or.reduce
        else:
            return None
        if not self._predicate_list:
            return None
        masks = []
        for predicate in self._predicate_list:
            mask = predicate.do_include_vectorized(columns, num_rows)
            if mask is None:  # short-circuit: don't waste the others' work
                return None
            masks.append(mask)
        return combine(masks)

    def __repr__(self):
        return (f"in_reduce({self._predicate_list!r}, "
                f"{_func_fingerprint(self._reduce_func)})")


class in_pseudorandom_split(PredicateBase):
    """Deterministic hash-of-field train/val/test splitting.

    ``fraction_list`` partitions [0, 1); a row belongs to subset ``i`` when
    the normalized md5 hash of its ``predicate_field`` value falls in the
    ``i``-th interval. The same value always lands in the same subset, on any
    host, so the split needs no coordination between ranks.
    """

    def __init__(self, fraction_list, subset_index, predicate_field):
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError(
                f"subset_index {subset_index} out of range for "
                f"{len(fraction_list)} fractions"
            )
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError(f"fractions sum to {sum(fraction_list)} > 1")
        self._fraction_list = list(fraction_list)
        self._subset_index = subset_index
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        value = values[self._predicate_field]
        position = _hash_to_unit_interval(value)
        low = sum(self._fraction_list[: self._subset_index])
        high = low + self._fraction_list[self._subset_index]
        return low <= position < high

    def do_include_vectorized(self, columns, num_rows):
        # md5 itself cannot be numpy-vectorized, but hashing the bare column
        # values skips the per-row dict assembly + dispatch of the row path
        # (the actual cost on wide tabular scans).
        import numpy as np

        column = columns[self._predicate_field]
        low = sum(self._fraction_list[: self._subset_index])
        high = low + self._fraction_list[self._subset_index]
        mask = np.empty(num_rows, dtype=bool)
        for i in range(num_rows):
            position = _hash_to_unit_interval(column[i])
            mask[i] = low <= position < high
        return mask

    def __repr__(self):
        return (f"in_pseudorandom_split({self._fraction_list!r}, "
                f"{self._subset_index!r}, {self._predicate_field!r})")


def evaluate_predicate_mask(predicate, columns, num_rows):
    """Boolean keep-mask for ``num_rows`` rows of ``columns`` (name→array).

    Tries the predicate's columnar fast path (``do_include_vectorized``)
    first; falls back to the per-row ``do_include`` loop. Shared by the
    batch and columnar workers."""
    import numpy as np

    vectorized = predicate.do_include_vectorized(columns, num_rows)
    if vectorized is not None:
        return np.asarray(vectorized, dtype=bool)
    mask = np.empty(num_rows, dtype=bool)
    names = list(columns)
    for i in range(num_rows):
        mask[i] = bool(predicate.do_include(
            {name: columns[name][i] for name in names}))
    return mask


def _hash_to_unit_interval(value):
    if isinstance(value, bytes):
        data = value
    else:
        data = str(value).encode("utf-8")
    digest = hashlib.md5(data).hexdigest()  # noqa: S324 - splitting, not security
    return int(digest, 16) / float(1 << 128)
