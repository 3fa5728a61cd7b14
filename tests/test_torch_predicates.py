"""The port's row predicates against the JAX package's, on the same numpy
inputs (a seeded ``RandomState``): for every predicate class and every
``ColumnPredicate`` op, built alike in both packages,

- the ``repr`` strings are equal (they key the local-disk cache), nested
  lambdas and frozenset constants included;
- ``do_include`` on each row (null rows included; an exception counts as
  its type), ``do_include_vectorized`` on numpy columns, ``pa_mask`` on an
  Arrow table with nulls, and ``evaluate_predicate_mask`` agree;
- ``in_pseudorandom_split`` splits identically, and the ``ColumnPredicate``
  wire form round-trips across the packages.

Tolerance: none; everything is compared exactly.
"""

import builtins

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu_torch import predicates as port_predicates

N = 64
THRESHOLD = 4


def _data():
    """Row dicts, numpy columns (nulls as NaN / None, as a pandas frame of
    them gives) and an Arrow table of the same values."""
    rng = np.random.RandomState(17)
    x = rng.randint(0, 10, N).astype(np.int64)
    xn = [None if i % 7 == 3 else int(v) for i, v in enumerate(rng.randint(0, 10, N))]
    s = np.array([f"s{v}" for v in rng.randint(0, 5, N)], dtype=object)
    tags = np.empty(N, dtype=object)
    for i in range(N):
        tags[i] = rng.randint(0, 12, rng.randint(0, 4)).astype(np.int64)
    f = rng.rand(N).astype(np.float32)
    rows = [{"x": x[i], "xn": xn[i], "s": s[i], "tags": tags[i], "f": f[i]} for i in range(N)]
    table = pa.table({"x": pa.array(x), "xn": pa.array(xn, pa.int64()), "s": pa.array(list(s)),
                      "f": pa.array(f)})
    columns = {"x": x, "xn": table.column("xn").to_numpy(zero_copy_only=False), "s": s,
               "tags": tags, "f": f}
    return rows, columns, table


ROWS, COLUMNS, TABLE = _data()

COLUMN_CASES = {
    "eq": ("x", 3, None), "ne": ("x", 3, None), "lt": ("x", 5, None), "le": ("xn", 5, None),
    "gt": ("f", 0.5, None), "ge": ("x", 7, None), "in": ("x", [1, 2, 9], None),
    "not-in": ("xn", [0, 4], None), "mod-eq": ("x", 1, 3),
}
assert set(COLUMN_CASES) == set(jax_predicates.COLUMN_PREDICATE_OPS)


def _build(name, m):
    """Predicate ``name`` built with the classes of predicates module ``m``."""
    if name.startswith("column_"):
        op = name[len("column_"):]
        field, value, modulus = COLUMN_CASES[op]
        return m.ColumnPredicate(field, op, value, modulus=modulus)
    cases = {
        "in_set": lambda: m.in_set({3, 1, 8}, "x"),
        "in_set_nulls": lambda: m.in_set({2, 5}, "xn"),
        "in_set_strings": lambda: m.in_set(["s1", "s3"], "s"),
        "in_intersection": lambda: m.in_intersection({2, 7, 11}, "tags"),
        "in_lambda": lambda: m.in_lambda(["x"], lambda v: v["x"] > 2),
        "in_lambda_global": lambda: m.in_lambda(["x"], lambda v: v["x"] < THRESHOLD),
        "in_lambda_state": lambda: m.in_lambda(["x", "s"],
                                               lambda v, st: v["x"] >= st[v["s"]],
                                               {"s0": 1, "s1": 3, "s2": 5, "s3": 7, "s4": 9}),
        "in_lambda_vectorized": lambda: m.in_lambda(["x"], lambda c: c["x"] % 2 == 0,
                                                    vectorized=True),
        "in_lambda_nested_frozenset": lambda: m.in_lambda(
            ["tags"], lambda v: any(t in {1, 4, 6} for t in v["tags"])),
        "in_negate": lambda: m.in_negate(m.in_set({0, 1, 2}, "x")),
        "in_reduce_all": lambda: m.in_reduce([m.in_set({1, 2, 3, 4}, "x"),
                                              m.ColumnPredicate("f", "lt", 0.7)], all),
        "in_reduce_any": lambda: m.in_reduce([m.in_set({9}, "x"),
                                              m.in_set(["s2"], "s")], any),
        "in_reduce_custom": lambda: m.in_reduce([m.in_set({1}, "x"), m.in_set({2}, "x")],
                                                lambda bools: sum(bools) == 1),
        "in_pseudorandom_split_0": lambda: m.in_pseudorandom_split([0.3, 0.7], 0, "x"),
        "in_pseudorandom_split_1": lambda: m.in_pseudorandom_split([0.3, 0.7], 1, "s"),
    }
    return cases[name]()


CASES = [f"column_{op}" for op in COLUMN_CASES] + [
    "in_set", "in_set_nulls", "in_set_strings", "in_intersection", "in_lambda",
    "in_lambda_global", "in_lambda_state", "in_lambda_vectorized",
    "in_lambda_nested_frozenset", "in_negate", "in_reduce_all", "in_reduce_any",
    "in_reduce_custom", "in_pseudorandom_split_0", "in_pseudorandom_split_1"]


def _pair(name):
    return _build(name, port_predicates), _build(name, jax_predicates)


def _outcome(predicate, row):
    try:
        return bool(predicate.do_include({f: row[f] for f in predicate.get_fields()}))
    except Exception as exc:  # noqa: BLE001 - compared by type across packages
        return type(exc).__name__


@pytest.mark.parametrize("name", CASES)
def test_repr_is_the_jax_string(name):
    port, jax = _pair(name)
    assert repr(port) == repr(jax)
    assert "0x" not in repr(port)
    assert port.get_fields() == jax.get_fields()


@pytest.mark.parametrize("name", CASES)
def test_do_include_agrees_row_by_row(name):
    port, jax = _pair(name)
    got = [_outcome(port, row) for row in ROWS]
    assert got == [_outcome(jax, row) for row in ROWS]
    assert any(v is True for v in got) and any(v is False for v in got), got


@pytest.mark.parametrize("name", CASES)
def test_vectorized_forms_agree(name):
    port, jax = _pair(name)
    columns = {f: COLUMNS[f] for f in port.get_fields()}
    got, want = port.do_include_vectorized(columns, N), jax.do_include_vectorized(columns, N)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(np.asarray(got, dtype=bool), np.asarray(want, dtype=bool))
    if all(isinstance(_outcome(jax, row), bool) for row in ROWS):
        mask = port_predicates.evaluate_predicate_mask(port, columns, N)
        assert mask.dtype == bool
        np.testing.assert_array_equal(
            mask, jax_predicates.evaluate_predicate_mask(jax, columns, N))


@pytest.mark.parametrize("op", sorted(COLUMN_CASES))
def test_pa_mask_agrees_on_a_table_with_nulls(op):
    port, jax = _pair(f"column_{op}")
    got, want = port.pa_mask(TABLE), jax.pa_mask(TABLE)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", sorted(COLUMN_CASES))
def test_wire_form_round_trips_across_packages(op):
    port, jax = _pair(f"column_{op}")
    assert port.to_wire() == jax.to_wire()
    assert repr(jax_predicates.ColumnPredicate.from_wire(port.to_wire())) == repr(port)
    assert repr(port_predicates.ColumnPredicate.from_wire(jax.to_wire())) == repr(jax)


def test_pseudorandom_split_is_identical():
    fractions = [0.5, 0.3, 0.2]
    values = list(range(2000)) + [f"key{i}" for i in range(200)] + [b"raw", 3.25]
    for subset in range(3):
        port = port_predicates.in_pseudorandom_split(fractions, subset, "k")
        jax = jax_predicates.in_pseudorandom_split(fractions, subset, "k")
        got = [port.do_include({"k": v}) for v in values]
        assert got == [jax.do_include({"k": v}) for v in values]
    # The subsets partition the values.
    members = [[port_predicates.in_pseudorandom_split(fractions, s, "k").do_include({"k": v})
                for s in range(3)] for v in values]
    assert all(sum(m) == 1 for m in members)


def test_fingerprints_of_separately_compiled_functions_match_jax():
    """Functions compiled twice from one source (nested code objects and a
    frozenset constant in ``co_consts``) fingerprint alike in both
    packages and across compilations; other logic fingerprints apart."""
    src = "fn = lambda v: any(x in {3, 1, 2} for x in [v['x']])"
    namespaces = [{}, {}]
    for ns in namespaces:
        exec(src, ns)  # noqa: S102 - a fixed source string
    reprs = {repr(m.in_lambda(["x"], ns["fn"]))
             for m in (port_predicates, jax_predicates) for ns in namespaces}
    assert len(reprs) == 1 and "0x" not in next(iter(reprs))
    assert port_predicates._func_fingerprint(builtins.all) == \
        jax_predicates._func_fingerprint(builtins.all)
    other = port_predicates.in_lambda(["x"], lambda v: v["x"] < 99)
    assert repr(other) not in reprs


class _Opaque:
    """A picklable object with an address-bearing default repr."""

    def __init__(self, v):
        self.v = v


def test_stable_repr_and_consts_fingerprint_match_jax():
    # (An unpicklable object's repr carries a per-process salt in each
    # package, by design: a cache miss, never an alias.)
    for obj in (None, 3, "s", [1, {2: "b"}], _Opaque(5), frozenset({"a", "b", "c"})):
        assert port_predicates._stable_repr(obj) == jax_predicates._stable_repr(obj)
    code = (lambda v: v in frozenset({"q", "r"})).__code__
    assert port_predicates._consts_fingerprint(code.co_consts) == \
        jax_predicates._consts_fingerprint(code.co_consts)


def test_validation_matches_jax():
    for m in (port_predicates, jax_predicates):
        with pytest.raises(ValueError, match="op must be one of"):
            m.ColumnPredicate("x", "between", 1)
        with pytest.raises(ValueError, match="positive modulus"):
            m.ColumnPredicate("x", "mod-eq", 1)
        with pytest.raises(ValueError, match="modulus only applies"):
            m.ColumnPredicate("x", "eq", 1, modulus=2)
        with pytest.raises(ValueError, match="out of range"):
            m.in_pseudorandom_split([0.5, 0.5], 2, "x")
        with pytest.raises(ValueError, match="sum to"):
            m.in_pseudorandom_split([0.8, 0.8], 0, "x")
        with pytest.raises(ValueError, match="predicate_fields"):
            m.in_lambda("x", len)
        with pytest.raises(ValueError, match="wire form"):
            m.ColumnPredicate.from_wire({"op": "eq"})
