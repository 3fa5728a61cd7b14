"""The port's failpoints (``petastorm_tpu_torch/failpoints.py``) against the
JAX package's: for seeds and point sets drawn by hypothesis, the same
sequence of ``check`` / ``fire`` / ``poison_piece`` calls takes the same
actions (and raises the same errors) in both; explicit ``fires`` and
``targets`` pin the same calls; ``arm`` / ``disarm`` / ``armed`` are
scoped and move ``petastorm_failpoint_armed``. Exact comparison
throughout."""

import random

import pytest
from hypothesis import given, settings, strategies as st

from petastorm_tpu import failpoints as jax_fp
from petastorm_tpu_torch import failpoints as port_fp
from petastorm_tpu_torch.telemetry import metrics as port_metrics


@pytest.fixture(autouse=True)
def _port_schedule_leak_guard():
    """Fail a test that leaves the port's schedule armed (the shared leak
    guard watches the JAX package's only)."""
    yield
    leaked = port_fp.ACTIVE
    if leaked is not None:
        port_fp.disarm()
        pytest.fail("a port FaultSchedule outlived its test: use failpoints.armed(...)")


ALL_POINTS = sorted(jax_fp.POINTS)


def _outcome(schedule, call, point, arg):
    """One call's result: its action, or the error it raised."""
    try:
        if call == "check":
            return ("action", schedule.check(point, key=arg))
        if call == "fire":
            return ("action", schedule.fire(point, key=arg))
        return ("poison", schedule.poison_piece(arg))
    except OSError as exc:
        return ("raised", type(exc).__name__, getattr(exc, "errno", None))


def _run(package, seed, points, calls, **kwargs):
    schedule = package.FaultSchedule(seed, points=points, delay_s=0.0, **kwargs)
    outcomes = [_outcome(schedule, *call) for call in calls]
    return outcomes, schedule.log_snapshot(), schedule._fires


def test_the_vocabulary_equals_jax():
    assert port_fp.POINTS == jax_fp.POINTS
    assert port_fp.POISON_POINT == jax_fp.POISON_POINT
    for key, data in ((0, ("fire", "journal.append", 0)), (2**63, "x"), (-5, (1, 2))):
        assert port_fp._fold_in(key, data) == jax_fp._fold_in(key, data)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**40),
       points=st.lists(st.sampled_from(ALL_POINTS), min_size=1, max_size=6, unique=True),
       window=st.integers(min_value=5, max_value=60),
       min_index=st.integers(min_value=0, max_value=4),
       max_fires=st.integers(min_value=1, max_value=4),
       call_seed=st.integers(min_value=0, max_value=2**31))
def test_the_same_calls_take_the_same_actions(seed, points, window, min_index, max_fires,
                                              call_seed):
    rng = random.Random(call_seed)
    calls = []
    for _ in range(150):
        kind = rng.choice(("check", "fire", "fire", "poison"))
        if kind == "poison":
            calls.append(("poison", None, rng.randrange(8)))
        else:
            calls.append((kind, rng.choice(points + ["slow-peer"]), None))
    kwargs = dict(window=window, min_index=min_index, max_fires_per_point=max_fires,
                  poison_pieces=[1, 5])
    port = _run(port_fp, seed, points, calls, **kwargs)
    jax = _run(jax_fp, seed, points, calls, **kwargs)
    assert port == jax


def test_explicit_fires_and_targets_pin_the_same_calls():
    calls = [("fire", "slow-peer", key) for key in ("w0", "w1", "w0", "w1", "w0", "w1")]
    calls += [("check", "dispatcher.reply", None)] * 4
    kwargs = dict(fires={"slow-peer": {0: "delay", 2: "delay"},
                         "dispatcher.reply": {1: "drop"}},
                  targets={"slow-peer": "w1"})
    points = ["slow-peer", "dispatcher.reply"]
    port = _run(port_fp, 3, points, calls, **kwargs)
    assert port == _run(jax_fp, 3, points, calls, **kwargs)
    # Only w1's calls count; its first and third fire.
    assert [o[1] for o in port[0][:6]] == [None, "delay", None, None, None, "delay"]
    assert port[0][7] == ("action", "drop")


def test_unknown_points_are_refused_like_jax():
    for package in (port_fp, jax_fp):
        with pytest.raises(ValueError, match="unknown failpoint"):
            package.FaultSchedule(1, points=["nope"])


def test_arming_is_scoped_and_exclusive():
    gauge = port_metrics.FAILPOINT_ARMED
    assert port_fp.ACTIVE is None and gauge.value == 0
    schedule = port_fp.FaultSchedule(9, points=["journal.append"])
    with port_fp.armed(schedule) as armed:
        assert armed is schedule and port_fp.ACTIVE is schedule and gauge.value == 1
        with pytest.raises(RuntimeError, match="already armed"):
            port_fp.arm(port_fp.FaultSchedule(10))
        assert jax_fp.ACTIVE is None  # the packages arm separately
    assert port_fp.ACTIVE is None and gauge.value == 0
    with pytest.raises(KeyError):
        with port_fp.armed(port_fp.FaultSchedule(11)):
            raise KeyError("the scope disarms on the way out")
    assert port_fp.ACTIVE is None
    assert port_fp.disarm() is None  # idempotent


def test_fires_count_into_the_family():
    counter = port_metrics.FAILPOINT_FIRES.labels("journal.append", "enospc")
    before = counter.value
    schedule = port_fp.FaultSchedule(0, points=["journal.append"],
                                     fires={"journal.append": {0: "enospc", 2: "enospc"}})
    raised = 0
    for _ in range(4):
        try:
            schedule.fire("journal.append")
        except OSError:
            raised += 1
    assert raised == 2 and counter.value - before == 2
    assert schedule.log_snapshot() == [["journal.append", 0, "enospc"],
                                       ["journal.append", 2, "enospc"]]
