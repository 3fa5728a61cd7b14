"""The port's resilience layer (``petastorm_tpu_torch/service/
resilience.py``) against the JAX package's: seeded event sequences through
both packages' ``RetryBudget``, ``CircuitBreaker``, ``GapTracker`` and
``BrownoutPlanner`` give equal snapshots, states, thresholds and plans;
deadline propagation under an injected clock; the process-wide brownout
level and the optional stages it sheds (the trace collector, the
autotuner's probes). Exact comparison throughout."""

import numpy as np
import pytest

from petastorm_tpu.service import resilience as jax_res
from petastorm_tpu_torch.service import resilience as port_res


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(4))
def test_retry_budgets_agree(seed):
    rng = np.random.default_rng(seed)
    capacity, refill = float(rng.integers(1, 6)), float(rng.choice([0.25, 0.5, 1.0]))
    budgets = {p: p.RetryBudget(capacity=capacity, refill_per_success=refill)
               for p in (port_res, jax_res)}
    for event in rng.choice(["spend", "spend2", "success"], size=200):
        out = {}
        for package, budget in budgets.items():
            if event == "success":
                out[package] = budget.record_success()
            else:
                out[package] = budget.try_spend(2.0 if event == "spend2" else 1.0)
        assert out[port_res] == out[jax_res]
        assert budgets[port_res].snapshot() == budgets[jax_res].snapshot()
    assert budgets[port_res].denied == budgets[jax_res].denied > 0


@pytest.mark.parametrize("seed", range(4))
def test_circuit_breakers_agree(seed):
    rng = np.random.default_rng(seed)
    threshold, cooldown = int(rng.integers(1, 4)), float(rng.choice([0.5, 1.0, 2.0]))
    breakers = {p: p.CircuitBreaker(threshold=threshold, cooldown_s=cooldown)
                for p in (port_res, jax_res)}
    now, states = 0.0, set()
    for event in rng.choice(["fail", "fail", "ok", "allow", "wait"], size=300):
        now += float(rng.uniform(0.0, 0.6)) if event == "wait" else 0.01
        out = {}
        for package, breaker in breakers.items():
            if event == "fail":
                out[package] = breaker.record_failure(now)
            elif event == "ok":
                out[package] = breaker.record_success(now)
            else:
                out[package] = breaker.allow(now)
        assert out[port_res] == out[jax_res]
        assert breakers[port_res].snapshot() == breakers[jax_res].snapshot()
        assert breakers[port_res].state_code == breakers[jax_res].state_code
        states.add(breakers[port_res].state)
    assert states == {"closed", "open", "half_open"}
    assert port_res.BREAKER_STATE_CODES == jax_res.BREAKER_STATE_CODES


@pytest.mark.parametrize("kwargs", [{}, {"quantile": 0.9, "multiplier": 2.0, "min_samples": 4,
                                         "floor_s": 0.01, "cap_s": 2.0},
                                    {"buckets": (0.001, 0.01, 0.1, 1.0)}],
                         ids=["defaults", "tuned", "coarse-buckets"])
def test_gap_trackers_fit_the_same_thresholds(kwargs):
    rng = np.random.default_rng(5)
    trackers = {p: p.GapTracker(**kwargs) for p in (port_res, jax_res)}
    fitted = []
    for gap in np.concatenate([rng.exponential(0.02, 60), rng.exponential(0.5, 20)]):
        for tracker in trackers.values():
            tracker.observe(float(gap))
        fitted.append(trackers[port_res].threshold_s())
        assert fitted[-1] == trackers[jax_res].threshold_s()
        assert trackers[port_res].count == trackers[jax_res].count
    assert fitted[0] is None and fitted[-1] is not None
    for package in (port_res, jax_res):
        with pytest.raises(ValueError):
            package.GapTracker(quantile=0.0)


@pytest.mark.parametrize("config", [None, {"up_windows": 2, "down_windows": 4,
                                           "cooldown_windows": 0, "max_level": 2},
                                    {"enter_credit_wait_s": 0.1, "exit_fraction": 0.8,
                                     "max_level": 1}],
                         ids=["defaults", "asymmetric", "one-level"])
def test_brownout_planners_agree(config):
    rng = np.random.default_rng(11)
    planners = {p: p.BrownoutPlanner(p.BrownoutConfig.coerce(config) if config else None)
                for p in (port_res, jax_res)}
    level, decisions = 0, []
    for _ in range(300):
        signals = {"level": level, "credit_wait_rate": float(rng.choice([0.0, 0.2, 0.7, 1.5])),
                   "ready_saturation": float(rng.choice([0.0, 0.3, 0.95]))}
        plans = {p: planner.plan(dict(signals)) for p, planner in planners.items()}
        assert plans[port_res] == plans[jax_res]
        for decision in plans[port_res]:
            level = decision["level"]
            decisions.append(decision["action"])
    assert {"shed", "recover"} <= set(decisions)
    for package in (port_res, jax_res):
        with pytest.raises(TypeError):
            package.BrownoutConfig.coerce("loud")
        with pytest.raises(ValueError):
            package.BrownoutConfig(exit_fraction=1.5)


def test_deadlines_under_an_injected_clock():
    clock = FakeClock()
    header = port_res.attach_deadline({}, 102.5, clock=clock)
    assert header == jax_res.attach_deadline({}, 102.5, clock=clock) == {
        "deadline_left_s": 2.5}
    assert port_res.attach_deadline({}, None, clock=clock) == {}
    assert port_res.attach_deadline({}, 99.0, clock=clock) == {"deadline_left_s": 0.0}
    clock.t = 200.0
    arrival = port_res.arrival_deadline(header, clock=clock)
    assert arrival == jax_res.arrival_deadline(header, clock=clock) == 202.5
    for bad in ({}, {"deadline_left_s": "soon"}, {"deadline_left_s": None}):
        assert port_res.arrival_deadline(bad, clock=clock) is None
    assert not port_res.deadline_expired(arrival, clock=clock)
    clock.t = 202.5
    assert port_res.deadline_expired(arrival, clock=clock)
    assert not port_res.deadline_expired(None, clock=clock)
    from petastorm_tpu_torch.telemetry.metrics import RESILIENCE_DEADLINE_EXCEEDED

    counter = RESILIENCE_DEADLINE_EXCEEDED.labels("dispatcher.test")
    before = counter.value
    reply = port_res.deadline_exceeded_reply("dispatcher.test")
    assert reply == jax_res.deadline_exceeded_reply("dispatcher.test")
    assert reply["retryable"] is True and counter.value == before + 1


def test_brownout_level_two_sheds_tracing_and_autotune_probes():
    from petastorm_tpu.pipeline import autotune as jax_autotune
    from petastorm_tpu_torch.pipeline import autotune as port_autotune
    from petastorm_tpu_torch.telemetry import tracing

    knobs = {"workers_count": {"kind": "int", "lo": 1, "hi": 16, "applies": "live"}}
    decode_bound = {"wall_s": 1.0, "rows": 10000, "stall_s": 0.6, "queue_wait_s": 0.0,
                    "decode_s": 0.9, "dispatch_s": 0.0, "knobs": {"workers_count": 2}}

    collector = tracing.COLLECTOR
    collector.acquire()
    try:
        port_res.note_brownout_level(2)
        assert port_res.brownout_level() == 2 and port_res.optional_stages_shed()
        assert not collector.enabled  # level 2 sheds the span collector
        jax_res.note_brownout_level(2)
        planners = [port_autotune.Planner(knobs, hysteresis=1),
                    jax_autotune.Planner(knobs, hysteresis=1)]
        for planner in planners:
            assert all(planner.plan(dict(decode_bound)) == [] for _ in range(3))
            assert planner.last_outcome == "noop"
        port_res.note_brownout_level(0)
        jax_res.note_brownout_level(0)
        # Out of brownout the same window probes.
        assert [d["knob"] for d in port_autotune.Planner(knobs, hysteresis=1).plan(
            dict(decode_bound))] == ["workers_count"]
        assert collector.enabled and not port_res.optional_stages_shed()
    finally:
        port_res.note_brownout_level(0)
        jax_res.note_brownout_level(0)
        collector.release()
    assert not collector.enabled
