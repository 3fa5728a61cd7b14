"""The port's fleet-trace analysis (``petastorm_tpu_torch/telemetry/
clockalign.py`` and ``critical_path.py``, and ``TraceCollector.ship``)
against the JAX package's: the same fabricated span events (the JAX
observability tests' inputs, and seeded random fleets) give equal offset
estimates, shifted events, merged traces (the producer tag aside), span
pairs, stall attributions, stage profiles, diagnoses and renderings.
Exact comparison throughout."""

import random

import numpy as np
import pytest

from petastorm_tpu.telemetry import clockalign as jax_clock
from petastorm_tpu.telemetry import critical_path as jax_cp
from petastorm_tpu_torch.telemetry import clockalign as port_clock
from petastorm_tpu_torch.telemetry import critical_path as port_cp


def _span(name, pid, ts, dur, tid=1, bid=None):
    args = {"bid": bid} if bid is not None else {}
    return [{"name": name, "ph": "B", "pid": pid, "tid": tid, "ts": ts, "args": args},
            {"name": name, "ph": "E", "pid": pid, "tid": tid, "ts": ts + dur}]


def _random_fleet(seed, n=60):
    """A seeded fleet: a consumer's waits and steps, two workers' decode /
    send spans, a client's recv / queue spans, instants and a torn
    begin."""
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for i in range(n):
        wait, step = float(rng.exponential(40.0)), float(rng.exponential(60.0))
        events += _span("loader.wait", 1, t, wait, tid=1)
        events += _span("loader.consumer", 1, t + wait, step, tid=1)
        pid = 2 + int(rng.integers(0, 2))
        bid = f"w{pid}:s:{i}"
        d0 = t - float(rng.uniform(0.0, 80.0))
        decode = float(rng.exponential(50.0))
        events += _span("worker.decode", pid, d0, decode, tid=3, bid=bid)
        events += _span("worker.send", pid, d0 + decode, float(rng.exponential(5.0)),
                        tid=3, bid=bid)
        events += _span("client.recv", 4, d0 + decode, float(rng.exponential(8.0)),
                        tid=int(rng.integers(5, 7)), bid=bid)
        events += _span("client.queue", 4, t - 5.0, float(rng.exponential(10.0)), tid=8,
                        bid=bid)
        if i % 17 == 0:
            events.append({"name": "client.hedge_launched", "ph": "i", "pid": 4, "tid": 8,
                           "ts": t, "args": {}})
        t += wait + step
    events.append({"name": "worker.send", "ph": "B", "pid": 2, "tid": 3, "ts": t})
    events.append({"name": "worker.send", "ph": "E", "pid": 3, "tid": 9, "ts": 1.0})
    order = rng.permutation(len(events))
    return [events[i] for i in order]


def _same(port, jax):
    """Equal, with the producer tag (each package names itself) masked."""
    def mask(doc):
        doc = dict(doc)
        doc["otherData"] = dict(doc["otherData"], producer=None)
        return doc
    return mask(port) == mask(jax)


@pytest.mark.parametrize("seed", range(3))
def test_offset_estimators_agree_under_jitter(seed):
    rng = random.Random(seed)
    estimators = [port_clock.OffsetEstimator(max_samples=16, best_k=4),
                  jax_clock.OffsetEstimator(max_samples=16, best_k=4)]
    assert [e.offset_us() for e in estimators] == [None, None]
    for _ in range(50):
        rtt = rng.uniform(80.0, 120.0) if rng.random() < 0.3 else rng.uniform(500.0, 5000.0)
        sample = (rng.uniform(0.0, 1e6), 5000.0 + rng.uniform(-rtt / 2, rtt / 2), rtt)
        for estimator in estimators:
            estimator.add(*sample)
        assert estimators[0].offset_us() == estimators[1].offset_us()
        assert estimators[0].min_rtt_us() == estimators[1].min_rtt_us()
    assert len(estimators[0]) == len(estimators[1]) == 16


def test_shift_and_process_name_metadata_agree():
    events = _span("worker.decode", pid=7, ts=100.0, dur=50.0) + _span("x", 8, 1.0, 2.0)
    for offset in (1000.0, None, 0, -2.5):
        assert port_clock.shift_events(events, offset) == \
            jax_clock.shift_events(events, offset)
    assert [e["ts"] for e in port_clock.shift_events(events, 1000.0)][:2] == [1100.0, 1150.0]
    assert port_clock.process_name_metadata(events, "worker-a") == \
        jax_clock.process_name_metadata(events, "worker-a")


def test_assembled_fleet_traces_agree():
    local = _span("dispatcher.status", pid=1, ts=500.0, dur=10.0)
    peers = {"worker-a": {"events": _span("worker.decode", 2, 100.0, 40.0),
                          "offset_us": 1000.0, "dropped": 2, "min_rtt_us": 80.0},
             "client-b": {"events": _span("client.recv", 3, 600.0, 5.0),
                          "offset_us": None, "dropped": 0, "min_rtt_us": None}}
    port = port_clock.assemble_fleet_trace(local, peers, local_dropped=1)
    assert _same(port, jax_clock.assemble_fleet_trace(local, peers, local_dropped=1))
    assert port["otherData"]["producer"] == "petastorm_tpu_torch.telemetry"
    assert port["otherData"]["dropped_events"] == 3
    assert port_cp.process_names(port["traceEvents"]) == {1: "dispatcher", 2: "worker-a",
                                                          3: "client-b"}


def test_the_jax_tests_attribution_cases_agree():
    cases = [
        _span("loader.wait", 1, 100.0, 100.0) + _span("worker.decode", 2, 0.0, 300.0)
        + _span("worker.send", 2, 150.0, 100.0),
        _span("loader.wait", 1, 0.0, 100.0) + _span("loader.consumer", 1, 0.0, 100.0, tid=2)
        + _span("worker.decode", 2, 80.0, 50.0),
        port_clock.process_name_metadata(_span("worker.decode", 2, 0.0, 1.0), "worker-a")
        + _span("loader.wait", 1, 0.0, 100.0) + _span("worker.decode", 2, 0.0, 60.0)
        + _span("client.queue", 3, 60.0, 30.0),
    ]
    for events in cases:
        assert port_cp.pair_spans(events) == jax_cp.pair_spans(events)
        assert port_cp.attribute_stalls(events) == jax_cp.attribute_stalls(events)
        assert port_cp.diagnose(events, 50.0) == jax_cp.diagnose(events, 50.0)
    report = port_cp.diagnose(cases[2], measured_stall_pct=50.0)
    assert [r["stage"] for r in report["bottlenecks"]] == ["worker.decode", "client.queue"]
    assert report["bottlenecks"][0]["stall_pct"] == pytest.approx(30.0)
    assert port_cp.render(report) == jax_cp.render(report)
    assert "90.0% attributed" in port_cp.render(report)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_fleets_diagnose_alike(seed):
    events = _random_fleet(seed)
    peers = {f"peer-{pid}": {"events": [e for e in events if e.get("pid") == pid],
                             "offset_us": 10.0 * pid if pid % 2 else None,
                             "dropped": pid, "min_rtt_us": 3.0}
             for pid in (2, 3, 4)}
    local = [e for e in events if e.get("pid") == 1]
    port_doc = port_clock.assemble_fleet_trace(local, peers, local_dropped=seed)
    assert _same(port_doc, jax_clock.assemble_fleet_trace(local, peers,
                                                          local_dropped=seed))
    merged = port_doc["traceEvents"]
    stall = float(seed * 10 + 5)
    for wait_stage in ("loader.wait", "client.recv"):
        port = port_cp.diagnose(merged, measured_stall_pct=stall, wait_stage=wait_stage)
        assert port == jax_cp.diagnose(merged, measured_stall_pct=stall,
                                       wait_stage=wait_stage)
        assert port_cp.render(port) == jax_cp.render(port)
    assert port_cp.stage_profile(merged) == jax_cp.stage_profile(merged)
    assert port["wait_total_us"] > 0 and port["bottlenecks"]


def test_collector_ship_takes_and_clears():
    from petastorm_tpu_torch.telemetry.tracing import TraceCollector

    collector = TraceCollector(max_events=4)
    collector.acquire()
    for i in range(3):
        collector.record_span("s", float(i), float(i) + 0.5)
    events, dropped = collector.ship()
    assert len(events) == 4 and dropped == 2  # 6 events offered to a ring of 4
    assert collector.ship() == ([], 0)
    collector.instant("mark", 1.0)
    assert [e["name"] for e in collector.ship()[0]] == ["mark"]
    collector.release()
