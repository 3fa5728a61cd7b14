"""The port's online autotuner (``petastorm_tpu_torch.pipeline``), the live
thread-pool resize and the loader's ``autotune=`` on the CPU, held against
``petastorm_tpu.pipeline`` and the JAX pool, reader and loader:

- the planner: the same profile sequences (the JAX package's golden
  scenarios of ``tests/test_autotune.py`` and ``tests/test_rewrites.py``,
  and sequences generated from numpy seeds, with each round's decisions
  fed back into the next window's knobs) give both packages' ``Planner``
  identical decision lists, ``last_class`` and ``last_outcome`` every
  round; ``classify`` and ``rewrite_triggered`` agree on every generated
  window;
- the controller, driven by hand (``step()`` under a fake clock, interval
  60 s, never started) over the same fake graph built from each package's
  classes: the same knob values, trail and telemetry deltas; its per-
  controller gauges are released with it; a round that raises is logged
  and the loop goes on;
- the five telemetry families equal the JAX families;
- ``ThreadPool.resize`` grows and shrinks without losing an item (the
  results multiset equals the JAX pool's), ``Reader.resize_workers`` on a
  thread pool, and the refusals;
- ``build_loader_graph`` on a plain port loader gives the JAX local graph;
- the loader's ``autotune=`` validation, and an autotuned loader's rows.

Tolerance: none; everything is compared exactly (a row multiset where the
thread pool's order is free).
"""

import collections
import gc
import logging
import threading
import time

import numpy as np
import pytest

import petastorm_tpu.pipeline.autotune as jax_autotune
import petastorm_tpu.pipeline.graph as jax_graph
import petastorm_tpu.pipeline.rewrites as jax_rewrites
import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu.telemetry.metrics as jax_metrics
import petastorm_tpu_torch.pipeline.autotune as port_autotune
import petastorm_tpu_torch.pipeline.graph as port_graph
import petastorm_tpu_torch.pipeline.rewrites as port_rewrites
import petastorm_tpu_torch.reader.reader as port_reader_mod
import petastorm_tpu_torch.telemetry.metrics as port_metrics
from petastorm_tpu.jax_utils.loader import make_jax_dataloader
from petastorm_tpu.service.resilience import optional_stages_shed
from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

PACKAGES = {"jax": (jax_autotune, jax_graph, jax_metrics),
            "port": (port_autotune, port_graph, port_metrics)}

# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

KNOBS = {
    "workers_count": {"kind": "int", "lo": 1, "hi": 16, "applies": "live"},
    "host_prefetch": {"kind": "int", "lo": 1, "hi": 64, "applies": "live"},
    "device_prefetch": {"kind": "int", "lo": 1, "hi": 16, "applies": "live"},
    "credits": {"kind": "int", "lo": 1, "hi": 64, "applies": "next-stream"},
    "ready_queue_depth": {"kind": "int", "lo": 2, "hi": 256, "applies": "live"},
    "transform_placement": {"kind": "choice", "choices": ["remote", "local"],
                            "applies": "next-iteration"},
}
REWRITE_KNOBS = {
    "stage_fusion": {"kind": "choice", "choices": ["off", "fused"],
                     "applies": "next-iteration", "rewrite": "fuse_worker_stages"},
    "filter_placement": {"kind": "choice", "choices": ["client", "worker"],
                         "applies": "next-iteration", "rewrite": "hoist_filter"},
    "cache_placement": {"kind": "choice", "choices": ["post-transform", "post-decode"],
                        "applies": "next-iteration", "rewrite": "cache_placement"},
    "reader_family": {"kind": "choice", "choices": ["row", "columnar"],
                      "applies": "next-iteration", "rewrite": "row_vs_columnar"},
}
LOCAL_KNOBS = {name: KNOBS[name] for name in ("workers_count", "host_prefetch",
                                               "device_prefetch")}
DEFAULT_VALUES = {"workers_count": 2, "host_prefetch": 4, "device_prefetch": 2,
                  "credits": 8, "ready_queue_depth": 16, "transform_placement": "remote"}


def _profile(*, wall=1.0, rows=10000, stall=0.0, queue_wait=0.0, decode=0.0,
             dispatch=0.0, knobs=None, **signals):
    out = {"wall_s": wall, "rows": rows, "stall_s": stall, "queue_wait_s": queue_wait,
           "decode_s": decode, "dispatch_s": dispatch,
           "knobs": dict(DEFAULT_VALUES if knobs is None else knobs)}
    out.update(signals)
    return out


def _hoist(**kw):
    """A decode-bound window whose client filter drops 75% of rows."""
    knobs = {"workers_count": 2, "credits": 8, "filter_placement": "client",
             "stage_fusion": "off"}
    knobs.update(kw.pop("knobs", {}))
    kw.setdefault("stall", 0.5)
    return _profile(decode_s=0.9, filter_rows_in=1000.0, filter_rows_kept=250.0,
                    knobs=knobs, **kw)


def _rw(**kw):
    kw.setdefault("stall", 0.5)
    return _profile(**kw)


_REWRITE_PLANNER = dict(hysteresis=1, placement_hysteresis=1, rewrite_hysteresis=2)
_REWRITE_SET = {"workers_count": KNOBS["workers_count"], "credits": KNOBS["credits"],
                **REWRITE_KNOBS}
_DECODE = dict(stall=0.5, decode=0.9, dispatch=0.1)

#: (name, knob descriptors, planner kwargs, profiles): the JAX package's
#: golden scenarios, each fed round by round to both planners.
SCENARIOS = [
    ("decode-bound raises workers_count", KNOBS, dict(hysteresis=2),
     [_profile(**_DECODE)] * 6),
    ("dispatch-bound raises device_prefetch", KNOBS, dict(hysteresis=2),
     [_profile(stall=0.5, decode=0.1, dispatch=0.6)] * 6),
    ("credit-bound raises credits", KNOBS, dict(hysteresis=2),
     [_profile(stall=0.5, credit_wait_s=0.6)] * 6),
    ("worker-bound flips transform local", KNOBS,
     dict(hysteresis=2, placement_hysteresis=3),
     [_profile(stall=0.6, recv_stall_s=0.9)] * 6),
    ("balanced is a no-op", KNOBS, dict(hysteresis=1), [_profile(stall=0.01)] * 10),
    ("idle never tunes", KNOBS, dict(hysteresis=1), [_profile(rows=0)] * 5),
    ("consumer-bound flips transform remote", KNOBS, dict(hysteresis=1),
     [_profile(stall=0.01, queue_wait=0.5,
               knobs=dict(DEFAULT_VALUES, transform_placement="local"))] * 6),
    ("alternating classes never build a streak", KNOBS, dict(hysteresis=3),
     [_profile(**_DECODE), _profile(stall=0.5, decode=0.1, dispatch=0.6)] * 6),
    ("regressing probe reverts and settles", KNOBS, dict(hysteresis=1, tolerance=0.05),
     [_profile(**_DECODE), _profile(rows=5000, **_DECODE)] + [_profile(**_DECODE)] * 8),
    ("non-live probe defers evaluation", KNOBS, dict(hysteresis=1, probe_defer=2),
     [_profile(stall=0.5, credit_wait_s=0.6)]
     + [_profile(stall=0.5, credit_wait_s=0.6, rows=100)] * 3),
    ("neutral probe settles", KNOBS, dict(hysteresis=1, tolerance=0.05),
     [_profile(**_DECODE)] * 12),
    ("never leaves declared bounds", KNOBS, dict(hysteresis=1, tolerance=1e9),
     [_profile(knobs={"workers_count": 15, "host_prefetch": 63, "device_prefetch": 15,
                      "credits": 63, "ready_queue_depth": 255,
                      "transform_placement": "remote"}, **_DECODE)] * 30),
    ("hoist trigger", _REWRITE_SET, _REWRITE_PLANNER, [_hoist()] * 3),
    ("untriggered rewrite falls through", _REWRITE_SET, _REWRITE_PLANNER,
     [_rw(decode_s=0.9, knobs={"workers_count": 2, "credits": 8,
                               "filter_placement": "client", "stage_fusion": "off",
                               "cache_placement": "post-transform"})] * 8),
    ("fuse trigger", _REWRITE_SET, _REWRITE_PLANNER,
     [_rw(decode_s=0.9, worker_decode_s=0.5, handoff_s=0.2,
          knobs={"workers_count": 2, "credits": 8, "stage_fusion": "off"})] * 8),
    ("cache placement post-decode", _REWRITE_SET, _REWRITE_PLANNER,
     [_rw(decode_s=0.9, worker_decode_s=1.0, transform_s=0.1, cache_hits=5.0,
          cache_misses=5.0, cache_evictions=3.0,
          knobs={"workers_count": 2, "credits": 8,
                 "cache_placement": "post-transform"})] * 8),
    ("cache placement post-transform", _REWRITE_SET, _REWRITE_PLANNER,
     [_rw(stall=0.01, queue_wait_s=0.5, transform_s=0.4, cache_hits=9.0, cache_misses=1.0,
          knobs={"workers_count": 2, "credits": 8,
                 "cache_placement": "post-decode"})] * 8),
    ("rewrite revert on regression", _REWRITE_SET, dict(_REWRITE_PLANNER, probe_defer=0),
     [_hoist()] * 2 + [_hoist(rows=5000, knobs={"filter_placement": "worker"})]
     + [_hoist()] * 8),
    ("rewrites disabled is knob-only", _REWRITE_SET, dict(_REWRITE_PLANNER, rewrites=False),
     [_hoist()] * 8),
    ("rewrite thresholds override", _REWRITE_SET,
     dict(_REWRITE_PLANNER, rewrite_thresholds={"hoist_min_drop_frac": 0.05}),
     [_rw(decode_s=0.9, filter_rows_in=1000.0, filter_rows_kept=900.0,
          knobs={"workers_count": 2, "credits": 8, "filter_placement": "client"})] * 8),
]


def _run_planners(knobs, kwargs, profiles, feedback=False):
    """Both packages' planners over ``profiles``: the per-round
    ``(decisions, last_class, last_outcome)`` lists. With ``feedback`` each
    round's decisions are applied to the next window's knobs, as the
    controller would."""
    out = {}
    for name, (autotune, _, _) in PACKAGES.items():
        planner = autotune.Planner(knobs, **kwargs)
        values, rounds = None, []
        for profile in profiles:
            profile = dict(profile)
            if feedback:
                values = dict(profile["knobs"]) if values is None else values
                profile["knobs"] = dict(values)
            decisions = planner.plan(profile)
            rounds.append((decisions, planner.last_class, planner.last_outcome))
            if feedback:
                for d in decisions:
                    values[d["knob"]] = d["to"]
        out[name] = rounds
    return out["jax"], out["port"]


def test_no_brownout_in_the_reference():
    """The JAX planner's one extra input, the data service's brownout, is
    off in these tests, so both planners see the same world."""
    assert not optional_stages_shed()


@pytest.mark.parametrize("name,knobs,kwargs,profiles", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_planner_golden_scenarios_decide_alike(name, knobs, kwargs, profiles):
    jax_rounds, port_rounds = _run_planners(knobs, kwargs, profiles)
    assert port_rounds == jax_rounds
    assert any(decisions for decisions, _, _ in jax_rounds) or name in (
        "balanced is a no-op", "idle never tunes", "alternating classes never build a streak")


def test_planner_goldens_hold_in_the_port():
    """A few of the JAX goldens' values, stated, so the parity above is not
    parity of two empty lists."""
    planner = port_autotune.Planner(KNOBS, hysteresis=2)
    first = [planner.plan(_profile(**_DECODE)) for _ in range(2)]
    assert first[0] == [] and [(d["knob"], d["direction"], d["to"]) for d in first[1]] == \
        [("workers_count", "up", 4)]
    planner = port_autotune.Planner(KNOBS, hysteresis=1, tolerance=0.05)
    planner.plan(_profile(**_DECODE))
    assert [(d["knob"], d["direction"], d["to"])
            for d in planner.plan(_profile(rows=5000, **_DECODE))] == \
        [("workers_count", "revert", 2)]
    planner = port_autotune.Planner(_REWRITE_SET, **_REWRITE_PLANNER)
    assert planner.plan(_hoist()) == []
    got = planner.plan(_hoist())
    assert [(d["knob"], d["to"], d["rewrite"]) for d in got] == \
        [("filter_placement", "worker", "hoist_filter")]
    assert "drops 75%" in got[0]["reason"]


def _random_profile(rng, knob_set):
    knobs = {}
    for name, desc in knob_set.items():
        if desc["kind"] == "int":
            knobs[name] = int(rng.randint(desc["lo"], desc["hi"] + 1))
        else:
            knobs[name] = desc["choices"][rng.randint(len(desc["choices"]))]
    wall = float(rng.choice([0.0, 0.02, 0.5, 1.0, 2.0]))
    profile = {"wall_s": wall, "rows": int(rng.choice([0, 100, 5000, 10000, 12000])),
               "knobs": knobs}
    for key in ("stall_s", "queue_wait_s", "decode_s", "dispatch_s", "consumer_s"):
        profile[key] = float(rng.uniform(0, wall or 1.0)) * float(rng.rand() < 0.8)
    for key in ("credit_wait_s", "recv_stall_s", "worker_decode_s", "handoff_s",
                "transform_s", "cache_hits", "cache_misses", "cache_evictions"):
        if rng.rand() < 0.4:
            profile[key] = float(rng.uniform(0, 1.5 * (wall or 1.0)))
    if rng.rand() < 0.3:
        profile["filter_rows_in"] = 1000.0
        profile["filter_rows_kept"] = float(rng.randint(0, 1001))
    return profile


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("knob_set", ["local", "all"])
def test_planner_generated_sequences_decide_alike(seed, knob_set):
    """60 seeded sequences of 40 windows each (drifting between a few
    window shapes so hysteresis matures), decisions fed back."""
    knobs = LOCAL_KNOBS if knob_set == "local" else dict(KNOBS, **REWRITE_KNOBS)
    rng = np.random.RandomState(1000 * seed + len(knob_set))
    for _ in range(60):
        shapes = [_random_profile(rng, knobs) for _ in range(3)]
        profiles = [shapes[i] for i in rng.randint(0, 3, size=40)]
        kwargs = dict(hysteresis=int(rng.randint(1, 4)),
                      placement_hysteresis=int(rng.randint(1, 5)),
                      tolerance=float(rng.choice([0.02, 0.05, 0.08, 0.2])),
                      probe_defer=int(rng.randint(0, 4)),
                      rewrite_hysteresis=int(rng.randint(1, 7)),
                      rewrites=bool(rng.rand() < 0.8))
        jax_rounds, port_rounds = _run_planners(knobs, kwargs, profiles, feedback=True)
        assert port_rounds == jax_rounds
        for profile in shapes:
            assert port_autotune.classify(profile) == jax_autotune.classify(profile)
            for kind, info in jax_rewrites.REWRITE_KINDS.items():
                for want in REWRITE_KNOBS[info["knob"]]["choices"]:
                    assert port_rewrites.rewrite_triggered(kind, want, profile) == \
                        jax_rewrites.rewrite_triggered(kind, want, profile)


def test_rewrite_catalog_equals_the_jax_catalog():
    assert port_rewrites.REWRITE_KINDS == jax_rewrites.REWRITE_KINDS
    assert port_rewrites.DEFAULT_THRESHOLDS == jax_rewrites.DEFAULT_THRESHOLDS
    assert port_autotune._CLASS_KNOBS == jax_autotune._CLASS_KNOBS
    for knob in ("stage_fusion", "filter_placement", "cache_placement", "reader_family",
                 "credits"):
        assert port_rewrites.rewrite_kind_for_knob(knob) == \
            jax_rewrites.rewrite_kind_for_knob(knob)
    with pytest.raises(ValueError, match="unknown rewrite kind"):
        port_rewrites.rewrite_triggered("teleport", "x", {})
    for value in ("remote", "local", "fused", "off", 7, "7", None, "sideways"):
        assert port_autotune._gauge_value(value) == jax_autotune._gauge_value(value)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now


def _fake_graph(graph_mod, values, sig):
    signals = {name: (lambda name=name: sig[name])
               for name in ("rows", "stall_s", "queue_wait_s", "decode_s", "dispatch_s",
                            "consumer_s")}
    knobs = [graph_mod.Knob(name, get=lambda name=name: values[name],
                            set=lambda v, name=name: values.__setitem__(name, v),
                            lo=desc["lo"], hi=desc["hi"])
             for name, desc in LOCAL_KNOBS.items()]
    return graph_mod.PipelineGraph(
        [graph_mod.StageNode("decode", "worker", "trainer",
                             metric=lambda: (int(sig["rows"] // 100), sig["decode_s"])),
         graph_mod.StageNode("consume", "client", "device")],
        [("decode", "consume")], knobs=knobs, signals=signals)


def _counter_values(family):
    return {key: child.value for key, child in family.children().items()}


def test_controller_steps_alike_by_hand(monkeypatch):
    """Both controllers over the same signal stream, stepped by hand under
    one fake clock: knob values, trail, report and telemetry deltas equal."""
    rng = np.random.RandomState(3)
    windows = []
    for i in range(40):
        kind = (i // 8) % 3
        windows.append({"rows": 10000 if kind != 2 else 0,
                        "stall_s": [0.5, 0.5, 0.0][kind] * rng.uniform(0.9, 1.1),
                        "queue_wait_s": 0.0,
                        "decode_s": [0.9, 0.1, 0.0][kind],
                        "dispatch_s": [0.1, 0.6, 0.0][kind],
                        "consumer_s": 0.2,
                        "speed": rng.choice([0.5, 1.0, 1.5])})
    results = {}
    for name, (autotune, graph_mod, metrics) in PACKAGES.items():
        clock = _Clock()
        monkeypatch.setattr(autotune, "time", clock)
        values = {"workers_count": 2, "host_prefetch": 4, "device_prefetch": 2}
        sig = dict.fromkeys(("rows", "stall_s", "queue_wait_s", "decode_s", "dispatch_s",
                             "consumer_s"), 0.0)
        graph = _fake_graph(graph_mod, values, sig)
        controller = autotune.AutotuneController(
            graph, interval_s=60, planner=autotune.Planner(
                {n: k.descriptor() for n, k in graph.knobs.items()}, hysteresis=1,
                tolerance=0.08))
        controller._prev = (clock.now, graph.snapshot())
        before = (_counter_values(metrics.AUTOTUNE_DECISIONS),
                  _counter_values(metrics.AUTOTUNE_ROUNDS))
        applied = []
        for window in windows:
            clock.now += 1.0
            for key in sig:
                sig[key] += window[key] * (window["speed"] if key == "rows" else 1.0)
            applied.append(controller.step())
        after = (_counter_values(metrics.AUTOTUNE_DECISIONS),
                 _counter_values(metrics.AUTOTUNE_ROUNDS))
        deltas = [{k: v - b.get(k, 0.0) for k, v in a.items() if v != b.get(k, 0.0)}
                  for a, b in zip(after, before)]
        gauges = {knob: metrics.AUTOTUNE_KNOB_VALUE.labels(controller._id, knob).value
                  for knob in values}
        assert not controller.running
        results[name] = (dict(values), applied, controller.report(), deltas, gauges)
    assert results["port"] == results["jax"]
    values, applied, report, deltas, gauges = results["port"]
    assert any(applied) and report["rounds"] == 40
    assert gauges == {k: float(v) for k, v in values.items()}
    decisions = [d for entry in report["trail"] for d in entry["decisions"]]
    counted = collections.Counter((d["knob"], d["direction"]) for d in decisions)
    assert deltas[0] == {key: float(n) for key, n in counted.items()}
    assert sum(deltas[1].values()) == 40


def test_controller_gauges_released_with_it():
    values = {"workers_count": 2, "host_prefetch": 4, "device_prefetch": 2}
    graph = _fake_graph(port_graph, values, dict.fromkeys(
        ("rows", "stall_s", "queue_wait_s", "decode_s", "dispatch_s", "consumer_s"), 0.0))
    controller = port_autotune.AutotuneController(graph, interval_s=60)
    cid = controller._id
    children = port_metrics.AUTOTUNE_KNOB_VALUE.children()
    assert {(cid, k) for k in values} <= set(children)
    assert children[(cid, "host_prefetch")].value == 4.0
    del controller
    gc.collect()
    assert not {key for key in port_metrics.AUTOTUNE_KNOB_VALUE.children() if key[0] == cid}


def test_failed_round_is_logged_and_the_loop_goes_on(caplog):
    """A round that raises is logged ("autotune round failed") and the
    thread keeps planning (the JAX loop's contract); stop() ends it."""
    values = {"workers_count": 2, "host_prefetch": 4, "device_prefetch": 2}
    sig = dict.fromkeys(("rows", "stall_s", "queue_wait_s", "decode_s", "dispatch_s",
                         "consumer_s"), 0.0)
    graph = _fake_graph(port_graph, values, sig)
    controller = port_autotune.AutotuneController(graph, interval_s=0.005)
    failures = []

    def broken_plan(profile):
        failures.append(profile)
        raise RuntimeError("planner exploded")

    controller.planner.plan = broken_plan
    with caplog.at_level(logging.WARNING):
        controller.start()
        assert controller._thread.name.startswith("pipeline-autotune-torch-")
        deadline = time.monotonic() + 10
        while len(failures) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert controller.running
        controller.stop()
        controller.join()
    assert not controller.running and len(failures) >= 3
    records = [r for r in caplog.records if r.getMessage().startswith("autotune round failed")]
    assert len(records) >= 3 and records[0].exc_info is not None
    assert records[0].name == "petastorm_tpu_torch.service.autotune"


# ---------------------------------------------------------------------------
# the five families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["AUTOTUNE_DECISIONS", "AUTOTUNE_KNOB_VALUE",
                                  "AUTOTUNE_ROUNDS", "REWRITE_DECISIONS", "REWRITE_ACTIVE"])
def test_autotune_families_equal_the_jax_families(name):
    port, ref = getattr(port_metrics, name), getattr(jax_metrics, name)
    assert (port.name, port.help, port.kind, port.label_names) == \
        (ref.name, ref.help, ref.kind, ref.label_names)


# ---------------------------------------------------------------------------
# the pool and the reader
# ---------------------------------------------------------------------------

def _pool_run(pool_cls, worker_base, seed):
    """Ventilate 120 items into a 2-worker pool, grow to 5 after 20
    results, shrink to 1 after 60, ventilate 40 more, drain: the results,
    the worker counts seen and the live threads once quiet."""
    from petastorm_tpu.workers_pool import EmptyResultError as JaxEmpty
    from petastorm_tpu_torch.workers_pool import EmptyResultError as PortEmpty

    class Doubler(worker_base):
        def process(self, x):
            time.sleep(0.0005 * (x % 3))
            self.publish_func((x, 2 * x))

    rng = np.random.RandomState(seed)
    items = [int(v) for v in rng.randint(0, 1000, size=160)]
    pool = pool_cls(2, results_queue_size=8)
    pool.start(Doubler)
    counts = []
    try:
        for x in items[:120]:
            pool.ventilate(x)
        results = []
        while True:
            if len(results) == 20:
                pool.resize(5)
                counts.append(pool.workers_count)
            if len(results) == 60:
                pool.resize(1)
                counts.append(pool.workers_count)
                for x in items[120:]:
                    pool.ventilate(x)
            try:
                results.append(pool.get_results(timeout=30))
            except (JaxEmpty, PortEmpty):
                break
        deadline = time.monotonic() + 10
        while sum(t.is_alive() for t in pool._threads) != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        live = sum(t.is_alive() for t in pool._threads)
        diag = pool.diagnostics
    finally:
        pool.stop()
        pool.join()
    return sorted(results), counts, live, diag, items


@pytest.mark.parametrize("seed", [0, 1])
def test_thread_pool_resize_keeps_every_item(seed):
    from petastorm_tpu.workers_pool.thread_pool import ThreadPool as JaxPool
    from petastorm_tpu.workers_pool.worker_base import WorkerBase as JaxWorker
    from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool as PortPool
    from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase as PortWorker

    got, counts, live, diag, items = _pool_run(PortPool, PortWorker, seed)
    want, jax_counts, jax_live, jax_diag, _ = _pool_run(JaxPool, JaxWorker, seed)
    assert got == want == sorted((x, 2 * x) for x in items)
    assert counts == jax_counts == [5, 1]
    assert live == jax_live == 1
    assert diag == jax_diag
    assert diag["items_in_flight"] == 0 and diag["items_processed"] == 160


def test_thread_pool_resize_rejects_below_one_and_sets_count_before_start():
    from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool

    pool = ThreadPool(2)
    with pytest.raises(ValueError, match=">= 1"):
        pool.resize(0)
    pool.resize(5)  # before start(): only the count
    assert pool.workers_count == 5 and pool.live_workers == 0


def _write_store(tmp_path, rows=120, group=10):
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("TuneSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("x", np.float32, (4,), None, False),
    ])
    rng = np.random.RandomState(11)
    url = f"file://{tmp_path}/store"
    materialize_rows(url, schema, ({"id": i, "x": rng.rand(4).astype(np.float32)}
                                   for i in range(rows)), rows_per_row_group=group)
    return url


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return _write_store(tmp_path_factory.mktemp("tune"))


def test_reader_resize_workers_on_a_thread_pool(store):
    """Mid-iteration grow and shrink: three epochs' rows, the JAX reader's
    multiset (and its worker counts)."""
    seen = {}
    for name, module in (("port", port_reader_mod), ("jax", jax_reader_mod)):
        ids, counts = [], []
        with module.make_reader(store, reader_pool_type="thread", workers_count=1,
                                num_epochs=3) as reader:
            it = iter(reader)
            ids += [int(next(it).id) for _ in range(5)]
            reader.resize_workers(4)
            counts.append(reader.diagnostics["workers_count"])
            ids += [int(next(it).id) for _ in range(40)]
            reader.resize_workers(2)
            counts.append(reader.diagnostics["workers_count"])
            ids += [int(row.id) for row in it]
        seen[name] = (sorted(ids), counts)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == (sorted(list(range(120)) * 3), [4, 2])


def test_reader_resize_workers_refusals(store):
    with port_reader_mod.make_reader(store, reader_pool_type="dummy", num_epochs=1) as reader:
        with pytest.raises(NotImplementedError, match="thread"):
            reader.resize_workers(2)
    with port_reader_mod.make_reader(store, reader_pool_type="process", workers_count=1,
                                     num_epochs=1) as reader:
        with pytest.raises(NotImplementedError, match="ProcessPool cannot resize"):
            reader.resize_workers(2)


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------

def _structure(graph):
    described = graph.describe()
    return ([(s["name"], s["side"], s["placement"], s["flippable"], s["fuse_group"])
             for s in described["stages"]], described["edges"], described["knobs"])


def test_local_graph_equals_the_jax_local_graph(store):
    """A plain make_torch_dataloader (which always has a ReaderBatchSource)
    gets the JAX local graph: node names, sides, placements, edges, knobs
    and their bounds, and the six signals."""
    with port_reader_mod.make_reader(store, reader_pool_type="thread", workers_count=2,
                                     num_epochs=1) as reader:
        loader = make_torch_dataloader(reader, 5, device="cpu")
        graph = port_graph.build_loader_graph(loader, bounds={"device_prefetch": (1, 8)})
        port = _structure(graph)
        snapshot = graph.snapshot()
        graph.knobs["workers_count"].set(3)
        assert reader.diagnostics["workers_count"] == 3
        graph.knobs["host_prefetch"].set(7)
        assert loader.host_prefetch == 7
    with jax_reader_mod.make_reader(store, reader_pool_type="thread", workers_count=2,
                                    num_epochs=1) as reader:
        jax_loader = make_jax_dataloader(reader, 5, stage_to_device=False)
        jax_graph_ = jax_graph.build_loader_graph(jax_loader,
                                                  bounds={"device_prefetch": (1, 8)})
        want = _structure(jax_graph_)
        jax_snapshot = jax_graph_.snapshot()
        jax_loader.stop()
        jax_loader.join()
    assert port == want
    assert set(port[2]) == {"workers_count", "host_prefetch", "device_prefetch"}
    assert snapshot["knobs"] == jax_snapshot["knobs"] == \
        {"workers_count": 2, "host_prefetch": 4, "device_prefetch": 2}
    assert set(snapshot["signals"]) == set(jax_snapshot["signals"])
    assert snapshot["signals"] == dict.fromkeys(snapshot["signals"], 0.0)


def test_graph_validation_and_the_service_refusal():
    for graph_mod in (port_graph, jax_graph):
        with pytest.raises(ValueError, match="placement"):
            graph_mod.StageNode("x", "worker", "moon")
        with pytest.raises(ValueError, match="side"):
            graph_mod.StageNode("x", "elsewhere", "trainer")
        node = graph_mod.StageNode("x", "worker", "trainer")
        with pytest.raises(ValueError, match="unknown stage"):
            graph_mod.PipelineGraph([node], [("x", "y")])
        knob = graph_mod.Knob("k", get=lambda: 1, set=lambda v: None, lo=1, hi=4)
        with pytest.raises(ValueError, match="duplicate knob"):
            graph_mod.PipelineGraph([node], [], knobs=[knob, knob])
        with pytest.raises(ValueError, match="lo <= hi"):
            graph_mod.Knob("k", get=lambda: 1, set=lambda v: None, lo=4, hi=1)
        assert knob.clamp(9) == 4 and knob.clamp(-3) == 1

    # A data-service source (constructing it dials nothing) gets the
    # service half of the graph: its knobs (the graph rewrites' among them),
    # the remote worker stages and the service signals.
    from petastorm_tpu_torch.service import ServiceBatchSource
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    source = ServiceBatchSource(("127.0.0.1", 1), credits=4, ready_queue_depth=8,
                                transform=lambda batch: batch)
    graph = port_graph.build_loader_graph(TorchDataLoader(None, source, device="cpu"))
    snapshot = graph.snapshot()
    assert snapshot["knobs"] == {"device_prefetch": 2, "credits": 4, "ready_queue_depth": 8,
                                 "transform_placement": "remote", "stage_fusion": "off",
                                 "cache_placement": "post-transform", "reader_family": "row"}
    assert {"recv_stall_s", "credit_wait_s"} <= set(snapshot["signals"])
    assert {node.name: node.placement for node in graph.nodes.values()
            if node.side == "worker"} == dict.fromkeys(
        ("read", "decode", "transform", "collate", "serialize", "send"), "worker")
    source.set_transform_placement("local")
    assert graph.nodes[("worker", "transform")].placement == "trainer"


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["yes", 1, [], {"intervals": 1.0},
                                    {"interval_s": 0.1, "bogus": 2}])
def test_autotune_validation_raises_the_jax_errors(store, config):
    with port_reader_mod.make_reader(store, reader_pool_type="dummy", num_epochs=1) as reader:
        with pytest.raises(ValueError) as port_err:
            make_torch_dataloader(reader, 5, device="cpu", autotune=config)
    with jax_reader_mod.make_reader(store, reader_pool_type="dummy", num_epochs=1) as reader:
        with pytest.raises(ValueError) as jax_err:
            make_jax_dataloader(reader, 5, stage_to_device=False, autotune=config)
    assert str(port_err.value) == str(jax_err.value)


def test_autotuned_loader_delivers_the_static_rows(store):
    """An aggressively autotuned port loader (rounds every 10 ms, so the
    pool and the queues resize during the pass), the static port loader
    and the autotuned JAX loader deliver the same rows."""
    cfg = {"interval_s": 0.01, "hysteresis": 1, "tolerance": 0.08}
    runs = {}
    for name, autotune in (("static", None), ("tuned", cfg)):
        with port_reader_mod.make_reader(store, reader_pool_type="thread", workers_count=3,
                                         num_epochs=6, shuffle_row_groups=True) as reader:
            loader = make_torch_dataloader(reader, 8, device="cpu", autotune=autotune)
            ids = []
            for batch in loader:
                ids += batch["id"].tolist()
                time.sleep(0.001)
            runs[name] = (sorted(ids), loader)
    with jax_reader_mod.make_reader(store, reader_pool_type="thread", workers_count=3,
                                    num_epochs=6, shuffle_row_groups=True) as reader:
        with make_jax_dataloader(reader, 8, stage_to_device=False, autotune=cfg) as loader:
            jax_ids = sorted(int(v) for b in loader for v in np.asarray(b["id"]))
    assert runs["tuned"][0] == runs["static"][0] == jax_ids == sorted(list(range(120)) * 6)
    tuned = runs["tuned"][1].autotune
    assert runs["static"][1].autotune is None
    assert tuned is not None and not tuned.running and tuned.rounds >= 1
    for entry in tuned.trail:
        for d in entry["decisions"]:
            desc = tuned.graph.knobs[d["knob"]].descriptor()
            assert desc["lo"] <= d["to"] <= desc["hi"]


def test_disabled_autotune_builds_nothing(store):
    seen = []
    with port_reader_mod.make_reader(store, reader_pool_type="thread", workers_count=2,
                                     num_epochs=1) as reader:
        loader = make_torch_dataloader(reader, 8, device="cpu", autotune=False)
        for _ in loader:
            seen += [t.name for t in threading.enumerate()
                     if t.name.startswith("pipeline-autotune")]
    assert loader.autotune is None and loader._autotune_config is None and seen == []
