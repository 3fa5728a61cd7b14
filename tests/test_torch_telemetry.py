"""The port's telemetry (``petastorm_tpu_torch/telemetry``) against the JAX
package's, after ``tests/test_telemetry.py``:

- registry semantics (counters, gauges, histograms, labels, thread
  safety) and histogram quantiles equal to the JAX estimate on the same
  observations;
- ``expose_prometheus`` text equal line for line to the JAX text for equal
  registries, the port's whole vocabulary (every family's HELP and TYPE,
  labels and buckets) equal to the JAX families of the same names, and
  equal snapshots;
- ``SnapshotRing.rate`` equal to the JAX ring's on the same snapshots;
- the HTTP endpoint's four routes;
- the flight recorder's ring, its dump and the ``threading.excepthook``
  chain;
- the structured logger's line format;
- the tracing module's functions over the process collector;
- ``tracing.span``: into the collector only when armed, on any thread; a
  profiler range only while a profiler records the calling thread; no
  torch call with both off; the two sinks on one clock after
  ``fit_profiler_clock``; the module imports without torch;
- the program's spans where the work happens: the thread pool's
  ``reader.decode`` a ventilated item on its worker with its publish's
  ``reader.queue_wait`` inside, and ``reader.wait`` on the consumer; the
  LM's and the DLRM's ``step.forward``, ``step.backward`` and
  ``step.update`` once a step in that order, and ``dlrm.collate``;
- the loader's ``diagnostics`` derived from its registry series, live,
  rebased by ``exclude_stall_so_far``, ``stage_quantiles``, and the series
  retired when the loader is collected;
- one seeded workload (a thread-pool reader, a two-pass cached loader)
  through both packages: the counts of the ``LOADER_*``, ``POOL_*``,
  ``VENTILATOR_*`` and ``CACHE_*`` families equal (counts and histogram
  counts, not seconds).

Tolerance: none, except the clock fit's: after the fit, nine in ten of
the spans' ends in the two sinks agree to ``FIT_TOLERANCE_US`` and their
median to a fifth of it.
"""

import gc
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu_torch.telemetry import registry as port_registry
from petastorm_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    SnapshotRing,
    expose_prometheus,
    log_buckets,
)

def _fill(reg_module):
    """A registry of each kind of series, from a seeded stream of updates."""
    reg = reg_module.MetricsRegistry()
    rng = np.random.RandomState(11)
    c = reg.counter("evil_total", 'help with \\ and\nnewline', labels=("b", "a"))
    c.labels('va"l\n', "x\\y").inc(2)
    c.labels("plain", "0").inc(0.25)
    g = reg.gauge("depth", "a gauge", labels=("tier",))
    g.labels("mem").set(1e15 + 3)
    g.labels("disk").set(-2.5)
    reg.counter("declared_only_total", "declared, never incremented")
    h = reg.histogram("lat_seconds", "latency", labels=("stage",))
    for stage in ("decode", "wait"):
        for v in rng.lognormal(-6, 3, size=200):
            h.labels(stage).observe(v)
    small = reg.histogram("small_seconds", "custom buckets", buckets=(0.5, 1.0))
    for v in (0.1, 0.7, 9.0, float("inf")):
        small.observe(v)
    return reg


# -- registry semantics ------------------------------------------------------

def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "a counter", labels=("who",))
    c.labels("a").inc()
    c.labels("a").inc(2.5)
    assert c.labels("a").value == 3.5 and c.labels("b").value == 0.0
    with pytest.raises(ValueError):
        c.labels("a").inc(-1)
    g = reg.gauge("g", "a gauge")
    g.set(5)
    g.dec(2)
    assert g.value == 3.0
    h = reg.histogram("h_seconds", "a histogram", buckets=(1.0, 10.0))
    for v in (0.5, 0.7, 5.0, 100.0):
        h.observe(v)
    assert h.labels().count == 4 and h.labels().sum == pytest.approx(106.2)
    assert h.labels().bucket_counts() == [2, 1, 1]
    c.remove("a")
    assert ("a",) not in c.children()


def test_declaration_idempotent_conflicts_and_label_arity():
    reg = MetricsRegistry()
    a = reg.counter("x_total", "x", labels=("l",))
    assert reg.counter("x_total", "x", labels=("l",)) is a
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x", labels=("l",))
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", labels=("other",))
    c = reg.counter("kw_total", "kw", labels=("a", "b"))
    assert c.labels(a="1", b="2") is c.labels("1", "2")
    with pytest.raises(ValueError):
        c.labels("only-one")


def test_concurrent_updates_lose_nothing():
    reg = MetricsRegistry()
    counter = reg.counter("hits_total", "hits", labels=("worker",))
    hist = reg.histogram("lat_seconds", "lat")

    def hammer(idx):
        child = counter.labels(f"w{idx % 4}")
        for i in range(2000):
            child.inc()
            hist.observe(0.001 * (i % 7))

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(ch.value for ch in counter.children().values()) == 20000
    assert hist.labels().count == 20000


def test_default_buckets_equal_jax():
    assert port_registry.DEFAULT_TIME_BUCKETS == jax_registry.DEFAULT_TIME_BUCKETS
    assert log_buckets(1e-3, 1.0, factor=10) == jax_registry.log_buckets(1e-3, 1.0, factor=10)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_equal_jax(q):
    port, jax = _fill(port_registry), _fill(jax_registry)
    for stage in ("decode", "wait"):
        got = port.families()["lat_seconds"].labels(stage).quantile(q)
        assert got == jax.families()["lat_seconds"].labels(stage).quantile(q)
        assert got is not None
    assert port.families()["small_seconds"].labels().quantile(q) == \
        jax.families()["small_seconds"].labels().quantile(q)
    empty = MetricsRegistry().histogram("e_seconds", "empty")
    assert empty.labels().quantile(q) is None


# -- exposition and snapshots --------------------------------------------------

def test_prometheus_text_equals_jax_line_for_line():
    port = expose_prometheus(_fill(port_registry)).split("\n")
    jax = jax_registry.expose_prometheus(_fill(jax_registry)).split("\n")
    assert port == jax
    assert 'evil_total{a="x\\\\y",b="va\\"l\\n"} 2' in port
    assert 'small_seconds_bucket{le="+Inf"} 4' in port
    assert "# TYPE declared_only_total counter" in port


def test_snapshot_equals_jax():
    assert _fill(port_registry).snapshot() == _fill(jax_registry).snapshot()


def test_port_families_equal_the_jax_families_of_the_same_names():
    """Every family the port declares has the JAX family's name, help,
    type, labels and buckets: the two scrapes share a vocabulary."""
    from petastorm_tpu.telemetry import metrics as jax_metrics
    from petastorm_tpu_torch.telemetry import metrics as port_metrics

    port = {name: value for name, value in vars(port_metrics).items()
            if isinstance(value, port_registry.MetricFamily)}
    # 25, the autotuner's five, the data service's 22, its control plane's 12,
    # dynamic sharding's three, the data plane of one host's seven, the
    # fleet's 15 and the LLM stages' nine.
    assert len(port) == 98
    for name, family in port.items():
        twin = getattr(jax_metrics, name)
        assert (family.name, family.help, family.kind, family.label_names, family.buckets) \
            == (twin.name, twin.help, twin.kind, twin.label_names, twin.buckets), name
    text = expose_prometheus(port_registry.REGISTRY)
    for family in port.values():
        assert f"# TYPE {family.name} {family.kind}" in text


def test_snapshot_ring_rate_equals_jax_on_the_same_snapshots():
    snaps = []
    for scale in (1, 3):
        reg = _fill(port_registry)
        reg.families()["evil_total"].labels("plain", "0").inc(100 * scale)
        snaps.append(reg.snapshot())
    port = SnapshotRing(MetricsRegistry(), interval_s=60.0)
    jax = jax_registry.SnapshotRing(jax_registry.MetricsRegistry(), interval_s=60.0)
    for ring in (port, jax):
        ring._snaps = [(10.0, snaps[0]), (12.0, snaps[1]), (14.0, snaps[1])]
    for args in (("evil_total",), ("evil_total", {"b": "plain"}),
                 ("lat_seconds", {"stage": "wait"}), ("missing_total",)):
        for window in (None, 2.0):
            assert port.rate(*args, window_s=window) == jax.rate(*args, window_s=window)
    assert port.rate("evil_total") == pytest.approx(200 / 4)
    assert port.rate("evil_total", window_s=2.0) == 0.0


def test_snapshot_ring_rates_and_bound():
    reg = MetricsRegistry()
    c = reg.counter("rows_total", "rows", labels=("w",))
    ring = SnapshotRing(reg, interval_s=60.0, capacity=3)
    ring.take()
    c.labels("w0").inc(100)
    c.labels("w1").inc(50)
    time.sleep(0.02)
    ring.take()
    assert ring.rate("rows_total") > 0
    assert ring.rate("rows_total", labels={"w": "w0"}) == pytest.approx(
        2 * ring.rate("rows_total", labels={"w": "w1"}))
    for _ in range(5):
        ring.take()
    assert len(ring.snapshots()) == 3


# -- HTTP exposition -------------------------------------------------------------

@pytest.mark.parametrize("factory", ["MetricsServer", "start_metrics_server"])
def test_metrics_server_routes(factory):
    from petastorm_tpu_torch.telemetry import MetricsServer, start_metrics_server

    reg = _fill(port_registry)
    served = reg.counter("served_total", "served")
    served.inc(3)
    server = (MetricsServer(registry=reg, port=0, snapshot_interval_s=0.05).start()
              if factory == "MetricsServer"
              else start_metrics_server(0, registry=reg, snapshot_interval_s=0.05))
    try:
        host, port = server.address

        def get(path):
            with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=5) as resp:
                return resp.status, resp.headers.get("Content-Type"), resp.read().decode()

        status, ctype, text = get("/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert text == expose_prometheus(reg)
        status, _, body = get("/metrics.json")
        assert json.loads(body) == json.loads(json.dumps(reg.snapshot()))
        served.inc(10)
        # Wait for a snapshot taken after the increment: the ring's first
        # snapshots may all predate it (the GETs above can outlast several
        # 50 ms intervals under load), and /rates would then difference
        # two snapshots that both hold 3.
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            snaps = server.ring.snapshots()
            if snaps and server.ring._series_value(snaps[-1][1], "served_total", None) == 13:
                break
            time.sleep(0.02)
        rates = json.loads(get("/rates")[2])
        assert rates["per_second"]["served_total"] > 0 and rates["window_s"] > 0
        assert get("/healthz")[::2] == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        server.stop()


# -- flight recorder -------------------------------------------------------------

def test_flight_ring_bounded_and_dumped(tmp_path, monkeypatch):
    from petastorm_tpu_torch.telemetry.flight import FlightRecorder
    from petastorm_tpu_torch.telemetry.metrics import FLIGHT_DUMPS, FLIGHT_EVENTS

    monkeypatch.setenv("PETASTORM_FLIGHT_DIR", str(tmp_path))
    events0, dumps0 = FLIGHT_EVENTS.value, FLIGHT_DUMPS.labels("invariant").value
    rec = FlightRecorder(capacity=3)
    rec.set_context(role="trainer", worker_id="w-1")
    rec.set_context(worker_id=None)
    for i in range(5):
        rec.note("step", i=i)
    events = rec.snapshot()
    assert [e["i"] for e in events] == [2, 3, 4]
    assert events == sorted(events, key=lambda e: e["t_us"])
    path = rec.dump("invariant: loss is nan")
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == f"flight-{os.getpid()}-invariant--loss-is-nan.json"
    with open(path) as f:
        doc = json.load(f)
    assert doc == {"reason": "invariant: loss is nan", "pid": os.getpid(),
                   "context": {"role": "trainer"}, "total_events": 5, "events": events}
    assert FLIGHT_EVENTS.value - events0 == 5
    assert FLIGHT_DUMPS.labels("invariant").value - dumps0 == 1
    assert rec.dump("x", path=str(tmp_path / "missing" / "f.json")) is None


def test_flight_install_chains_the_thread_excepthook(tmp_path, monkeypatch):
    from petastorm_tpu_torch.telemetry import flight

    monkeypatch.setenv("PETASTORM_FLIGHT_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args.exc_type))
    monkeypatch.setattr(flight, "_installed", False)
    monkeypatch.setattr(flight, "_prev_excepthook", None)
    try:
        assert flight.install(capture_signals=False) is flight.RECORDER
        assert flight.install(capture_signals=False) is flight.RECORDER  # idempotent
        thread = threading.Thread(target=lambda: 1 / 0, name="crashing-thread")
        thread.start()
        thread.join()
    finally:
        threading.excepthook = flight._prev_excepthook or threading.excepthook
    assert seen == [ZeroDivisionError]  # the previous hook still ran
    last = flight.RECORDER.snapshot()[-1]
    assert last["event"] == "unhandled_thread_exception"
    assert last["thread"] == "crashing-thread" and last["error"] == "ZeroDivisionError"
    dump = tmp_path / f"flight-{os.getpid()}-thread-crash-crashing-thread.json"
    assert json.loads(dump.read_text())["events"][-1] == last


# -- structured log --------------------------------------------------------------

def test_structured_log_lines_equal_jax(caplog):
    from petastorm_tpu.telemetry.log import service_logger as jax_service_logger
    from petastorm_tpu_torch.telemetry.log import service_logger

    port = service_logger("petastorm_tpu_torch.some_module", job="j").bind(worker_id="w-1")
    jax = jax_service_logger("petastorm_tpu.some_module", job="j").bind(worker_id="w-1")
    assert port.name == "petastorm_tpu_torch.service.some_module"
    assert service_logger("thirdparty.mod").name == "thirdparty.mod"
    with caplog.at_level(logging.INFO):
        for log in (port, jax):
            log.warning("lease missed after %.1fs", 2.5, attempt=7)
            log.info("token %s", "tok-1", client_id="cli-100%d", reason="50% stalled")
            log.error("bad format %d", "not-a-number")
            log.debug("dropped below the level", x=1)
        assert port.isEnabledFor(logging.INFO) and not port.isEnabledFor(logging.DEBUG)
    messages = [r.getMessage() for r in caplog.records]
    assert messages[:3] == messages[3:]
    assert messages[0] == "lease missed after 2.5s | job=j worker_id=w-1 attempt=7"
    assert messages[1] == ("token tok-1 | job=j worker_id=w-1 client_id=cli-100%d "
                           "reason=50% stalled")
    assert messages[2].startswith("bad format %d ('not-a-number',) | job=j")


# -- tracing's module functions -----------------------------------------------

def test_tracing_module_functions(tmp_path):
    from petastorm_tpu_torch.telemetry import COLLECTOR, tracing

    t0 = time.perf_counter()
    now = tracing.wall_us()
    assert COLLECTOR.ts_us(t0) <= now <= COLLECTOR.ts_us(time.perf_counter())
    try:
        assert tracing.enable() is COLLECTOR and COLLECTOR.enabled
        COLLECTOR.clear()
        t0 = time.perf_counter()
        tracing.record_span("loader.decode", t0, t0 + 0.01, bid="b0", args={"rows": 4})
        path = tmp_path / "trace.json"
        assert tracing.export(str(path)) == 2
        begin, end = json.loads(path.read_text())["traceEvents"]
        assert (begin["ph"], end["ph"], begin["args"]) == ("B", "E", {"rows": 4, "bid": "b0"})
        # The wall-anchored timebase holds ~1.8e15 us, whose float64 step is
        # 0.25 us: the span's ends are held to the timebase exactly, and the
        # timebase to microseconds.
        assert begin["ts"] == COLLECTOR.ts_us(t0)
        assert end["ts"] == COLLECTOR.ts_us(t0 + 0.01)
        assert COLLECTOR.ts_us(t0 + 1.0) - COLLECTOR.ts_us(t0) == pytest.approx(1e6)
    finally:
        tracing.disable()
        COLLECTOR.clear()
    assert not COLLECTOR.enabled
    tracing.record_span("loader.decode", 0.0, 1.0)
    assert COLLECTOR.events() == []


# -- tracing.span --------------------------------------------------------------

#: How far apart a span's ends may lie in the two sinks after the fit on a
#: shared CPU: the sinks read their clocks a few microseconds apart, and a
#: test worker can be descheduled between the two reads.
FIT_TOLERANCE_US = 100.0


@pytest.fixture
def collector():
    from petastorm_tpu_torch.telemetry import COLLECTOR

    COLLECTOR.disable()
    COLLECTOR.clear()
    try:
        yield COLLECTOR
    finally:
        COLLECTOR.disable()
        COLLECTOR.clear()


def _spans(collector, tid=None):
    """``(name, tid, args)`` of each recorded span, in begin order."""
    return [(e["name"], e["tid"], e["args"]) for e in collector.events()
            if e["ph"] == "B" and (tid is None or e["tid"] == tid)]


def _tid():
    return threading.get_ident() % 1_000_000


def _span_on_another_thread(name):
    from petastorm_tpu_torch.telemetry import tracing

    def record():
        with tracing.span(name):
            pass

    thread = threading.Thread(target=record)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_span_records_into_the_collector_only_when_armed(collector):
    from petastorm_tpu_torch.telemetry import tracing

    with tracing.span("off", rows=1) as span:
        assert not span.armed
    assert collector.events() == []
    collector.acquire()
    with tracing.span("on", rows=2) as span:
        assert span.armed
        span.args["bytes"] = 8
    with tracing.span("dropped") as span:
        span.discard()
    _span_on_another_thread("other")
    collector.release()
    spans = _spans(collector)
    assert [(n, a) for n, _, a in spans] == [("on", {"rows": 2, "bytes": 8}), ("other", {})]
    assert spans[0][1] == _tid() != spans[1][1]
    begin, end = (e for e in collector.events() if e["name"] == "on")
    assert begin["ts"] <= end["ts"]


def test_span_enters_record_function_only_while_a_profiler_records(collector, monkeypatch):
    import torch.autograd.profiler as autograd_profiler

    from petastorm_tpu_torch.telemetry import tracing

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    with tracing.span("off"):
        pass
    collector.acquire()
    with tracing.span("collector.only"):
        pass
    collector.release()
    monkeypatch.undo()
    entered = []
    real = autograd_profiler.record_function

    def spy(name):
        entered.append((name, _tid()))
        return real(name)

    monkeypatch.setattr(autograd_profiler, "record_function", spy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("profiled"):
            pass
        _span_on_another_thread("elsewhere")
    assert entered == [("petastorm_tpu_torch.profiled", _tid())]
    assert "petastorm_tpu_torch.profiled" in {e.key for e in prof.key_averages()}
    assert [n for n, _, _ in _spans(collector)] == ["collector.only"]


def test_spans_in_both_sinks_line_up_after_the_fit(collector, tmp_path):
    from petastorm_tpu_torch.telemetry import tracing

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("warm_up"):  # the profiler's first range, ~1 ms late
            pass
        collector.acquire()
        for _ in range(20):
            with tracing.span("loader.wait"):
                time.sleep(0.001)
            with tracing.span("step.update"):
                torch.ones(64).sum()
        collector.release()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    offset, residuals = tracing.fit_profiler_clock(
        collector.events(), doc["traceEvents"], _tid(), doc.get("baseTimeNanoseconds", 0))
    assert len(residuals) == 2 * 2 * 20  # both ends of every span
    assert {n for _, n, _ in residuals} == {"loader.wait", "step.update"}
    worst = sorted(abs(r) for _, _, r in residuals)
    assert worst[len(worst) * 9 // 10] <= FIT_TOLERANCE_US
    assert worst[len(worst) // 2] <= FIT_TOLERANCE_US / 5
    # Both clocks read the wall clock at an anchor: they differ by far
    # less than a second.
    assert abs(offset) < 1e6


def test_tracing_imports_without_torch():
    code = ("import sys; from petastorm_tpu_torch.telemetry import tracing; "
            "tracing.COLLECTOR.acquire()\n"
            "with tracing.span('reader.decode'): pass\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert [e['name'] for e in tracing.COLLECTOR.events()] == ['reader.decode'] * 2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


# -- the program's spans -------------------------------------------------------

class _SleepWorker:
    """A pool worker that publishes each item back after a short sleep."""

    def __init__(self, worker_id, publish_func, args):
        self.publish_func = publish_func

    def process(self, item):
        time.sleep(0.002)
        self.publish_func(item)

    def shutdown(self):
        pass


def test_thread_pool_records_decode_on_workers_and_wait_on_the_consumer(collector):
    from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool

    pool = ThreadPool(3)
    collector.acquire()
    try:
        pool.start(_SleepWorker)
        workers = {t.ident % 1_000_000 for t in pool._threads}
        for i in range(12):
            pool.ventilate(i)
        assert sorted(pool.get_results() for _ in range(12)) == list(range(12))
    finally:
        pool.stop()
        pool.join()
        collector.release()
    spans = _spans(collector)
    decode = [tid for name, tid, _ in spans if name == "reader.decode"]
    queue_wait = [tid for name, tid, _ in spans if name == "reader.queue_wait"]
    wait = [tid for name, tid, _ in spans if name == "reader.wait"]
    assert len(decode) == 12 and set(decode) <= workers
    assert sorted(queue_wait) == sorted(decode)
    assert wait == [_tid()] * 12


def test_dummy_pool_records_one_decode_per_item_on_the_ventilating_thread(collector):
    from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool

    pool = DummyPool()
    collector.acquire()
    try:
        pool.start(_SleepWorker)
        for i in range(5):
            pool.ventilate(i)
        assert [pool.get_results() for _ in range(5)] == list(range(5))
    finally:
        pool.stop()
        pool.join()
        collector.release()
    assert _spans(collector) == [("reader.decode", _tid(), {})] * 5


def test_lm_step_records_forward_backward_update_once_a_step(collector):
    from petastorm_tpu_torch.models.long_context_lm import init_lm_params, make_lm_train_step

    model = init_lm_params(0, d_model=16, num_heads=2, num_layers=1, slot_len=8, device="cpu")
    step = make_lm_train_step(model, learning_rate=0.1, attn_impl="dense")
    tokens = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(0))
    positions = torch.arange(8).repeat(2, 1)
    segments = torch.zeros(2, 8, dtype=torch.int32)
    collector.acquire()
    for _ in range(2):
        step(tokens, positions, segments)
    collector.release()
    assert [n for n, _, _ in _spans(collector, _tid())] == \
        ["step.forward", "step.backward", "step.update"] * 2


def test_dlrm_step_records_collate_forward_backward_update_once_a_step(collector):
    from petastorm_tpu_torch.models.tabular_dlrm import DLRM, collate_dlrm, make_dlrm_train_step

    model = DLRM(vocab_size=32, embed_dim=4, bottom_hidden=8, top_hidden=8,
                 compute_dtype=torch.float32)
    step = make_dlrm_train_step(model, 0.05)
    gen = torch.Generator().manual_seed(0)
    batch = {f"dense_{i}": torch.rand(6, generator=gen) for i in range(13)}
    batch.update({f"cat_{i}": torch.randint(0, 32, (6,), generator=gen) for i in range(26)})
    batch["label"] = torch.randint(0, 2, (6,), generator=gen)
    collector.acquire()
    for _ in range(2):
        dense, sparse, labels = collate_dlrm(batch)
        step(dense, sparse, labels, torch.ones(6, dtype=torch.bool))
    collector.release()
    # Recorded as each span ends: the sparse table update's span (no group)
    # ends inside step.update's, so it comes first.
    assert [n for n, _, _ in _spans(collector, _tid())] == \
        ["dlrm.collate", "step.forward", "step.backward", "dlrm.sparse_update",
         "step.update"] * 2


# -- the loader's registry series ----------------------------------------------

def _source(n, fill_sleep=0.0, delay=0.0):
    def gen():
        for i in range(n):
            time.sleep(fill_sleep if i == 0 else delay)
            yield {"x": np.full(4, i, dtype=np.float32)}
    return gen


def _series(family, *labels):
    return family.children().get(tuple(labels))


def test_loader_diagnostics_agree_with_the_registry():
    from petastorm_tpu_torch.telemetry.metrics import (
        LOADER_BATCHES,
        LOADER_DISPATCH_OVERLAP,
        LOADER_ROWS,
        LOADER_STAGE_SECONDS,
    )
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    loader = TorchDataLoader(None, _source(3, delay=0.03), device="cpu")
    walls = []
    for i, _ in enumerate(loader):
        diag = loader.diagnostics
        walls.append(diag["wall_s"])
        if i == 1:
            assert diag["wall_s"] > 0.03 and diag["input_stall_pct"] > 0
    assert walls == sorted(walls)
    lid = loader.loader_id
    diag = loader.diagnostics
    assert diag["batches"] == _series(LOADER_BATCHES, lid).value == 3
    assert diag["rows"] == _series(LOADER_ROWS, lid).value == 12
    assert diag["stall_s"] == _series(LOADER_STAGE_SECONDS, lid, "wait").sum
    assert diag["producer_decode_s"] == _series(LOADER_STAGE_SECONDS, lid, "decode").sum
    assert diag["consumer_s"] == _series(LOADER_STAGE_SECONDS, lid, "consumer").sum
    assert diag["dispatch_overlap_pct"] == _series(LOADER_DISPATCH_OVERLAP, lid).value
    counts = {stage: _series(LOADER_STAGE_SECONDS, lid, stage).count
              for stage in ("decode", "queue_wait", "wait", "device_put", "consumer",
                            "raw_stage", "device_decode", "shard_put")}
    assert counts == {"decode": 4, "queue_wait": 3, "wait": 4, "device_put": 3,
                      "consumer": 3, "raw_stage": 0, "device_decode": 0, "shard_put": 0}
    quantiles = loader.stage_quantiles()
    assert set(quantiles) == set(counts)
    assert quantiles["shard_put"] == {"p50": None, "p99": None}
    assert 0 < quantiles["decode"]["p50"] <= quantiles["decode"]["p99"]
    # A second iteration restarts the per-iteration view, not the series.
    assert sum(1 for _ in loader) == 3
    assert loader.diagnostics["batches"] == 3
    assert _series(LOADER_BATCHES, lid).value == 6


def test_loader_exclude_stall_rebases_the_view_not_the_series():
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    loader = TorchDataLoader(None, _source(3, fill_sleep=0.05), device="cpu")
    for i, _ in enumerate(loader):
        if i == 0:
            assert loader.diagnostics["stall_s"] > 0.04
            loader.exclude_stall_so_far()
            assert loader.diagnostics["stall_s"] < 0.04
    assert loader.diagnostics["stall_s"] < 0.04
    assert loader._m_stage["wait"].sum > 0.04


def test_loader_series_retired_and_id_recycled_on_gc():
    from petastorm_tpu_torch.telemetry.metrics import LOADER_BATCHES, LOADER_STAGE_SECONDS
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    gc.collect()  # other tests' cyclic garbage must not land ids mid-test
    loader = TorchDataLoader(None, _source(1), device="cpu")
    assert sum(1 for _ in loader) == 1
    lid = loader.loader_id
    assert (lid,) in LOADER_BATCHES.children()
    del loader
    gc.collect()
    assert (lid,) not in LOADER_BATCHES.children()
    assert (lid, "wait") not in LOADER_STAGE_SECONDS.children()
    fresh = TorchDataLoader(None, _source(1), device="cpu")
    assert fresh.loader_id == lid and fresh._m_batches.value == 0.0


# -- one seeded workload, both packages ---------------------------------------

ROWS, GROUP, BATCH = 120, 20, 16


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import (
        CompressedImageCodec,
        NdarrayCodec,
        ScalarCodec,
    )
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("Telemetry", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, (8, 8, 3), CompressedImageCodec("png"), False),
        UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(5)
    url = f"file://{tmp_path_factory.mktemp('telemetry')}/store"
    materialize_rows(url, schema, ({"id": np.int64(i),
                                    "image": rng.randint(0, 256, (8, 8, 3), dtype=np.uint8),
                                    "vec": rng.rand(4).astype(np.float32)}
                                   for i in range(ROWS)), rows_per_row_group=GROUP)
    return url


_COUNTED = {
    "petastorm_pool_items_ventilated_total", "petastorm_pool_items_processed_total",
    "petastorm_pool_results_queue_depth", "petastorm_ventilator_items_ventilated_total",
    "petastorm_ventilator_epochs_completed_total", "petastorm_reader_readers_total",
    "petastorm_cache_hits_total", "petastorm_cache_misses_total", "petastorm_cache_bytes",
    "petastorm_cache_entries", "petastorm_cache_evictions_total",
    "petastorm_cache_fill_seconds", "petastorm_cache_serve_seconds",
    "petastorm_cache_corrupt_entries_total", "petastorm_cache_permuted_serves_total",
    "petastorm_cache_version_evicted_total", "petastorm_cache_disk_write_errors_total",
}


def _counts(reg, loader_id):
    """The counted families' values (histograms: their counts), summed per
    label set, and the loader's own series, from a snapshot."""
    out = {}
    for name, family in reg.snapshot().items():
        for series in family["series"]:
            labels = dict(series["labels"])
            if name.startswith("petastorm_loader_"):
                if labels.pop("loader") != loader_id:
                    continue
            elif name not in _COUNTED:
                continue
            value = series["count"] if family["type"] == "histogram" else series["value"]
            out[(name, tuple(sorted(labels.items())))] = value
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _run(package, url, cache_dir):
    """A thread-pool reader (2 workers, 2 epochs, seeded) into a loader
    with a memory + disk cache: a fill pass and a replay pass, then the
    loader's registry counts over the run."""
    if package == "port":
        from petastorm_tpu_torch.cache_impl.batch_cache import BatchCache
        from petastorm_tpu_torch.reader.reader import make_reader
        from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

        reg = port_registry.REGISTRY
        make_loader = lambda r, c: make_torch_dataloader(  # noqa: E731
            r, BATCH, last_batch="keep", device="cpu", batch_cache=c)
    else:
        from petastorm_tpu.cache_impl.batch_cache import BatchCache
        from petastorm_tpu.jax_utils.loader import JaxDataLoader
        from petastorm_tpu.reader.reader import make_reader

        reg = jax_registry.REGISTRY
        make_loader = lambda r, c: JaxDataLoader(  # noqa: E731
            r, BATCH, last_batch="keep", batch_cache=c)
    before = _counts(reg, None)
    cache = BatchCache(mem_budget_bytes=1 << 20, cache_dir=cache_dir, spill_to_disk=True)
    reader = make_reader(url, reader_pool_type="thread", workers_count=2, num_epochs=1,
                         shuffle_row_groups=True, shard_seed=7)
    loader = make_loader(reader, cache)
    batches = []
    try:
        with loader:
            for _ in range(2):
                batches.append(sum(1 for _ in loader))
        after = _counts(reg, loader._loader_id)
        loader_series = {k: v for k, v in after.items() if k[0].startswith("petastorm_loader_")}
    finally:
        cache.cleanup()
    return batches, {**_delta(after, before), **loader_series}


def test_registry_counts_equal_jax_for_one_seeded_workload(store, tmp_path):
    port_batches, port = _run("port", store, str(tmp_path / "port_cache"))
    jax_batches, jax = _run("jax", store, str(tmp_path / "jax_cache"))
    assert port_batches == jax_batches == [-(-ROWS // BATCH)] * 2
    loader_keys = {k for k in port if k[0] == "petastorm_loader_stage_seconds"}
    assert loader_keys and port.keys() == jax.keys()
    # seconds are not counts: the overlap gauge is left out
    del port[("petastorm_loader_dispatch_overlap_pct", ())]
    del jax[("petastorm_loader_dispatch_overlap_pct", ())]
    # The two workers publish row groups as they finish, so the batches'
    # contents follow that order, and each disk entry's header holds its
    # crc32 in decimal, 9 or 10 digits: the disk tier's bytes may differ by
    # one byte an entry, and every other count is equal.
    disk = [k for k in port if k[0] == "petastorm_cache_bytes" and ("tier", "disk") in k[1]]
    entries = [k for k in port if k[0] == "petastorm_cache_entries" and ("tier", "disk") in k[1]]
    assert len(disk) == len(entries) == 1 and port[entries[0]] > 0
    assert abs(port.pop(disk[0]) - jax.pop(disk[0])) <= port[entries[0]]
    assert port == jax
    assert port[("petastorm_pool_items_processed_total", ())] == ROWS // GROUP
    assert port[("petastorm_cache_hits_total", (("tier", "mem"),))] == 1
    assert port[("petastorm_loader_batches_total", ())] == 2 * -(-ROWS // BATCH)
