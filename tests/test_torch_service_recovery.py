"""Failure, resume, the CLI and the service's wiring into the loader, the
graph and the registry, against the JAX package where it has a twin.

- An in-process worker kill mid-epoch loses no row under static sharding
  (batch and row factories); with ``ordered=True`` the killed run yields
  exactly the uninterrupted run's batches (exactly once, at the
  watermarks); an fcfs kill loses no row.
- ``TorchDataLoader.state_dict()`` delegates to the source with the
  batches it has yielded; the state equals the JAX loader's at the same
  position, and resuming either package's state re-reads what the JAX
  resume re-reads; fcfs refuses ``state_dict`` and ``resume_state``.
- A worker that stops its heartbeats loses its lease and re-registers
  when they resume.
- The CLI starts a dispatcher and a worker; the ``status`` command.
- Every argument and request of the JAX service is taken; the control
  plane's arguments (the journal, brownout, breakers, retry
  budgets, hedging, quarantine) are taken.
- ``build_loader_graph`` over a service source gives the JAX graph's
  stages, knobs and signals.
- The service's metric families equal the JAX families of the same names,
  and a loopback run moves them as the JAX fleet's run does.

A real-subprocess SIGKILL of a worker is marked ``slow`` (it starts a
fresh interpreter and waits out reconnect backoff). Each test stops every
node it starts and bounds its own waits. Everything is compared exactly.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import service as jax_service
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
from petastorm_tpu_torch.service import BatchWorker, Dispatcher, ServiceBatchSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scalar_store(tmp_path_factory):
    """Plain Parquet: 120 rows in 24 row groups of 5."""
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path_factory.mktemp('rec')}/scalar"
    create_test_scalar_dataset(url, rows_count=120, rows_per_row_group=5)
    return url


@pytest.fixture(scope="module")
def row_store(tmp_path_factory):
    """The factories' TestSchema store: 60 rows in 6 row groups of 10."""
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_dataset

    url = f"file://{tmp_path_factory.mktemp('rec')}/rows"
    create_test_dataset(url, rows_count=60, rows_per_row_group=10)
    return url


class Fleet:
    """A dispatcher and workers of one package, stopped by :meth:`stop`."""

    def __init__(self, url, package=port_service, mode="static", workers=2, batch_size=4,
                 factory="batch", shuffle_seed=None, num_epochs=1, prefix="w",
                 **dispatcher_kwargs):
        self.dispatcher = package.Dispatcher(mode=mode, num_epochs=num_epochs,
                                             shuffle_seed=shuffle_seed,
                                             **dispatcher_kwargs).start()
        self.workers = []
        try:
            for i in range(workers):
                self.workers.append(package.BatchWorker(
                    url, dispatcher_address=self.dispatcher.address, batch_size=batch_size,
                    reader_factory=factory, worker_id=f"{prefix}{i}",
                    reader_kwargs={"workers_count": 2}).start())
        except BaseException:
            self.stop()
            raise

    def stop(self):
        for worker in self.workers:
            worker.stop()
        self.dispatcher.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _ids(batch):
    return [int(i) for i in np.asarray(batch["id"])]


def _fast_source(fleet, **kwargs):
    return ServiceBatchSource(fleet.dispatcher.address, max_retries=1, backoff_base=0.02,
                              backoff_max=0.05, **kwargs)


# ---------------------------------------------------------------------------
# worker failure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factory", ["batch", "row"])
def test_worker_kill_mid_epoch_loses_no_rows(scalar_store, row_store, factory):
    url, rows = (scalar_store, 120) if factory == "batch" else (row_store, 60)
    with Fleet(url, factory=factory) as fleet:
        source = _fast_source(fleet, credits=2)
        got, killed = [], False
        for batch in source():
            got.extend(_ids(batch))
            if not killed and len(got) >= 12:
                fleet.workers[1].kill()
                killed = True
        assert killed
        recovery = source.diagnostics["recovery"]
    assert sorted(set(got)) == list(range(rows))  # no row lost
    assert recovery["takeovers"] == 1
    assert len(got) == rows  # exactly once: the survivors start at the watermarks


def test_ordered_kill_yields_the_uninterrupted_batches(scalar_store):
    runs = []
    for kill in (False, True):
        with Fleet(scalar_store, shuffle_seed=4, workers=3) as fleet:
            source = _fast_source(fleet, credits=2, ordered=True)
            out = []
            for batch in source():
                out.append(_ids(batch))
                if kill and len(out) == 7:
                    fleet.workers[0].kill()
            runs.append(out)
    assert runs[0] == runs[1]
    assert sorted(sum(runs[1], [])) == list(range(120))


def test_fcfs_worker_kill_loses_no_rows(scalar_store):
    with Fleet(scalar_store, mode="fcfs") as fleet:
        got, killed = [], False
        for batch in _fast_source(fleet)():
            got.extend(_ids(batch))
            if not killed and len(got) >= 8:
                fleet.workers[0].kill()
                killed = True
    assert killed and sorted(set(got)) == list(range(120))


# ---------------------------------------------------------------------------
# checkpoint and resume through the loaders
# ---------------------------------------------------------------------------

def _loader(package, source):
    if package is port_service:
        from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

        return TorchDataLoader(None, source, device="cpu")
    from petastorm_tpu.jax_utils.loader import JaxDataLoader

    return JaxDataLoader(None, 4, batch_source=source, stage_to_device=False)


def _consume(loader, stop_after=None):
    """Batches' ids until ``stop_after`` batches; the state at that point."""
    ids, state = [], None
    it = iter(loader)
    try:
        for i, batch in enumerate(it):
            ids.append(_ids(batch))
            if stop_after is not None and i + 1 == stop_after:
                state = loader.state_dict()
                break
    finally:
        it.close()
    return ids, state


@pytest.mark.parametrize("stop_after", [1, 9, 29])
def test_loader_state_dict_delegates_and_resumes_like_jax(scalar_store, stop_after):
    results = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        with Fleet(scalar_store, package=package, shuffle_seed=2, workers=3) as fleet:
            source = package.ServiceBatchSource(fleet.dispatcher.address, credits=2,
                                                ordered=True)
            first, state = _consume(_loader(package, source), stop_after)
            resumed = package.ServiceBatchSource(fleet.dispatcher.address, credits=2,
                                                 ordered=True, resume_state=state)
            results[name] = {"first": first, "state": state,
                             "rest": _consume(_loader(package, resumed))[0]}
    assert results["port"]["state"] == results["jax"]["state"]
    assert results["port"]["first"] == results["jax"]["first"]
    assert results["port"]["rest"] == results["jax"]["rest"]
    delivered = sum(results["port"]["first"] + results["port"]["rest"], [])
    assert sorted(delivered) == list(range(120))  # the two runs cover every row once
    assert results["port"]["state"]["epoch"] == 0
    # A JAX-written state resumes the port's fleet to the same rows.
    with Fleet(scalar_store, shuffle_seed=2, workers=3) as fleet:
        resumed = ServiceBatchSource(fleet.dispatcher.address, credits=2, ordered=True,
                                     resume_state=results["jax"]["state"])
        assert _consume(_loader(port_service, resumed))[0] == results["jax"]["rest"]


def test_state_dict_follows_the_consumer_position(scalar_store):
    with Fleet(scalar_store) as fleet:
        source = ServiceBatchSource(fleet.dispatcher.address)
        total = sum(1 for _ in source())
        assert total == 24 * 2  # 5-row pieces in batches of 4: 4 + 1 each
        assert (source.state_dict(yielded_batches=0)["epoch"],
                source.state_dict(yielded_batches=0)["completed_pieces"]) == (0, [])
        mid = source.state_dict(yielded_batches=total - 1)
        # A piece completes at its marker, which may trail its last batch:
        # completed pieces plus watermarks leave exactly one batch to serve.
        assert mid["epoch"] == 0 and len(mid["completed_pieces"]) < 24
        assert 2 * (24 - len(mid["completed_pieces"])) - sum(mid["watermarks"].values()) == 1
        end = source.state_dict(yielded_batches=total)
        assert (end["epoch"], end["completed_pieces"]) == (1, []) and source.state_dict() == end


def test_fcfs_refuses_state_dict_and_resume_state(scalar_store):
    with Fleet(scalar_store, mode="fcfs", workers=1) as fleet:
        source = ServiceBatchSource(fleet.dispatcher.address)
        assert len(sum((_ids(b) for b in source()), [])) == 120
        with pytest.raises(ValueError, match="fcfs"):
            source.state_dict()
        state = {"version": 2, "mode": "static", "client_index": 0, "num_clients": 1,
                 "epoch": 0, "completed_pieces": [0]}
        with pytest.raises(ValueError, match="resume_state was supplied"):
            ServiceBatchSource(fleet.dispatcher.address, resume_state=state)()
    with Fleet(scalar_store, mode="fcfs", workers=1) as fleet:  # a fresh queue
        from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

        loader = TorchDataLoader(None, ServiceBatchSource(fleet.dispatcher.address),
                                 device="cpu")
        with pytest.raises(ValueError, match="fcfs"):
            _consume(loader, stop_after=2)
    for bad, match in ((dict(state, version=9), "version"), (dict(state, mode="fcfs"), "mode"),
                       (dict(state, num_clients=2), "num_clients"),
                       (dict(state, packing={"slots": 2}), "packing")):
        with pytest.raises(ValueError, match=match):
            ServiceBatchSource(("127.0.0.1", 1), resume_state=bad)


def test_loader_refuses_state_dict_for_a_source_without_one():
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    loader = TorchDataLoader(None, lambda: iter(()), device="cpu")
    with pytest.raises(ValueError, match="no state_dict|custom batch_source"):
        loader.state_dict()


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------

def _status(dispatcher):
    with FramedConnection.connect(dispatcher.address, timeout=5) as conn:
        return conn.request({"type": "status"})[0]


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_lease_expiry_evicts_a_silent_worker_and_heartbeats_readmit_it(scalar_store):
    dispatcher = Dispatcher(lease_timeout_s=0.4).start()
    worker = BatchWorker(scalar_store, dispatcher_address=dispatcher.address, worker_id="hb",
                         heartbeat_interval_s=0.05)
    try:
        worker.start()
        assert _wait(lambda: _status(dispatcher)["workers"]["hb"]["alive"])
        worker.pause_heartbeats()
        assert _wait(lambda: not _status(dispatcher)["workers"]["hb"]["alive"])
        status = _status(dispatcher)
        assert status["fencing_epoch"] == 1 and status["recovery"]["evictions"] == 1
        worker.resume_heartbeats()  # unknown_worker → re-registration
        assert _wait(lambda: _status(dispatcher)["workers"]["hb"]["alive"])
        assert _status(dispatcher)["recovery"]["re_registrations"] >= 1
    finally:
        worker.stop()
        dispatcher.stop()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_runs_a_dispatcher_and_a_worker(scalar_store, capsys):
    from petastorm_tpu_torch.service.cli import main, parse_address

    assert parse_address("10.0.0.1:7077") == ("10.0.0.1", 7077)
    assert parse_address("7077") == ("127.0.0.1", 7077)
    stop = threading.Event()
    threads, ready = [], {}

    def run(argv):
        thread = threading.Thread(target=main, args=(argv,),
                                  kwargs={"run_seconds": 30, "stop_event": stop}, daemon=True)
        thread.start()
        threads.append(thread)

    def wait_for(role):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and role not in ready:
            for line in capsys.readouterr().out.splitlines():
                if line.startswith("{"):
                    record = json.loads(line)
                    ready[record.get("role", "status")] = record
            time.sleep(0.05)
        return ready[role]

    try:
        run(["dispatcher", "--port", "0", "--mode", "static", "--metrics-port", "0"])
        port = wait_for("dispatcher")["port"]
        run(["worker", "--dispatcher", f"127.0.0.1:{port}", "--dataset-url", scalar_store,
             "--reader", "batch", "--batch-size", "6", "--workers-count", "2",
             "--worker-id", "cli-w", "--metrics-port", "0"])
        worker = wait_for("worker")
        assert worker["worker_id"] == "cli-w" and worker["metrics_port"] > 0
        source = ServiceBatchSource(("127.0.0.1", port))
        got = sorted(sum((_ids(b) for b in source()), []))
        assert got == list(range(120))
        assert main(["status", "--dispatcher", f"127.0.0.1:{port}"]) == 0
        status = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert status["workers"]["cli-w"]["metrics_port"] == worker["metrics_port"]
        assert status["metrics_address"][1] == ready["dispatcher"]["metrics_port"]
    finally:
        stop.set()
        for thread in threads:
            thread.join(timeout=15)
    assert not any(thread.is_alive() for thread in threads)


@pytest.mark.parametrize("argv", [
    ["dispatcher", "--port", "0", "--mode", "dynamic"],
    ["dispatcher", "--port", "0", "--autoscale"],
    ["worker", "--dataset-url", "file:///x", "--cache", "mem"],
    ["worker", "--dataset-url", "file:///x", "--standby"],
    ["worker", "--dataset-url", "file:///x", "--on-piece-error", "quarantine"],
    ["worker", "--dataset-url", "file:///x", "--corpus", "web"],
    ["worker", "--dataset-url", "file:///x", "--cache", "mem", "--fleet-cache"],
    ["worker", "--dataset-url", "file:///x", "--transport", "shm"],
], ids=["dynamic", "autoscale", "cache", "standby", "quarantine", "corpus", "fleet-cache",
        "shm"])
def test_cli_refusals_name_their_slice(argv):
    """No flag is refused by slice any more: ``--mode dynamic``,
    ``--autoscale``, ``--standby``, ``--fleet-cache``, ``--on-piece-error
    quarantine``, ``--cache``, ``--transport shm`` and ``--corpus``
    build their node, as the JAX CLI's do."""
    from petastorm_tpu.service.cli import _build_parser as jax_parser
    from petastorm_tpu.service.cli import build_service_node as jax_build
    from petastorm_tpu_torch.service.cli import _build_parser, build_service_node

    node = build_service_node(_build_parser().parse_args(argv))
    if argv[0] == "dispatcher":
        assert isinstance(node, Dispatcher)
        if "--autoscale" in argv:
            twin = jax_build(jax_parser().parse_args(argv))
            assert node._autoscaler is not None and twin._autoscaler is not None
            assert vars(node._autoscaler._config) == vars(twin._autoscaler._config)
        else:
            assert node.mode == "dynamic"
    elif "--fleet-cache" in argv:
        try:
            assert node._fleet_tier is not None
            assert node._batch_cache.stats()["tier"] == "fleet"
        finally:
            node._batch_cache.cleanup()
    elif "--standby" in argv:
        assert isinstance(node, BatchWorker) and node._standby is True
    elif "--cache" in argv:
        twin = jax_build(jax_parser().parse_args(argv))
        try:
            assert node._batch_cache.stats() == twin._batch_cache.stats()
        finally:
            node._batch_cache.cleanup()
            twin._batch_cache.cleanup()
    elif "--transport" in argv:
        twin = jax_build(jax_parser().parse_args(argv))
        assert node._transport_mode == twin._transport_mode == "shm"
    elif "--corpus" in argv:
        twin = jax_build(jax_parser().parse_args(argv))
        assert node.corpus == twin.corpus == "web"
    else:
        assert isinstance(node, BatchWorker) and node._on_piece_error == "quarantine"


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

#: The arguments of the later service slices, each refused by slice once:
#: every one is taken now.
REFUSALS = [
    ("Dispatcher", {"mode": "dynamic"}),
    ("Dispatcher", {"autoscale": True}),
    ("BatchWorker", {"batch_cache": object()}),
    ("BatchWorker", {"fleet_cache": True}),
    ("BatchWorker", {"standby": True}),
    ("BatchWorker", {"on_piece_error": "quarantine"}),
    ("BatchWorker", {"corpus": "web"}),
    ("BatchWorker", {"transport": "shm"}),
    ("ServiceBatchSource", {"predicate": {"field": "id", "op": "ge", "value": 3}}),
    ("ServiceBatchSource", {"projection": ["id"]}),
    ("ServiceBatchSource", {"filter_placement": "worker"}),
    ("ServiceBatchSource", {"stage_fusion": "fused"}),
    ("ServiceBatchSource", {"cache_placement": "post-decode"}),
    ("ServiceBatchSource", {"reader_family": "columnar"}),
    ("ServiceBatchSource", {"packing": {"slot_len": 16, "slots": 2,
                                        "sequence_fields": ["id"]}}),
    ("ServiceBatchSource", {"corpus": "web"}),
    ("ServiceBatchSource", {"job_id": "train-a"}),
    ("ServiceBatchSource", {"transport": "shm"}),
]

#: What a ported argument needs beside it to be valid, as in the JAX source
#: (a hoisted filter needs a predicate, the post-decode stage a transform).
_COMPANIONS = {"filter_placement": {"predicate": {"field": "id", "op": "ge", "value": 3}},
               "cache_placement": {"transform": lambda batch: batch}}


@pytest.mark.parametrize("cls,kwargs", REFUSALS,
                         ids=[f"{c}-{next(iter(k))}" for c, k in REFUSALS])
def test_unported_arguments_name_their_slice(cls, kwargs):
    name, value = next(iter(kwargs.items()))
    if cls == "ServiceBatchSource":
        kwargs = dict(_COMPANIONS.get(name, {}), **kwargs)
    make = {"Dispatcher": lambda: Dispatcher(**kwargs),
            "BatchWorker": lambda: BatchWorker("file:///nowhere", **kwargs),
            "ServiceBatchSource": lambda: ServiceBatchSource(("127.0.0.1", 1), **kwargs)}[cls]
    if cls == "BatchWorker" and name == "fleet_cache":
        from petastorm_tpu_torch.cache_impl import BatchCache

        kwargs = dict(kwargs, batch_cache=BatchCache(mem_budget_bytes=1 << 20))
    node = make()
    if name == "autoscale":
        assert node._autoscaler is not None
    elif name == "fleet_cache":
        try:
            assert node._fleet_tier is node._batch_cache
        finally:
            node._batch_cache.cleanup()
    elif name == "job_id":
        assert node.job_id == value
    elif name == "predicate":
        assert node._predicate.to_wire() == value
    elif name == "transport":
        attr = "_transport_mode" if cls == "BatchWorker" else "_transport"
        assert getattr(node, attr) == value
    elif name == "corpus":
        assert node.corpus == value
    elif name == "packing":
        assert node.packing.to_dict() == dict(value, length_field=None)
    else:
        assert getattr(node, "mode" if name == "mode" else f"_{name}") == value


#: The control plane's arguments, refused before it was ported: each is taken.
PORTED = [
    ("Dispatcher", {"journal_dir": "journal"}),
    ("Dispatcher", {"brownout": True}),
    ("Dispatcher", {"breaker_cooldown_s": 3.0}),
    ("ServiceBatchSource", {"hedging": True}),
    ("ServiceBatchSource", {"retry_budget": 3.0}),
    ("ServiceBatchSource", {"breaker_threshold": 2}),
    ("ServiceBatchSource", {"breaker_cooldown_s": 1.0}),
    ("ServiceBatchSource", {"on_piece_error": "quarantine"}),
]


@pytest.mark.parametrize("cls,kwargs", PORTED,
                         ids=[f"{c}-{next(iter(k))}" for c, k in PORTED])
def test_control_plane_arguments_are_taken(cls, kwargs, tmp_path):
    name, value = next(iter(kwargs.items()))
    if cls == "Dispatcher":
        if name == "journal_dir":
            value = str(tmp_path / value)
        with Dispatcher(**{name: value}).start() as dispatcher:
            status = _status(dispatcher)
        if name == "journal_dir":
            assert status["journal"]["path"] == value
        if name == "brownout":
            assert status["fleet"]["brownout"]["armed"] is True
        if name == "breaker_cooldown_s":
            assert dispatcher.breaker_cooldown_s == value
        return
    source = ServiceBatchSource(("127.0.0.1", 1), **{name: value})
    resilience = source.diagnostics["resilience"]
    if name == "hedging":
        assert resilience["hedging"] is True
    elif name == "on_piece_error":
        assert source._on_piece_error == value
    else:
        attr = {"retry_budget": "_retry_budget_capacity",
                "breaker_threshold": "_breaker_threshold",
                "breaker_cooldown_s": "_breaker_cooldown_s"}[name]
        assert getattr(source, attr) == value


def test_later_slice_requests_are_refused_by_name(scalar_store):
    """No request is refused by slice any more: ``set_mixture_weights`` and
    ``get_mixture`` are served, and a ``list_workers`` scoped to a corpus
    answers as the JAX dispatcher's does (its own corpus's workers only);
    ``dynamic_plan`` is refused by a static dispatcher as a dynamic-mode
    request, the fleet's ``register_job``, ``end_job`` and ``cache_handoff``
    are served, and a ``dynamic`` stream is served (piece, generation and
    ordinal tagged). The replies are compared exactly."""
    replies = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        with Fleet(scalar_store, package=package, workers=1,
                   prefix=f"late-{name}-") as fleet:
            got = replies[name] = {}
            for kind in ("dynamic_plan", "register_job", "set_mixture_weights",
                         "get_mixture", "end_job", "cache_handoff"):
                with FramedConnection.connect(fleet.dispatcher.address, timeout=5) as conn:
                    got[kind] = conn.request({"type": kind, "client_id": "c",
                                              "client_index": 0, "num_clients": 1,
                                              "job_id": "tenant", "worker_id": "w0",
                                              "weights": {"web": 0.25, "code": 0.75},
                                              "effective_epoch": 1, "token": "t1"})[0]
            for corpus in ("web", ""):
                with FramedConnection.connect(fleet.dispatcher.address, timeout=5) as conn:
                    reply = conn.request({"type": "list_workers", "corpus": corpus})[0]
                got[f"list_workers {corpus!r}"] = dict(reply, workers=sorted(reply["workers"]))
            if package is port_service:
                with FramedConnection.connect(fleet.workers[0].address, timeout=5) as conn:
                    stream = conn.request({"type": "stream", "pieces": [[0, 3]], "epoch": 0,
                                           "dynamic": True})[0]
    port, jax = replies["port"], replies["jax"]
    assert port["list_workers 'web'"] == jax["list_workers 'web'"]
    assert port["list_workers 'web'"]["workers"] == [] \
        and port["list_workers 'web'"]["num_pieces"] is None
    assert port["list_workers ''"]["workers"] == ["late-port-0"]
    assert jax["list_workers ''"]["workers"] == ["late-jax-0"]
    for kind in ("dynamic_plan", "register_job", "set_mixture_weights", "get_mixture",
                 "end_job", "cache_handoff"):
        assert port[kind] == jax[kind], kind
    assert port["set_mixture_weights"] == {
        "type": "ok", "job_id": "tenant", "seq": 1, "fencing_epoch": 0,
        "entries": [{"seq": 1, "weights": {"web": 0.25, "code": 0.75}, "effective_epoch": 1}]}
    assert port["get_mixture"]["entries"] == port["set_mixture_weights"]["entries"]
    assert port["dynamic_plan"] == {"type": "error",
                                    "error": "dynamic_plan is a dynamic-mode request"}
    assert port["register_job"]["type"] == "ok" and not port["register_job"]["restarted"]
    assert port["end_job"] == {"type": "ok", "job_id": "tenant", "removed": True}
    assert port["cache_handoff"] == {"type": "ok", "kept": 1}
    assert (stream["type"], stream["piece"], stream["generation"], stream["ordinal"]) == \
        ("batch", 0, 3, 0)


# ---------------------------------------------------------------------------
# the graph and the registry
# ---------------------------------------------------------------------------

def test_build_loader_graph_on_a_service_source_equals_jax():
    from petastorm_tpu.jax_utils.loader import JaxDataLoader
    from petastorm_tpu.pipeline import graph as jax_graph
    from petastorm_tpu_torch.pipeline import graph as port_graph
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    graphs = {}
    for pinned in (None, 16):
        kwargs = dict(credits=6, ready_queue_depth=pinned, transform=lambda b: b)
        port = port_graph.build_loader_graph(TorchDataLoader(
            None, ServiceBatchSource(("127.0.0.1", 1), **kwargs), device="cpu"))
        jax = jax_graph.build_loader_graph(JaxDataLoader(
            None, 4, batch_source=jax_service.ServiceBatchSource(("127.0.0.1", 1), **kwargs),
            stage_to_device=False))
        graphs[pinned] = (port, jax)
        port_snap, jax_snap = port.snapshot(), jax.snapshot()
        # The rewrite knobs and their trigger signals are bound as in JAX.
        assert port_snap["knobs"] == jax_snap["knobs"]
        assert {"stage_fusion", "reader_family", "cache_placement"} <= set(port_snap["knobs"])
        assert set(port_snap["signals"]) == set(jax_snap["signals"])
        assert {"worker_decode_s", "handoff_s", "transform_s", "cache_hits", "cache_misses",
                "cache_evictions", "filter_rows_in", "filter_rows_kept"} \
            <= set(port_snap["signals"])
        assert {n: (s["side"], s["placement"], s.get("fuse_group"))
                for n, s in port_snap["stages"].items()} == \
            {n: (s["side"], s["placement"], s.get("fuse_group"))
             for n, s in jax_snap["stages"].items()}
        assert port.describe()["edges"] == jax.describe()["edges"]
    assert "ready_queue_depth" not in graphs[None][0].knobs
    assert graphs[16][0].knobs["ready_queue_depth"].get() == 16


SERVICE_FAMILIES = [
    "TRANSPORT_MESSAGES", "TRANSPORT_FRAMES", "TRANSPORT_BYTES", "TRANSPORT_SYSCALLS",
    "WORKER_BATCHES_SENT", "WORKER_ROWS_SENT", "WORKER_CREDIT_WAIT", "WORKER_STREAMS",
    "WORKER_ACTIVE_STREAMS", "WORKER_DECODE_SECONDS", "WORKER_READERS_CONSTRUCTED",
    "WORKER_TRANSFORM_SECONDS", "DISPATCHER_REQUESTS", "DISPATCHER_FENCING_EPOCH",
    "DISPATCHER_WORKERS", "CLIENT_BATCHES", "CLIENT_RECV_STALL", "CLIENT_READY_QUEUE_DEPTH",
    "CLIENT_RECOVERY_EVENTS", "CLIENT_DEDUP_DROPPED", "CLIENT_WATERMARK_LAG",
    "CLIENT_TRANSFORM_SECONDS"]


@pytest.mark.parametrize("name", SERVICE_FAMILIES)
def test_service_families_equal_the_jax_families(name):
    from petastorm_tpu.telemetry import metrics as jax_metrics
    from petastorm_tpu_torch.telemetry import metrics as port_metrics

    port, jax = getattr(port_metrics, name), getattr(jax_metrics, name)
    assert (port.name, port.help, port.kind, port.label_names, port.buckets) == \
        (jax.name, jax.help, jax.kind, jax.label_names, jax.buckets)


def test_a_loopback_run_moves_the_families_as_jax(scalar_store):
    from petastorm_tpu.telemetry import metrics as jax_metrics
    from petastorm_tpu_torch.telemetry import metrics as port_metrics

    moved = {}
    for name, package, metrics in (("port", port_service, port_metrics),
                                   ("jax", jax_service, jax_metrics)):
        # Worker ids of their own: the registry's series are per worker id.
        with Fleet(scalar_store, package=package, workers=1,
                   prefix=f"families-{name}-{time.monotonic_ns()}-") as fleet:
            wid = fleet.workers[0].worker_id
            before = (metrics.WORKER_ROWS_SENT.labels(wid).value,
                      metrics.WORKER_BATCHES_SENT.labels(wid).value,
                      metrics.CLIENT_BATCHES.labels(wid).value,
                      metrics.WORKER_READERS_CONSTRUCTED.labels(wid).value,
                      metrics.WORKER_STREAMS.labels(wid, "completed").value)
            source = package.ServiceBatchSource(fleet.dispatcher.address, ordered=True)
            rows = sum(len(_ids(b)) for b in source())
            # The worker counts its stream (by outcome) after sending `end`.
            assert _wait(lambda: sum(metrics.WORKER_STREAMS.labels(wid, outcome).value
                                     for outcome in ("completed", "disconnected", "error",
                                                     "aborted")) >= 1)
            after = (metrics.WORKER_ROWS_SENT.labels(wid).value,
                     metrics.WORKER_BATCHES_SENT.labels(wid).value,
                     metrics.CLIENT_BATCHES.labels(wid).value,
                     metrics.WORKER_READERS_CONSTRUCTED.labels(wid).value,
                     metrics.WORKER_STREAMS.labels(wid, "completed").value)
        moved[name] = (rows, [a - b for a, b in zip(after, before)])
    assert moved["port"] == moved["jax"] == (120, [120, 48, 48, 1, 1])


# ---------------------------------------------------------------------------
# a worker in another process
# ---------------------------------------------------------------------------

def test_a_worker_process_serves_without_importing_torch(scalar_store):
    """A worker never touches the card: serving a tagged stream in a fresh
    interpreter imports no torch (so no CUDA library is loaded)."""
    code = f"""
import sys
from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
from petastorm_tpu_torch.service import BatchWorker
worker = BatchWorker({scalar_store!r}, batch_size=8, reader_factory="batch").start()
with FramedConnection.connect(worker.address, timeout=10) as conn:
    conn.send({{"type": "stream", "pieces": [0, 5], "epoch": 0, "tagged": True}})
    kinds = []
    while not kinds or kinds[-1] != "end":
        kinds.append(conn.recv()[0]["type"])
worker.stop()
print(kinds.count("batch"), "torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["2", "False"]


@pytest.mark.slow
def test_subprocess_worker_sigkill_mid_epoch_loses_no_rows(scalar_store):
    """A worker started as ``python -m petastorm_tpu_torch.service worker``
    and killed with SIGKILL mid-epoch: the epoch completes with no row
    lost."""
    dispatcher = Dispatcher().start()
    local = BatchWorker(scalar_store, dispatcher_address=dispatcher.address, batch_size=4,
                        reader_factory="batch", worker_id="local",
                        reader_kwargs={"workers_count": 2}).start()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    child = subprocess.Popen(
        [sys.executable, "-m", "petastorm_tpu_torch.service", "worker", "--dispatcher",
         f"127.0.0.1:{dispatcher.address[1]}", "--dataset-url", scalar_store, "--reader",
         "batch", "--batch-size", "4", "--workers-count", "2", "--worker-id", "child"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, text=True)
    try:
        line = child.stdout.readline()
        assert json.loads(line)["worker_id"] == "child"
        assert _wait(lambda: sorted(_status(dispatcher)["workers"]) == ["child", "local"])
        source = ServiceBatchSource(dispatcher.address, max_retries=2, backoff_base=0.02,
                                    backoff_max=0.2)
        got, killed = [], False
        for batch in source():
            got.extend(_ids(batch))
            if not killed and len(got) >= 12:
                child.kill()
                killed = True
        assert killed and sorted(set(got)) == list(range(120))
    finally:
        child.kill()
        child.wait(timeout=10)
        child.stdout.close()
        local.stop()
        dispatcher.stop()
