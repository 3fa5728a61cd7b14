"""The data service's graph rewrites and the worker's batch cache, in the
port against the JAX package, over 127.0.0.1 on one small store (the test
factories' ``TestSchema``: 60 rows in 6 row groups of 10).

- Stage fusion: fused and unfused streams give the same bytes under a
  shuffle seed and at mid-piece watermarks, and equal the JAX fused
  stream's; fusion removes the stream thread's hand-off seconds and
  attributes the fused task's collate and serialize seconds.
- The hoisted filter gives the client filter's row stream (the JAX
  hoisted stream's batches, array for array) and sends only survivors; the
  hoisted projection prunes columns.
- The cache-placement flip refills and serves the same bytes; the
  post-decode fill is immune to a transform that mutates in place (fused
  or not).
- Refusals on an fcfs dispatcher, the source's validation (the JAX
  messages), the resume state that signs a hoisted filter, and a
  client-filter state_dict refused after emptied batches.
- The graph's rewrite knobs, trigger signals and fuse metadata equal the
  JAX graph's; the planner goldens reached through the port's graph equal
  the JAX planner's decisions; a rewrite-armed autotune applies the hoist,
  journals it and leaves no thread.
- The worker's batch cache: warm epochs equal the JAX worker's batches and
  decode nothing; one stream script through a JAX fleet and a port fleet
  gives equal batches and equal ``_piece_cache_key`` strings, and a disk
  tier a JAX worker filled serves a port worker warm.

Tolerance: none; everything is compared exactly.
"""

import contextlib
import threading
import uuid

import numpy as np
import pytest
import torch

from petastorm_tpu import service as jax_service
from petastorm_tpu.predicates import ColumnPredicate as JaxColumnPredicate
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.predicates import ColumnPredicate
from petastorm_tpu_torch.service.shm_ring import live_shm_counts

ROWS, GROUP = 60, 10
PIECES = ROWS // GROUP


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_dataset

    url = f"file://{tmp_path_factory.mktemp('rewrites')}/rows"
    create_test_dataset(url, rows_count=ROWS, rows_per_row_group=GROUP)
    return url


@pytest.fixture(autouse=True)
def no_shm_leak():
    """Every ring and pool a test maps is closed by its end (the conftest
    guard counts only the JAX package's registry)."""
    before = live_shm_counts()
    yield
    assert live_shm_counts() == before


def _predicate(package, *args, **kwargs):
    return (ColumnPredicate if package is port_service else JaxColumnPredicate)(
        *args, **kwargs)


def _cache(package, **kwargs):
    if package is port_service:
        from petastorm_tpu_torch.cache_impl import BatchCache
    else:
        from petastorm_tpu.cache_impl import BatchCache
    return BatchCache(**dict({"mem_budget_bytes": 64 << 20}, **kwargs))


@contextlib.contextmanager
def fleet(package, url, *, num_epochs=1, shuffle_seed=None, mode="static", batch_size=7,
          workers=1, batch_cache=None, **worker_kwargs):
    dispatcher = package.Dispatcher(port=0, mode=mode, num_epochs=num_epochs,
                                    shuffle_seed=shuffle_seed).start()
    started = []
    try:
        for i in range(workers):
            started.append(package.BatchWorker(
                url, dispatcher_address=dispatcher.address, batch_size=batch_size,
                # A fresh id: the registry's series are per worker id.
                worker_id=f"rw-{uuid.uuid4().hex[:8]}-{i}",
                batch_cache=batch_cache() if callable(batch_cache) else batch_cache,
                reader_kwargs={"workers_count": 2}, **worker_kwargs).start())
        yield dispatcher, started
    finally:
        for worker in started:
            worker.stop()
        dispatcher.stop()


def _arrays(batch):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in batch.items()}


def _run(package, url, *, shuffle_seed=None, num_epochs=1, batch_size=7, batch_cache=None,
         batch_transform=None, **source_kwargs):
    """One ordered iteration of a one-worker fleet of ``package``: the
    batches, the worker's counters and its cache's stats."""
    with fleet(package, url, num_epochs=num_epochs, shuffle_seed=shuffle_seed,
               batch_size=batch_size, batch_cache=batch_cache,
               batch_transform=batch_transform) as (dispatcher, (worker,)):
        source = package.ServiceBatchSource(dispatcher.address, ordered=True, **source_kwargs)
        batches = [_arrays(batch) for batch in source()]
        return {"batches": batches, "worker": worker.diagnostics_snapshot()["metrics"],
                "cache": worker.cache_stats(), "source": source}


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            if b[key].dtype == object:
                assert len(a[key]) == len(b[key])
                for x, y in zip(a[key], b[key]):
                    assert (x is None and y is None) or np.array_equal(x, y), key
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _flat_ids(run):
    return [int(i) for batch in run["batches"] for i in batch["id"]]


# ---------------------------------------------------------------------------
# stage fusion
# ---------------------------------------------------------------------------

def test_fused_stream_byte_identical_under_shuffle(store):
    base = _run(port_service, store, shuffle_seed=11)
    fused = _run(port_service, store, shuffle_seed=11, stage_fusion="fused")
    jax = _run(jax_service, store, shuffle_seed=11, stage_fusion="fused")
    _assert_batches_equal(fused["batches"], base["batches"])
    _assert_batches_equal(fused["batches"], jax["batches"])


def _engine_events(package, url, fused):
    """The engine's batch events for two pieces, the first re-served from
    ordinal 1 under a permutation, as (piece, ordinal, rows, fmt, bytes)."""
    if package is port_service:
        from petastorm_tpu_torch.reader.reader import make_reader
        from petastorm_tpu_torch.service.piece_engine import StreamingPieceEngine
        from petastorm_tpu_torch.service.seedtree import batch_permutation
    else:
        from petastorm_tpu.reader.reader import make_reader
        from petastorm_tpu.service.piece_engine import StreamingPieceEngine
        from petastorm_tpu.service.seedtree import batch_permutation

    def factory():
        return make_reader(url, reader_pool_type="thread", workers_count=2, num_epochs=1,
                           shuffle_row_groups=False, dynamic_ventilation=True)

    engine = StreamingPieceEngine(factory, 4, fused=fused,
                                  permute_fn=lambda piece, n: batch_permutation(5, 0, piece, n))
    try:
        engine.enqueue(0, 0, start=1)
        engine.enqueue(1, 0, start=0)
        engine.finish()
        out = []
        while True:
            event = engine.next_event(timeout=5.0)
            if event is None:
                if engine.finished:
                    return sorted(out), engine.fused
                continue
            if event[0] == "batch":
                _, piece, _gen, ordinal, rows, fmt, frames, _ = event
                out.append((piece, ordinal, rows, fmt, [bytes(f) for f in frames]))
    finally:
        engine.close()


def test_fused_stream_byte_identical_at_watermarks(store):
    """Pieces complete in either order across pool threads; within a piece
    the ordinals are total, so the events are compared piece-sorted."""
    fused, is_fused = _engine_events(port_service, store, fused=True)
    unfused, _ = _engine_events(port_service, store, fused=False)
    jax, _ = _engine_events(jax_service, store, fused=True)
    assert is_fused
    assert fused == unfused == jax
    assert [event[:2] for event in fused if event[0] == 0][0] == (0, 1)


def test_fusion_eliminates_handoff_and_attributes_stages(store):
    from petastorm_tpu_torch.telemetry.metrics import (
        WORKER_FUSED_STAGE_SECONDS,
        WORKER_HANDOFF_SECONDS,
    )

    def handoff_total():
        return sum(child.value for child in WORKER_HANDOFF_SECONDS.children().values())

    fused_before = {key: child.value
                    for key, child in WORKER_FUSED_STAGE_SECONDS.children().items()}
    before = handoff_total()
    _run(port_service, store)
    unfused_handoff = handoff_total() - before
    before = handoff_total()
    _run(port_service, store, stage_fusion="fused")
    fused_handoff = handoff_total() - before
    assert unfused_handoff > 0
    assert fused_handoff == 0
    for stage in ("collate", "serialize"):
        child = WORKER_FUSED_STAGE_SECONDS.children().get((stage,))
        assert child is not None and child.value > fused_before.get((stage,), 0.0), stage


# ---------------------------------------------------------------------------
# filter and projection hoisting
# ---------------------------------------------------------------------------

def test_hoisted_filter_equals_client_filter_row_stream(store):
    kwargs = dict(args=("id", "mod-eq", 0), modulus=3)
    runs = {(package.__name__, placement): _run(
        package, store, filter_placement=placement,
        predicate=_predicate(package, *kwargs["args"], modulus=kwargs["modulus"]))
        for package in (port_service, jax_service) for placement in ("client", "worker")}
    survivors = [i for i in range(ROWS) if i % 3 == 0]
    port_client = runs[(port_service.__name__, "client")]
    port_hoisted = runs[(port_service.__name__, "worker")]
    # The same surviving rows in the same order; the batch boundaries
    # differ (the hoisted side collates survivors below decode).
    assert _flat_ids(port_client) == _flat_ids(port_hoisted) == survivors
    for field in port_client["batches"][0]:
        flat_client = [row for b in port_client["batches"] for row in b[field]]
        flat_hoisted = [row for b in port_hoisted["batches"] for row in b[field]]
        assert len(flat_client) == len(flat_hoisted) == len(survivors)
        for a, b in zip(flat_client, flat_hoisted):
            assert np.array_equal(np.asarray(a), np.asarray(b)), field
    for placement in ("client", "worker"):
        _assert_batches_equal(runs[(port_service.__name__, placement)]["batches"],
                              runs[(jax_service.__name__, placement)]["batches"])
    # Dropped rows never cross the wire under the hoist.
    assert port_client["worker"]["rows_sent_total"] == ROWS
    assert port_hoisted["worker"]["rows_sent_total"] == len(survivors)
    assert port_hoisted["source"].diagnostics["rewrites"] == \
        runs[(jax_service.__name__, "worker")]["source"].diagnostics["rewrites"]


def test_hoisted_projection_prunes_columns(store):
    runs = [_run(package, store, filter_placement="worker", projection=["id", "id2"],
                 predicate=_predicate(package, "id", "mod-eq", 0, modulus=5))
            for package in (port_service, jax_service)]
    for batch in runs[0]["batches"]:
        assert sorted(batch) == ["id", "id2"]
    _assert_batches_equal(runs[0]["batches"], runs[1]["batches"])


# ---------------------------------------------------------------------------
# cache placement
# ---------------------------------------------------------------------------

def _double_ids(batch):
    out = dict(batch)
    out["id_double"] = np.asarray(batch["id"]) * 2
    return out


def _bump_id2(batch):
    """Not idempotent (id2 + 1): a warm serve that transformed twice shows."""
    out = dict(batch)
    out["id2"] = np.asarray(batch["id2"]) + 1
    out["id_double"] = np.asarray(batch["id"]) * 2
    return out


def _inplace_bump_id2(batch):
    """Mutates the collated id2 array in place: a fill that kept frames
    aliasing it would hold the transformed bytes."""
    arr = np.asarray(batch["id2"])
    arr += 1
    out = dict(batch)
    out["id2"] = arr
    return out


def _placement_flip(package, url):
    with fleet(package, url, batch_cache=_cache(package),
               batch_transform=_bump_id2) as (dispatcher, (worker,)):
        out = []
        for placement in ("post-transform", "post-decode", "post-decode"):
            source = package.ServiceBatchSource(dispatcher.address, ordered=True,
                                                transform=_bump_id2,
                                                cache_placement=placement)
            batches = [_arrays(batch) for batch in source()]
            for batch in batches:
                assert np.array_equal(batch["id_double"], batch["id"] * 2)
                # Applied exactly once.
                assert np.array_equal(batch["id2"], batch["id"] % 5 + 1)
            out.append((batches, dict(worker.cache_stats())))
        return out, worker.num_pieces


def test_cache_placement_flip_refills_and_serves_identical_bytes(store):
    port, pieces = _placement_flip(port_service, store)
    jax, _ = _placement_flip(jax_service, store)
    (pt, stats1), (pd, stats2), (pd_warm, stats3) = port
    assert stats2["misses"] == stats1["misses"] + pieces  # the flip refills
    assert stats3["hits"] == stats2["hits"] + pieces
    assert stats3["misses"] == stats2["misses"]
    _assert_batches_equal(pd, pt)
    _assert_batches_equal(pd_warm, pt)
    for (got, got_stats), (want, want_stats) in zip(port, jax):
        _assert_batches_equal(got, want)
        assert (got_stats["hits"], got_stats["misses"]) == \
            (want_stats["hits"], want_stats["misses"])


@pytest.mark.parametrize("fusion", ["off", "fused"])
def test_post_decode_fill_immune_to_inplace_transform(store, fusion):
    runs = [_run(package, store, num_epochs=2, batch_cache=_cache(package),
                 batch_transform=_inplace_bump_id2, transform=_inplace_bump_id2,
                 cache_placement="post-decode", stage_fusion=fusion)
            for package in (port_service, jax_service)]
    for batch in runs[0]["batches"]:  # epoch 1 fills, epoch 2 serves warm
        assert np.array_equal(batch["id2"], batch["id"] % 5 + 1)
    assert runs[0]["cache"]["hits"] == PIECES
    _assert_batches_equal(runs[0]["batches"], runs[1]["batches"])


# ---------------------------------------------------------------------------
# refusals, validation, resume
# ---------------------------------------------------------------------------

def test_rewrites_rejected_on_fcfs(store):
    from petastorm_tpu_torch.pipeline import build_loader_graph
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    with fleet(port_service, store, mode="fcfs") as (dispatcher, _):
        with pytest.raises(ValueError, match="graph rewrites"):
            port_service.ServiceBatchSource(dispatcher.address, stage_fusion="fused")()
        plain = port_service.ServiceBatchSource(dispatcher.address,
                                                predicate=ColumnPredicate("id", "eq", 1))
        loader = TorchDataLoader(None, plain, device="cpu")
        with loader:
            got = [int(i) for batch in loader for i in batch["id"]]
        assert got == [1]  # the client filter works on fcfs
        for setter, value in (("set_stage_fusion", "fused"),
                              ("set_filter_placement", "worker")):
            with pytest.raises(ValueError, match="static or dynamic"):
                getattr(plain, setter)(value)
        graph = build_loader_graph(loader)
        assert not {"stage_fusion", "filter_placement", "reader_family"} & set(graph.knobs)


def _errors(make):
    """The message ``make`` raises, or None."""
    try:
        make()
    except ValueError as exc:
        return str(exc)
    return None


VALIDATION = [
    dict(filter_placement="worker"),
    dict(stage_fusion="on"),
    dict(cache_placement="post-decode"),
    dict(reader_family="vectorized"),
    dict(transform=_double_ids, predicate=("id", "eq", 1)),
    dict(transform=_double_ids, projection=["id"]),
    dict(transform=_double_ids, predicate=("id", "eq", 1), filter_placement="worker",
         projection=["id"]),
    dict(predicate=("id", "eq", 1), filter_placement="worker", projection=["id2", "id"]),
]


@pytest.mark.parametrize("kwargs", VALIDATION, ids=[
    "hoist-without-predicate", "fusion-mode", "post-decode-without-transform", "family",
    "client-filter-with-transform", "client-projection-with-transform",
    "hoisted-with-transform", "hoisted-projection"])
def test_source_validation_errors(kwargs):
    made = {}
    for package in (port_service, jax_service):
        args = dict(kwargs)
        if "predicate" in args:
            args["predicate"] = _predicate(package, *args["predicate"])
        made[package] = _errors(lambda: made.setdefault(
            (package, "source"), package.ServiceBatchSource(("127.0.0.1", 1), **args)))
    assert made[port_service] == made[jax_service]
    if made[port_service] is None:
        port, jax = made[(port_service, "source")], made[(jax_service, "source")]
        assert (port.filter_placement, port.stage_fusion, port.cache_placement,
                port.reader_family, port._projection) == \
            (jax.filter_placement, jax.stage_fusion, jax.cache_placement, jax.reader_family,
             jax._projection)


def test_setters_refuse_as_jax():
    for package in (port_service, jax_service):
        source = package.ServiceBatchSource(("127.0.0.1", 1),
                                            predicate=_predicate(package, "id", "eq", 1))
        source.set_filter_placement("worker")
        assert source.filter_placement == "worker"
        with pytest.raises(ValueError, match="'client' or 'worker'"):
            source.set_filter_placement("device")
        with pytest.raises(ValueError, match="needs a transform"):
            source.set_cache_placement("post-decode")
        source.set_reader_family("columnar")
        source.set_stage_fusion("fused")
        assert (source.reader_family, source.stage_fusion) == ("columnar", "fused")
        pinned = package.ServiceBatchSource(
            ("127.0.0.1", 1), transform=_double_ids, filter_placement="worker",
            predicate=_predicate(package, "id", "eq", 1))
        with pytest.raises(ValueError, match="unavailable with a"):
            pinned.set_filter_placement("client")


def test_resume_state_signs_hoisted_filter(store):
    predicate = ColumnPredicate("id", "mod-eq", 0, modulus=2)
    with fleet(port_service, store) as (dispatcher, _):
        source = port_service.ServiceBatchSource(dispatcher.address, predicate=predicate,
                                                 filter_placement="worker")
        it = source()
        next(it)
        snapshot = source.state_dict()
        it.close()
    assert snapshot["filter"] == predicate.to_wire() == \
        JaxColumnPredicate("id", "mod-eq", 0, modulus=2).to_wire()
    for package in (port_service, jax_service):
        same = _predicate(package, "id", "mod-eq", 0, modulus=2)
        package.ServiceBatchSource(("127.0.0.1", 1), resume_state=snapshot, predicate=same,
                                   filter_placement="worker")
        for kwargs in (dict(predicate=same, filter_placement="client"), {}):
            with pytest.raises(ValueError, match="hoisted-filter mismatch"):
                package.ServiceBatchSource(("127.0.0.1", 1), resume_state=snapshot, **kwargs)
        legacy = {key: value for key, value in snapshot.items() if key != "filter"}
        with pytest.raises(ValueError, match="hoisted-filter mismatch"):
            package.ServiceBatchSource(("127.0.0.1", 1), resume_state=legacy, predicate=same,
                                       filter_placement="worker")
        package.ServiceBatchSource(("127.0.0.1", 1), resume_state=legacy)


def test_state_dict_refuses_prefetch_cursor_after_dropped_batches(store):
    with fleet(port_service, store, batch_size=10) as (dispatcher, _):
        # id2 == 7 never matches: every batch empties and is dropped here.
        source = port_service.ServiceBatchSource(
            dispatcher.address, predicate=ColumnPredicate("id2", "eq", 7),
            filter_placement="client")
        assert sum(1 for _ in source()) == 0
        with pytest.raises(ValueError, match="dropped"):
            source.state_dict(yielded_batches=1)
        assert source.state_dict()["version"] == 2
        assert source.diagnostics["rewrites"]["filter_dropped_batches"] == PIECES


# ---------------------------------------------------------------------------
# the graph, the planner and the controller
# ---------------------------------------------------------------------------

def _graph(package, address, **kwargs):
    """The loader graph over a source that has run one batch (so its mode
    is known)."""
    if package is port_service:
        from petastorm_tpu_torch.pipeline import build_loader_graph
        from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

        source = package.ServiceBatchSource(address, **kwargs)
        loader = TorchDataLoader(None, source, device="cpu")
    else:
        from petastorm_tpu.jax_utils.loader import JaxDataLoader
        from petastorm_tpu.pipeline import build_loader_graph

        source = package.ServiceBatchSource(address, **kwargs)
        loader = JaxDataLoader(None, 7, batch_source=source, stage_to_device=False)
    with loader:
        for _ in loader:
            break
    return build_loader_graph(loader)


@pytest.mark.parametrize("armed", ["transform", "filter"])
def test_graph_binds_rewrite_knobs_and_fuse_metadata(store, armed):
    snaps = {}
    for package in (port_service, jax_service):
        kwargs = {"predicate": _predicate(package, "id", "mod-eq", 0, modulus=2)}
        if armed == "transform":
            kwargs.update(transform=_double_ids, filter_placement="worker")
        with fleet(package, store, batch_transform=_double_ids) as (dispatcher, _):
            graph = _graph(package, dispatcher.address, **kwargs)
        snaps[package] = (graph.snapshot(), graph.describe(),
                          {name: knob.descriptor() for name, knob in graph.knobs.items()})
    (port_snap, port_desc, port_knobs), (jax_snap, jax_desc, jax_knobs) = \
        snaps[port_service], snaps[jax_service]
    assert port_knobs == jax_knobs
    assert port_snap["knobs"] == jax_snap["knobs"]
    assert set(port_snap["signals"]) == set(jax_snap["signals"])
    group = ["decode", "transform", "collate", "serialize"]
    assert [s.get("fuse_group") for s in port_desc["stages"]] == \
        [s.get("fuse_group") for s in jax_desc["stages"]]
    assert port_snap["stages"]["collate"]["fuse_group"] == group
    if armed == "transform":
        assert port_knobs["stage_fusion"]["rewrite"] == "fuse_worker_stages"
        assert port_knobs["cache_placement"]["rewrite"] == "cache_placement"
        assert "filter_placement" not in port_knobs
    else:
        assert port_knobs["filter_placement"]["rewrite"] == "hoist_filter"
        assert "cache_placement" not in port_knobs


def _profile(*, wall=1.0, rows=10000, stall=0.5, knobs=None, **signals):
    out = {"wall_s": wall, "rows": rows, "stall_s": stall, "queue_wait_s": 0.0,
           "decode_s": 0.0, "dispatch_s": 0.0, "knobs": dict(knobs or {})}
    out.update(signals)
    return out


def _hoist_profile(knobs):
    """A decode-bound window whose client filter drops 75 % of the rows."""
    return _profile(decode_s=0.9, filter_rows_in=1000.0, filter_rows_kept=250.0, knobs=knobs)


#: Canned windows for the planner goldens, by name: each returns the
#: profile for the knob values the graph reports.
GOLDENS = {
    "hoist": _hoist_profile,
    "fuse": lambda knobs: _profile(decode_s=0.9, worker_decode_s=0.5, handoff_s=0.2,
                                   knobs=knobs),
    "cache_down": lambda knobs: _profile(decode_s=0.9, worker_decode_s=1.0, transform_s=0.1,
                                         cache_hits=5.0, cache_misses=5.0,
                                         cache_evictions=3.0, knobs=knobs),
    "untriggered": lambda knobs: _profile(decode_s=0.9, knobs=knobs),
}


def test_planner_goldens_through_the_ports_graph(store):
    """The port's graph on a live service source (with a transform and a
    flippable filter: one of each) gives its knob descriptors to both
    packages' planners; on each canned window both decide the same."""
    from petastorm_tpu.pipeline.autotune import Planner as JaxPlanner
    from petastorm_tpu_torch.pipeline.autotune import Planner

    with fleet(port_service, store, batch_transform=_double_ids) as (dispatcher, _):
        graphs = [_graph(port_service, dispatcher.address, transform=_double_ids),
                  _graph(port_service, dispatcher.address,
                         predicate=ColumnPredicate("id", "mod-eq", 0, modulus=2))]
    seen = set()
    for graph in graphs:
        descriptors = {name: knob.descriptor() for name, knob in graph.knobs.items()}
        # The family rewrite triggers on any decode-bound window and would
        # be probed first; the goldens are those of the other three.
        descriptors.pop("reader_family")
        values = graph.snapshot()["knobs"]
        for name, window in GOLDENS.items():
            planners = [cls(descriptors, hysteresis=1, placement_hysteresis=1,
                            rewrite_hysteresis=2) for cls in (Planner, JaxPlanner)]
            for _ in range(6):
                decisions = [planner.plan(window(values)) for planner in planners]
                assert decisions[0] == decisions[1], name
                if decisions[0]:
                    seen.update((name, d["knob"], d.get("rewrite")) for d in decisions[0])
                    break
    assert ("hoist", "filter_placement", "hoist_filter") in seen
    assert ("fuse", "stage_fusion", "fuse_worker_stages") in seen
    assert ("cache_down", "cache_placement", "cache_placement") in seen


def test_rewrite_armed_autotune_journals_and_leaks_nothing(store):
    """An autotuned loader over a filtered service stream, then its stopped
    controller driven with canned hoist windows: it applies the hoist,
    journals it in the rewrite families, and no controller thread is
    left."""
    from petastorm_tpu_torch.pipeline.autotune import Planner
    from petastorm_tpu_torch.telemetry.metrics import REWRITE_ACTIVE, REWRITE_DECISIONS
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    with fleet(port_service, store, batch_size=5) as (dispatcher, _):
        source = port_service.ServiceBatchSource(
            dispatcher.address, predicate=ColumnPredicate("id", "mod-eq", 0, modulus=4))
        loader = TorchDataLoader(None, source, device="cpu", autotune={"interval_s": 60})
        before = REWRITE_DECISIONS.labels("hoist_filter", "flip").value
        with loader:
            assert sum(len(batch["id"]) for batch in loader) == ROWS // 4
        controller = loader.autotune
        assert not controller.running
        descriptors = {name: knob.descriptor() for name, knob in controller.graph.knobs.items()}
        controller.planner = Planner(descriptors, hysteresis=1, placement_hysteresis=1,
                                     rewrite_hysteresis=1, probe_defer=0)
        controller.window_profile = lambda: _hoist_profile(
            {name: knob.get() for name, knob in controller.graph.knobs.items()})
        applied = []
        for _ in range(4):
            applied = controller.step()
            if applied:
                break
        assert applied and applied[0]["rewrite"] == "hoist_filter"
        assert source.filter_placement == "worker"
        assert REWRITE_DECISIONS.labels("hoist_filter", "flip").value == before + 1
        assert REWRITE_ACTIVE.labels(controller._id, "hoist_filter").value == 1.0
        assert any(d.get("rewrite") == "hoist_filter"
                   for entry in controller.report()["trail"] for d in entry["decisions"])
        # The next iteration's streams carry the hoisted filter.
        assert source._hoisted_filter_signature(constructed=True) == \
            ColumnPredicate("id", "mod-eq", 0, modulus=4).to_wire()
    assert not controller.running
    assert not [t for t in threading.enumerate() if t.name.startswith("pipeline-autotune")]


# ---------------------------------------------------------------------------
# the worker's batch cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", [None, "columnar"])
def test_batch_cache_warm_epochs_equal_jax(store, family):
    """Two shuffled epochs through a cached worker: the second decodes
    nothing (every piece a hit, no reader built) and both equal the JAX
    worker's batches."""
    runs = {}
    for package in (port_service, jax_service):
        with fleet(package, store, num_epochs=2, shuffle_seed=3,
                   batch_cache=_cache(package)) as (dispatcher, (worker,)):
            source = package.ServiceBatchSource(dispatcher.address, ordered=True,
                                                reader_family=family)
            batches = [_arrays(batch) for batch in source()]
            runs[package] = (batches, worker.cache_stats_by_epoch(),
                             worker.diagnostics_snapshot()["metrics"])
    (port, port_epochs, port_metrics), (jax, jax_epochs, jax_metrics) = \
        runs[port_service], runs[jax_service]
    _assert_batches_equal(port, jax)
    assert port_epochs == jax_epochs == {0: {"hits": 0, "misses": PIECES},
                                         1: {"hits": PIECES, "misses": 0}}
    assert port_metrics["readers_constructed_total"] == 1  # the cold epoch only
    for key in ("cache_hits_total", "cache_misses_total", "columnar_batches_total",
                "row_fallback_batches_total"):
        assert port_metrics[key] == jax_metrics[key], key


def _key_cases(predicate_cls):
    return [dict(), dict(transformed=True),
            dict(predicate=predicate_cls("id", "mod-eq", 0, modulus=3)),
            dict(projection=["id2", "id"]), dict(family="columnar"),
            dict(transformed=True, projection=["id"], family="row",
                 predicate=predicate_cls("id2", "ge", 2))]


def test_one_stream_script_through_both_fleets(store):
    """The same stream requests against a port worker and a JAX worker
    (both cached, one mem+disk directory each): equal batches and equal
    ``_piece_cache_key`` strings for every rewrite combination."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    script = [
        {"type": "stream", "pieces": [0, 2], "epoch": 0, "tagged": True},
        {"type": "stream", "pieces": [[1, 4, 0], [3, 4, 1]], "epoch": 0, "dynamic": True,
         "fused": True},
        {"type": "stream", "pieces": [4, 5], "epoch": 0, "tagged": True, "shuffle_seed": 9,
         "predicate": {"field": "id", "op": "mod-eq", "value": 0, "modulus": 2},
         "projection": ["id", "id2"]},
        {"type": "stream", "pieces": [0, 2], "epoch": 1, "tagged": True,
         "starts": {"2": 1}, "cache_stage": "post-decode", "reader_family": "columnar"},
    ]
    out = {}
    for package in (port_service, jax_service):
        cache = _cache(package, spill_to_disk=True)
        # One decode thread: the frames' order is then the script's.
        worker = package.BatchWorker(store, batch_size=4, batch_cache=cache,
                                     batch_transform=_double_ids,
                                     reader_kwargs={"workers_count": 1}).start()
        try:
            frames = []
            for request in script:
                with FramedConnection.connect(worker.address, timeout=10) as conn:
                    conn.send(request)
                    if request.get("dynamic"):
                        conn.send({"type": "finish_pieces"})
                    while True:
                        header, payload = conn.recv()
                        header.pop("bid", None)
                        frames.append((header, _arrays(payload) if payload else None))
                        if header["type"] in ("end", "error"):
                            break
            cls = ColumnPredicate if package is port_service else JaxColumnPredicate
            keys = [worker._piece_cache_key(piece, **case)
                    for case in _key_cases(cls) for piece in range(PIECES)]
            out[package] = frames, keys, worker.cache_stats_by_epoch()
        finally:
            worker.stop()
    (port_frames, port_keys, port_epochs), (jax_frames, jax_keys, jax_epochs) = \
        out[port_service], out[jax_service]
    assert port_keys == jax_keys and len(set(port_keys)) == len(port_keys)
    assert [h for h, _ in port_frames] == [h for h, _ in jax_frames]
    assert all(h["type"] != "error" for h, _ in port_frames)
    _assert_batches_equal([p for _, p in port_frames if p], [p for _, p in jax_frames if p])
    assert port_epochs == jax_epochs


def test_a_jax_filled_disk_tier_serves_a_port_worker_warm(store, tmp_path):
    from petastorm_tpu.cache_impl import BatchCache as JaxBatchCache
    from petastorm_tpu_torch.cache_impl import BatchCache

    directory = str(tmp_path / "shared")
    cold = _run(jax_service, store, batch_cache=JaxBatchCache(
        mem_budget_bytes=64 << 20, cache_dir=directory, spill_to_disk=True))
    warm = _run(port_service, store, batch_cache=BatchCache(
        mem_budget_bytes=64 << 20, cache_dir=directory, spill_to_disk=True))
    _assert_batches_equal(warm["batches"], cold["batches"])
    assert (warm["cache"]["hits_disk"], warm["cache"]["misses"]) == (PIECES, 0)
    assert warm["worker"]["readers_constructed_total"] == 0


def test_untagged_cached_streams_on_a_process_pool_equal_jax(store):
    """A process pool has no engine: an untagged stream is served piece by
    piece, a cold piece through a reader of its own filling the cache, a
    warm one from the cache's frames (no reader)."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    out = {}
    for package in (port_service, jax_service):
        worker = package.BatchWorker(store, batch_size=4, batch_cache=_cache(package),
                                     reader_kwargs={"workers_count": 1,
                                                    "reader_pool_type": "process"}).start()
        try:
            batches = []
            for epoch in (0, 1):
                with FramedConnection.connect(worker.address, timeout=30) as conn:
                    conn.send({"type": "stream", "pieces": [1, 4], "epoch": epoch})
                    while True:
                        header, payload = conn.recv()
                        assert header["type"] != "error", header
                        if header["type"] == "end":
                            break
                        batches.append(_arrays(payload))
            out[package] = (batches, worker.cache_stats_by_epoch(),
                            worker.diagnostics_snapshot()["metrics"]["readers_constructed_total"])
        finally:
            worker.stop()
    (port, port_epochs, port_readers), (jax, jax_epochs, jax_readers) = \
        out[port_service], out[jax_service]
    _assert_batches_equal(port, jax)
    assert port_epochs == jax_epochs == {0: {"hits": 0, "misses": 2}, 1: {"hits": 2, "misses": 0}}
    assert port_readers == jax_readers == 2


AUTOTUNE_SAMPLES = [
    (None, None),
    (None, {"knobs": {}, "decisions": {}}),
    ({"knobs": {("0", "credits"): 8.0}, "decisions": {("credits", "up"): 1.0}},
     {"knobs": {("0", "credits"): 16.0, ("0", "stage_fusion"): 1.0},
      "decisions": {("credits", "up"): 2.0, ("stage_fusion", "flip"): 1.0}}),
    (None, {"knobs": {("0", "credits"): 8.0, ("1", "reader_family"): 0.0},
            "decisions": {("reader_family", "revert"): 1.0}}),
]


@pytest.mark.parametrize("prev,cur", AUTOTUNE_SAMPLES,
                         ids=["unreachable", "unregistered", "window", "two-controllers"])
def test_render_autotune_status_equals_jax(prev, cur):
    from petastorm_tpu.service.cli import render_autotune_status as jax_render
    from petastorm_tpu_torch.service.cli import render_autotune_status

    assert render_autotune_status(prev, cur) == jax_render(prev, cur)


def test_status_table_transport_column_equals_jax_labels(store):
    from petastorm_tpu.service.cli import _transport_label as jax_label
    from petastorm_tpu_torch.service import cli

    for counts in ((None, None), (0, 0), (3, 0), (0, 2), (1, 1)):
        assert cli._transport_label(*counts) == jax_label(*counts)
    with fleet(port_service, store, workers=2) as (dispatcher, workers):
        workers[1]._transport_mode = "tcp"
        assert len(_flat_ids(_run_on(dispatcher))) == ROWS
        status, _ = cli._request(dispatcher.address, {"type": "status"})
        _, diagnostics = cli._request(dispatcher.address, {"type": "worker_diagnostics"})
    rows = {line.split()[0]: line.split() for line in cli.render_status(
        status, diagnostics).splitlines()[2:] if line.startswith("rw-")}
    assert sorted(row[4] for row in rows.values()) == ["shm", "tcp"]


def _run_on(dispatcher):
    source = port_service.ServiceBatchSource(dispatcher.address, ordered=True)
    return {"batches": [_arrays(batch) for batch in source()]}

