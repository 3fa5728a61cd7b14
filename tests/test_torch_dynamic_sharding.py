"""Dynamic sharding in the port against the JAX package, and on the port's
own fleets over 127.0.0.1.

- ``plan_steals`` gives the JAX planner's moves, move for move: on the JAX
  unit cases and on ``hypothesis`` inputs (pending, stealable, rates,
  receivers).
- The same request script (``dynamic_plan``; ``dynamic_sync`` with done /
  owned / stealable / rates / failed steals, stale ones included; a
  mid-epoch ``register_worker``; a breaker-open worker's drain hand-off; a
  takeover; a quarantine; an unknown plan) through both dispatchers'
  ``_handle``: the replies equal (clocks masked), the journals byte-equal,
  the state equal after a restart, and each package recovers the other's
  dynamic journal. A client view left behind by a replayed steal comes back
  as a corrective delta.
- The port's loopback fleet: every row once against the local reader;
  ``ordered=True`` yields the JAX fleet's batches in the same order; a
  skewed worker's backlog is stolen with no row lost or repeated; a worker
  joining mid-epoch receives steals; several epochs; a ``state_dict``
  resume across a steal (and on a static dispatcher); a dispatcher restarted
  from its journal mid-steal, reconciled by corrective deltas.
- ``status --table`` renders the JAX ``status --watch`` steal and backlog
  columns and generation for the same status.

Sync intervals are 0.05–0.1 s; each test stops every node it starts.
"""

import copy
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from petastorm_tpu import service as jax_service
from petastorm_tpu.service.dispatcher import plan_steals as jax_plan_steals
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.service import BatchWorker, Dispatcher, ServiceBatchSource
from petastorm_tpu_torch.service.dispatcher import plan_steals

ROWS = 60  # 12 pieces of 5: piece p holds ids [5p, 5p + 5)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path_factory.mktemp('dyn')}/scalar"
    create_test_scalar_dataset(url, rows_count=ROWS, rows_per_row_group=5)
    return url


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

#: The JAX planner's unit cases (tests/test_dynamic_sharding.py).
PLANNER_CASES = {
    "drain": ({"w0": 6, "w1": 0, "w2": 2}, {"w0": [10, 11, 12, 13, 14], "w2": [20]}, {}),
    "straggler": ({"w0": 8, "w1": 2, "w2": 2}, {"w0": [1, 2, 3, 4, 5, 6]},
                  {"w0": 10.0, "w1": 100.0, "w2": 120.0}),
    "balanced": ({"w0": 3, "w1": 3}, {"w0": [1, 2], "w1": [5, 6]}, {"w0": 50.0, "w1": 55.0}),
    "last-piece": ({"w0": 1, "w1": 0}, {"w0": [7]}, {}),
    "proportional": ({"w0": 8, "w1": 0}, {"w0": list(range(8))}, {"w0": 10.0, "w1": 110.0}),
    "no-bounce": ({"slow": 0, "fast": 4}, {"fast": [1, 2]}, {"slow": 10.0, "fast": 110.0}),
    "zero-rate": ({"w0": 16, "w1": 2}, {"w0": list(range(16))}, {"w0": 0.0, "w1": 5000.0}),
    "probe": ({"slow": 0, "fast": 29}, {"fast": list(range(29))},
              {"slow": 4000.0, "fast": 10000.0}),
    "small-share": ({"slow": 0, "fast": 8}, {"fast": list(range(8))},
                    {"slow": 2000.0, "fast": 10000.0}),
    "stealable-only": ({"w0": 9, "w1": 0}, {"w0": [3]}, {}),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_plan_steals_equals_jax_on_its_unit_cases(case):
    pending, stealable, rates = PLANNER_CASES[case]
    want = jax_plan_steals(pending, stealable, rates)
    assert plan_steals(pending, stealable, rates) == want
    if case == "proportional":
        assert len(want) == 7
    if case == "stealable-only":
        assert want == [(3, "w0", "w1")]


@st.composite
def _planner_inputs(draw):
    workers = [f"w{i}" for i in range(draw(st.integers(1, 5)))]
    pending = {w: draw(st.integers(0, 12)) for w in workers}
    next_piece, stealable = 0, {}
    for w in workers:
        if draw(st.booleans()):
            n = draw(st.integers(0, pending[w]))
            stealable[w] = list(range(next_piece, next_piece + n))
            next_piece += n
    rates = {w: draw(st.sampled_from([0.0, 1.0, 5.0, 40.0, 100.0, 1000.0]))
             for w in workers if draw(st.booleans())}
    receivers = (None if draw(st.booleans())
                 else draw(st.lists(st.sampled_from(workers), unique=True)))
    return pending, stealable, rates, receivers


@settings(max_examples=300, deadline=None)
@given(_planner_inputs())
def test_plan_steals_moves_equal_jax_on_any_input(inputs):
    pending, stealable, rates, receivers = inputs
    want = jax_plan_steals(copy.deepcopy(pending), copy.deepcopy(stealable), dict(rates),
                           receivers=receivers)
    assert plan_steals(pending, stealable, rates, receivers=receivers) == want
    # Stolen pieces were stealable, and every donor keeps a piece.
    moved = {}
    for piece, donor, receiver in want:
        assert piece in stealable[donor] and donor != receiver
        moved[donor] = moved.get(donor, 0) + 1
    assert all(pending[d] - n >= 1 for d, n in moved.items())


# ---------------------------------------------------------------------------
# same requests, same answers
# ---------------------------------------------------------------------------

def _reg(wid, port):
    return {"type": "register_worker", "worker_id": wid, "host": "127.0.0.1", "port": port,
            "num_pieces": 12}


def _plan(epoch=0):
    return {"type": "dynamic_plan", "client_id": "c0", "client_index": 0, "num_clients": 1,
            "epoch": epoch}


def _sync(done=(), owned=None, stealable=None, rates=None, failed=(), epoch=0):
    return {"type": "dynamic_sync", "client_id": "c0", "epoch": epoch, "done": list(done),
            "owned": owned or {}, "stealable": stealable or {}, "rates": rates or {},
            "failed_steals": [list(f) for f in failed]}


EVEN, ODD = list(range(0, 12, 2)), list(range(1, 12, 2))

#: A dynamic client's life: the plan, w1 draining its deque (steals from w0
#: by rate), a failed steal and a stale one, a worker joining mid-epoch, a
#: client view behind the dispatcher's (corrective deltas), a breaker-open
#: worker's drain hand-off, a takeover, a quarantine, an unknown epoch, the
#: next epoch's plan and the wrong-mode requests.
SCRIPT = [
    _reg("w0", 1), _reg("w1", 2), _plan(),
    _sync(owned={"w0": EVEN, "w1": ODD}, stealable={"w0": EVEN[2:], "w1": ODD[2:]},
          rates={"w0": 40.0, "w1": 100.0}),
    _sync(done=ODD, owned={"w0": EVEN, "w1": []}, stealable={"w0": EVEN[1:]},
          rates={"w0": 10.0, "w1": 110.0}),
    _sync(done=ODD, owned={"w0": EVEN[:2], "w1": EVEN[2:]}, stealable={"w1": EVEN[3:]},
          failed=[(10, "w0", 1, 2), (8, "w0", 1, 99)], rates={"w0": 10.0, "w1": 110.0}),
    _reg("w2", 3),
    # The client has not applied the steals yet: its view is behind.
    _sync(done=ODD + [0], owned={"w0": EVEN[1:]}, stealable={"w0": EVEN[2:]},
          rates={"w0": 10.0, "w1": 110.0}),
    {"type": "report_breaker", "client_id": "c0", "worker_id": "w1",
     "error": "2 consecutive stream failures", "epoch": 0},
    _sync(done=ODD + [0], owned={"w0": [2], "w1": [4, 6, 8], "w2": [10]},
          stealable={"w1": [6, 8], "w2": [10]}, rates={"w0": 30.0, "w1": 90.0, "w2": 0.0}),
    {"type": "report_failure", "client_id": "c0", "worker_id": "w0", "pieces": [2],
     "fencing_epoch": 0},
    {"type": "report_poison_piece", "client_id": "c0", "piece": 8, "worker_id": "w1",
     "error": "undecodable row group", "epoch": 0},
    {"type": "status"},
    _sync(done=ODD, epoch=7),
    _sync(done=list(range(12)), owned={}, stealable={}),
    _plan(epoch=1),
    {"type": "get_assignment", "client_id": "c0", "client_index": 0, "num_clients": 1},
    {"type": "next_split", "client_id": "c0"},
    {"type": "status"},
]

KWARGS = dict(mode="dynamic", num_epochs=2, shuffle_seed=5, breaker_cooldown_s=0.0)
_VOLATILE = {"dispatcher_time_us", "lease_expires_in_s", "path"}


def _mask(value):
    if isinstance(value, dict):
        return {k: ("<masked>" if k in _VOLATILE else _mask(v)) for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    return value


def _play(dispatcher, steps):
    replies = []
    for step in steps:
        reply = dict(dispatcher._handle(copy.deepcopy(step)))
        if reply["type"] == "status":
            # The port keeps the metrics endpoint at the top level too.
            reply.pop("metrics_address", None)
        replies.append(_mask(reply))
    return replies


def _start(package, journal_dir, **kwargs):
    return package.Dispatcher(journal_dir=str(journal_dir), lease_timeout_s=None,
                              **dict(KWARGS, **kwargs)).start()


def _journal_bytes(path):
    return {name: (path / name).read_bytes() for name in ("wal.jsonl", "snapshot.json")}


def test_same_requests_give_the_same_answers_journal_and_state(tmp_path):
    out = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        dispatcher = _start(package, tmp_path / name)
        try:
            replies = _play(dispatcher, SCRIPT)
            before = dispatcher.state_snapshot()
        finally:
            dispatcher.stop()
        files = _journal_bytes(tmp_path / name)
        restarted = _start(package, tmp_path / name)
        try:
            after = restarted.state_snapshot()
            # After the replay, a client whose view is behind the replayed
            # steals gets them back as corrective deltas.
            again = _play(restarted, [_plan(), _sync(owned={"w0": EVEN, "w1": ODD})])
        finally:
            restarted.stop()
        out[name] = (replies, files, before, after, again)
    port, jax = out["port"], out["jax"]
    assert port[0] == jax[0]
    assert port[1] == jax[1]  # journals byte-equal
    assert port[2:] == jax[2:]
    replies, _, before, after, _ = port
    assert {k: v for k, v in after.items() if k not in ("recovery", "fencing_epoch")} == \
        {k: v for k, v in before.items() if k not in ("recovery", "fencing_epoch")}
    assert replies[2]["type"] == "plan" and replies[2]["generation"] == 1
    steals = [d for r in replies if r["type"] == "deltas" for d in r["steals"]]
    assert any(d["to"] == "w2" for d in steals)  # the mid-epoch joiner received
    corrective = replies[7]["steals"]
    assert corrective and all(d["generation"] <= replies[5]["generation"]
                              for d in corrective[:1])
    # The breaker-open worker sheds its unstarted backlog (fresh steals).
    assert [d for d in replies[9]["steals"]
            if d["from"] == "w1" and d["generation"] > replies[7]["generation"]]
    assert replies[10]["type"] == "assignment" and replies[10]["generation"] > 1
    assert replies[13] == {"type": "unknown_plan", "fencing_epoch": 1}
    assert replies[16]["type"] == replies[17]["type"] == "error"
    status = replies[12]
    assert status["dynamic"]["per_worker"]["w1"]["steals_in"] >= 1
    assert status["jobs"]["default"]["backlog"] == \
        sum(w["backlog"] for w in status["dynamic"]["per_worker"].values())
    assert 8 not in [p for p, _, _ in before["dyn"]["c0"]["owner"]]  # quarantined
    assert before["quarantined"]["8"]["error"] == "undecodable row group"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_dynamic_journal(writer, tmp_path):
    packages = {"port": port_service, "jax": jax_service}
    dispatcher = _start(packages[writer], tmp_path / "j")
    try:
        _play(dispatcher, SCRIPT[:-4])
    finally:
        dispatcher.stop()
    snapshots = {}
    for name in (("port", "jax") if writer == "jax" else ("jax", "port")):
        recovered = _start(packages[name], tmp_path / "j")
        try:
            snapshots[name] = recovered.state_snapshot()
        finally:
            recovered.stop()
    first, second = snapshots.values()
    assert second["recovery"]["journal_replays"] == first["recovery"]["journal_replays"] + 1
    assert {k: v for k, v in first.items() if k not in ("recovery", "fencing_epoch")} == \
        {k: v for k, v in second.items() if k not in ("recovery", "fencing_epoch")}
    assert first["dyn"]["c0"]["steals"] and first["generation"] > 1


def test_dynamic_gauges_and_fleet_signals(tmp_path):
    from petastorm_tpu_torch.telemetry import metrics

    dispatcher = _start(port_service, tmp_path / "g")
    try:
        _play(dispatcher, SCRIPT[:6])
        signals = dispatcher.fleet_signals()
        status = dispatcher._handle({"type": "status"})
    finally:
        dispatcher.stop()
    per_worker = status["dynamic"]["per_worker"]
    assert signals["backlog_known"] is True
    assert signals["backlog"] == {w: e["backlog"] for w, e in per_worker.items()}
    assert signals["rates"] == {"w0": 10.0, "w1": 110.0}
    assert metrics.DISPATCHER_GENERATION.value == status["dynamic"]["generation"]
    for wid, entry in per_worker.items():
        assert metrics.DISPATCHER_BACKLOG_PIECES.labels(wid).value == entry["backlog"]
        assert metrics.DISPATCHER_STEALS.labels(wid, "out").value == entry["steals_out"]
    with Dispatcher(mode="static") as static:
        assert static.fleet_signals()["backlog_known"] is False


def test_status_table_renders_the_jax_steal_columns(tmp_path):
    from petastorm_tpu.service.cli import render_fleet_status
    from petastorm_tpu_torch.service.cli import render_status

    dispatcher = _start(port_service, tmp_path / "s")
    try:
        _play(dispatcher, SCRIPT[:11])
        status = dispatcher._handle({"type": "status"})
    finally:
        dispatcher.stop()
    port = render_status(status).splitlines()
    workers = {wid: {"metrics": {"rows_sent_total": 0.0}} for wid in status["workers"]}
    jax = render_fleet_status({"t": 0.0, "status": status, "workers": workers},
                              {"t": 1.0, "status": status, "workers": workers}).splitlines()
    generation = f"generation={status['dynamic']['generation']}"
    assert generation in port[0] and generation in jax[0]
    assert port[1].split()[-3:] == jax[1].split()[-3:] == ["STEALS", "BACKLOG", "BREAKER"]
    for wid in status["workers"]:
        port_row = next(line for line in port if line.startswith(wid))
        jax_row = next(line for line in jax if line.startswith(wid))
        assert port_row.split()[-3:] == jax_row.split()[-3:]
        assert port_row[-27:] == jax_row[-27:]  # the same fixed-width columns
    static = render_status(dict(status, dynamic=None, mode="static")).splitlines()
    assert "generation" not in static[0]
    assert all(line.split()[-3:-1] == ["--", "--"] for line in static[2:2 + len(workers)])


# ---------------------------------------------------------------------------
# the loopback fleet
# ---------------------------------------------------------------------------

def _fleet(package, url, delays=(0.0, 0.0), num_epochs=1, prefix="w", **dispatcher_kwargs):
    dispatcher = package.Dispatcher(mode="dynamic", num_epochs=num_epochs,
                                    **dispatcher_kwargs).start()
    workers = [package.BatchWorker(url, dispatcher_address=dispatcher.address, batch_size=2,
                                   reader_factory="batch", worker_id=f"{prefix}{i}",
                                   batch_delay_s=delay, reader_kwargs={"workers_count": 2}
                                   ).start()
               for i, delay in enumerate(delays)]
    return dispatcher, workers


def _stop(dispatcher, workers):
    for worker in workers:
        worker.stop()
    dispatcher.stop()


def _ids(batch):
    return [int(i) for i in np.asarray(batch["id"])]


def test_loopback_fleet_equals_the_local_reader_and_jax_ordered(store):
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    with make_batch_reader(store, reader_pool_type="dummy", shuffle_row_groups=False) as r:
        local = sorted(i for batch in r for i in np.asarray(batch.id).tolist())
    out = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        dispatcher, workers = _fleet(package, store, shuffle_seed=9, prefix=f"{name}-lo-")
        try:
            source = package.ServiceBatchSource(dispatcher.address, ordered=True,
                                                dynamic_sync_interval_s=0.1)
            out[name] = [(_ids(b), sorted(b)) for b in source()]
            status = source.dispatcher_status()
        finally:
            _stop(dispatcher, workers)
        assert status["dynamic"]["clients"][source.client_id]["pieces_done"] == 12
    assert sorted(sum((ids for ids, _ in out["port"]), [])) == local == list(range(ROWS))
    assert out["port"] == out["jax"]  # the same batches in the same order


def test_skewed_worker_is_stolen_from_with_no_row_lost_or_repeated(store):
    dispatcher, workers = _fleet(port_service, store, delays=(0.1, 0.0), prefix="skew-")
    try:
        source = ServiceBatchSource(dispatcher.address, dynamic_sync_interval_s=0.05)
        got = sorted(i for b in source() for i in _ids(b))
        status = source.dispatcher_status()
    finally:
        _stop(dispatcher, workers)
    assert got == list(range(ROWS))
    diagnostics = source.diagnostics
    assert diagnostics["recovery"]["steals_applied"] >= 1
    assert diagnostics["recovery"]["dedup_dropped"] == 0
    pieces = {w: c.get("pieces", 0) for w, c in diagnostics["per_worker"].items()}
    assert sum(pieces.values()) == 12 and pieces["skew-1"] > pieces.get("skew-0", 0)
    per_worker = status["dynamic"]["per_worker"]
    assert per_worker["skew-0"]["steals_out"] >= 1 and per_worker["skew-1"]["steals_in"] >= 1
    assert source.state_dict()["mode"] == "dynamic"


def test_a_worker_joining_mid_epoch_receives_steals(store):
    dispatcher, workers = _fleet(port_service, store, delays=(0.1,), prefix="join-")
    try:
        source = ServiceBatchSource(dispatcher.address, dynamic_sync_interval_s=0.05)
        got = []
        for batch in source():
            got.extend(_ids(batch))
            if len(workers) == 1:
                workers.append(BatchWorker(
                    store, dispatcher_address=dispatcher.address, batch_size=2,
                    reader_factory="batch", worker_id="join-1",
                    reader_kwargs={"workers_count": 2}).start())
    finally:
        _stop(dispatcher, workers)
    assert sorted(got) == list(range(ROWS))
    assert source.diagnostics["per_worker"]["join-1"]["pieces"] >= 1
    assert source.diagnostics["recovery"]["steals_applied"] >= 1


def test_several_epochs_deliver_every_epoch(store):
    dispatcher, workers = _fleet(port_service, store, delays=(0.02, 0.0), num_epochs=3,
                                 prefix="ep-")
    try:
        source = ServiceBatchSource(dispatcher.address, dynamic_sync_interval_s=0.05)
        got = sorted(i for b in source() for i in _ids(b))
        epochs = [epoch for _, epoch in source.diagnostics["epoch_starts"]]
    finally:
        _stop(dispatcher, workers)
    assert got == sorted(list(range(ROWS)) * 3)
    assert epochs == [0, 1, 2, 3]


@pytest.mark.parametrize("resume_mode", ["dynamic", "static"])
def test_a_state_dict_resume_across_a_steal(store, resume_mode):
    """A snapshot taken after a steal moved pieces resumes exactly once, on
    a dynamic dispatcher and on a static one (the snapshots are
    interchangeable)."""
    dispatcher, workers = _fleet(port_service, store, delays=(0.1, 0.0),
                                 prefix=f"res-{resume_mode}-")
    try:
        source = ServiceBatchSource(dispatcher.address, dynamic_sync_interval_s=0.05)
        first, state = [], None
        iterator = source()
        for batch in iterator:
            first.extend(_ids(batch))
            state = source.state_dict()
            if len(first) >= ROWS // 2 and state["completed_pieces"] \
                    and source.diagnostics["recovery"]["steals_applied"]:
                break
        else:
            pytest.fail("the stream ended before a steal and a snapshot")
        iterator.close()
    finally:
        _stop(dispatcher, workers)
    assert state["mode"] == "dynamic"
    for piece in state["completed_pieces"]:
        assert set(range(5 * piece, 5 * piece + 5)) <= set(first)
    if resume_mode == "dynamic":
        dispatcher, workers = _fleet(port_service, store, prefix="res2-")
    else:
        dispatcher = Dispatcher(mode="static").start()
        workers = [BatchWorker(store, dispatcher_address=dispatcher.address, batch_size=2,
                               reader_factory="batch", worker_id="res2-static",
                               reader_kwargs={"workers_count": 2}).start()]
    try:
        resumed = ServiceBatchSource(dispatcher.address, resume_state=state,
                                     dynamic_sync_interval_s=0.05)
        second = [i for b in resumed() for i in _ids(b)]
    finally:
        _stop(dispatcher, workers)
    assert sorted(first + second) == list(range(ROWS))
    assert resumed.diagnostics["recovery"]["duplicates_dropped"] == 0


def test_a_dispatcher_restarted_mid_steal_reconciles_by_corrective_deltas(store, tmp_path):
    """The first sync reply carrying steals is lost after the steals were
    journaled (the dispatcher dies before its reply lands, answering nothing
    more); it restarts from its journal on the same port, and the client's
    next sync gets the journaled steals back as corrective deltas, which it
    applies. Every row arrives once."""
    journal = str(tmp_path / "journal")
    dispatcher, workers = _fleet(port_service, store, delays=(0.1, 0.0), prefix="rst-",
                                 journal_dir=journal, lease_timeout_s=None)
    port = dispatcher.address[1]
    lost = threading.Event()
    source = ServiceBatchSource(dispatcher.address, dynamic_sync_interval_s=0.05,
                                heartbeat_interval_s=0.1)

    def losing(handler):
        def handle(header):
            if lost.is_set():
                raise ConnectionError("the dispatcher is going down")
            reply = handler(header)
            if reply.get("steals"):
                lost.set()
                raise ConnectionError("the reply is lost with the dispatcher")
            return reply
        return handle

    dispatcher._handle_dynamic_sync = losing(dispatcher._handle_dynamic_sync)
    corrective = []
    restarted = None
    got = []
    try:
        for batch in source():
            got.extend(_ids(batch))
            if lost.is_set() and restarted is None:
                dispatcher.stop()
                restarted = Dispatcher(port=port, mode="dynamic", journal_dir=journal,
                                       lease_timeout_s=None)
                handler = restarted._handle_dynamic_sync

                def watch(header, handler=handler, server=restarted):
                    generation = server._generation
                    reply = handler(header)
                    corrective.extend(d for d in reply.get("steals", [])
                                      if d["generation"] <= generation)
                    return reply
                restarted._handle_dynamic_sync = watch
                restarted.start()
        status = restarted._handle({"type": "status"}) if restarted is not None else None
    finally:
        for worker in workers:
            worker.stop()
        (restarted or dispatcher).stop()
    assert lost.is_set() and restarted is not None
    assert sorted(got) == list(range(ROWS))
    assert status["recovery"]["journal_replays"] == 1
    assert corrective, "no corrective delta after the restart"
    assert source.diagnostics["recovery"]["steals_applied"] >= 1
    assert source.diagnostics["recovery"]["dedup_dropped"] == 0
