"""The port's data-service control plane against the JAX package's, and on
its own fleets over 127.0.0.1.

- Same requests, same answers: one request sequence goes in process
  (``_handle``) to both packages' journaled dispatchers; the replies (the
  clock beacon and lease times masked) and the ``state_snapshot()`` s are
  equal, after a restart from the journal too, and each package recovers
  the other's journal to the same state. A failed journal write flips both
  read-only alike.
- Mirrors of the JAX recovery tests on the port's fleet: a restart
  restores the state byte for byte, the fcfs cursor, the mode mismatch,
  two restarts, the client heartbeat, a fencing resync that is a no-op, a
  resync failure that keeps training, a dispatcher killed and restarted
  mid-epoch with no row lost or repeated.
- Under failpoints (slow peer with hedging, breaker trips, dropped replies
  and heartbeats) every row arrives exactly once.
- Quarantine: a worker that sends ``piece_failed`` for one piece; the
  piece is left out, journaled, and still left out after a restart.
- The CLI's journal flags, ``status --table``, ``trace`` and
  ``diagnose``; fleet tracing through heartbeats.
- The control plane's metric families equal the JAX families; the loader
  snapshots a source's ``diagnostics`` into ``diagnostics["source"]`` as
  the JAX loader does.

Intervals are 0.05–0.25 s. Each test stops every node it starts.
Everything is compared exactly.
"""

import contextlib
import copy
import json
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import failpoints as jax_fp
from petastorm_tpu import service as jax_service
from petastorm_tpu_torch import failpoints as port_fp
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
from petastorm_tpu_torch.service import (
    BatchWorker,
    Dispatcher,
    ServiceBatchSource,
    ServiceError,
)

FAST = dict(max_retries=1, backoff_base=0.02, backoff_max=0.05)


@pytest.fixture(autouse=True)
def _port_schedule_leak_guard():
    """Fail a test that leaves the port's schedule armed (the shared leak
    guard watches the JAX package's only)."""
    yield
    if port_fp.ACTIVE is not None:
        port_fp.disarm()
        pytest.fail("a port FaultSchedule outlived its test: use failpoints.armed(...)")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Plain Parquet: 120 rows in 24 row groups of 5."""
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path_factory.mktemp('ctl')}/scalar"
    create_test_scalar_dataset(url, rows_count=120, rows_per_row_group=5)
    return url


def _ids(batch):
    return [int(i) for i in np.asarray(batch["id"])]


def _request(address, header):
    with FramedConnection.connect(address, timeout=5) as conn:
        return conn.request(header)[0]


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


@contextlib.contextmanager
def fleet(url, workers=2, dispatcher=None, worker_cls=BatchWorker, prefix="w",
          worker_kwargs=None, **dispatcher_kwargs):
    """A port dispatcher (given or started here) and ``workers`` batch
    workers (batch factory, batch 4, 2 reader threads), stopped on exit."""
    owned = dispatcher is None
    dispatcher = dispatcher or Dispatcher(**dispatcher_kwargs).start()
    started = []
    try:
        for i in range(workers):
            started.append(worker_cls(
                url, dispatcher_address=dispatcher.address, batch_size=4,
                reader_factory="batch", worker_id=f"{prefix}{i}",
                reader_kwargs={"workers_count": 2}, **(worker_kwargs or {})).start())
        yield dispatcher, started
    finally:
        for worker in started:
            worker.stop()
        if owned:
            dispatcher.stop()


# ---------------------------------------------------------------------------
# same requests, same answers
# ---------------------------------------------------------------------------

def _reg(wid, pieces, port):
    return {"type": "register_worker", "worker_id": wid, "host": "127.0.0.1", "port": port,
            "num_pieces": pieces}


def _assign(cid, index, count, epoch=0):
    return {"type": "get_assignment", "client_id": cid, "client_index": index,
            "num_clients": count, "epoch": epoch}


def _hb(cid, **kw):
    return dict({"type": "client_heartbeat", "client_id": cid}, **kw)


SCENARIOS = {
    "static": (dict(mode="static", num_epochs=2, shuffle_seed=3, breaker_cooldown_s=0.0), [
        _reg("w0", 9, 1), _reg("w1", 9, 2), _reg("w2", 9, 3),
        _assign("c0", 0, 2), _assign("c1", 1, 2),
        _hb("c0", epoch=0, watermarks={"3": 2}, ready_saturation=0.5),
        _hb("c0", epoch=0, watermarks={"3": 3}, ready_saturation=0.25),
        _hb("c0", epoch=0, watermarks={"3": 3, "6": 1}),
        {"type": "report_poison_piece", "client_id": "c0", "piece": 4, "worker_id": "w1",
         "error": "undecodable row group", "epoch": 0},
        {"type": "report_poison_piece", "client_id": "c1", "piece": 4, "worker_id": "w1",
         "error": "again", "epoch": 0},
        _assign("c0", 0, 2, epoch=1),
        {"type": "report_breaker", "client_id": "c0", "worker_id": "w1",
         "error": "2 consecutive stream failures", "epoch": 1},
        {"type": "report_breaker", "client_id": "c0", "worker_id": "nobody"},
        _assign("c1", 1, 2, epoch=1), {"type": "list_workers"},
        ("brownout", "shed", 1, "operator"), ("brownout", "shed", 1, "stale"),
        {"type": "worker_heartbeat", "worker_id": "w1", "credit_wait_s": 0.5},
        _assign("c1", 1, 2, epoch=1),
        {"type": "report_failure", "client_id": "c0", "worker_id": "w2",
         "pieces": [2, 4, 8], "fencing_epoch": 0},
        {"type": "report_failure", "client_id": "c0", "worker_id": "w0", "pieces": [0],
         "fencing_epoch": 0},
        _hb("nobody"), {"type": "worker_heartbeat", "worker_id": "w2"},
        {"type": "stage_profile", "profile": {"worker.decode": {"count": 2}},
         "coverage_pct": 50.0},
        {"type": "stage_profile", "profile": "not a dict"},
        ("brownout", "recover", 0, None),
        {"type": "status"}]),
    "fcfs": (dict(mode="fcfs", num_epochs=2), [
        {"type": "next_split", "client_id": "c"}, _reg("w0", 4, 1),
        {"type": "next_split", "client_id": "c"}, {"type": "next_split", "client_id": "c"},
        {"type": "report_poison_piece", "client_id": "c", "piece": 2, "worker_id": "w0",
         "error": "bad", "epoch": 0}]
        + [{"type": "next_split", "client_id": "c"}] * 6
        + [_assign("c", 0, 1), {"type": "status"}]),
}

#: Reply fields that are clocks, not state.
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
        if isinstance(step, tuple):
            replies.append(dispatcher.apply_brownout(*step[1:]))
            continue
        reply = dispatcher._handle(copy.deepcopy(step))
        reply = dict(reply[0] if isinstance(reply, tuple) else reply)
        if reply["type"] == "status":
            # The port also keeps the metrics endpoint at the top level (the
            # JAX reply has it under "observability" only).
            assert reply.pop("metrics_address", None) == \
                reply["observability"]["metrics_address"]
        replies.append(_mask(reply))
    return replies


def _start(package, kwargs, journal_dir):
    return package.Dispatcher(journal_dir=str(journal_dir), lease_timeout_s=None,
                              **kwargs).start()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_requests_give_the_same_answers_and_state(scenario, tmp_path):
    kwargs, steps = SCENARIOS[scenario]
    out = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        dispatcher = _start(package, kwargs, tmp_path / name)
        try:
            replies = _play(dispatcher, steps)
            before = dispatcher.state_snapshot()
        finally:
            dispatcher.stop()
        restarted = _start(package, kwargs, tmp_path / name)
        try:
            after = restarted.state_snapshot()
            again = _play(restarted, steps[-3:])
        finally:
            restarted.stop()
        out[name] = (replies, before, after, again)
    assert out["port"] == out["jax"]
    replies, before, after, _ = out["port"]
    assert json.loads(json.dumps(before)) == before
    assert after["recovery"]["journal_replays"] == 1
    assert after["fencing_epoch"] == before["fencing_epoch"] + 1
    plan = ("workers", "clients", "quarantined", "breaker_open", "client_watermarks",
            "brownout", "fcfs_epoch")
    assert {k: before[k] for k in plan} == {k: after[k] for k in plan}
    # A quarantined split skipped live has no next_split record, so a replay
    # leaves it queued (in both packages); next_split skips it again.
    quarantined = {int(p) for p in before["quarantined"]}
    assert [p for p in after["fcfs_queue"] or [] if p not in quarantined] == \
        (before["fcfs_queue"] or [])
    if scenario == "static":
        assert before["quarantined"]["4"]["error"] == "undecodable row group"
        epoch1 = replies[10]["assignments"]
        assert 4 not in sum(epoch1.values(), [])
        assert replies[13] == {"type": "assignment", "epoch": 1, "fencing_epoch": 0,
                               "credit_scale": 1.0, "assignments": replies[13]["assignments"],
                               "workers": replies[13]["workers"]}
        assert sorted(replies[13]["workers"]) == ["w0", "w2"]  # routed around w1
        assert sorted(replies[18]["workers"]) == ["w0", "w1", "w2"]  # heartbeat closed it
        assert replies[20]["type"] == "stale_fencing"
        assert replies[-1]["fleet"]["brownout"]["counts"] == {"shed": 1, "recover": 1}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_journal(writer, tmp_path):
    kwargs, steps = SCENARIOS["static"]
    packages = {"port": port_service, "jax": jax_service}
    dispatcher = _start(packages[writer], kwargs, tmp_path / "j")
    try:
        _play(dispatcher, steps[:-1])
    finally:
        dispatcher.stop()
    snapshots = {}
    for name in (("port", "jax") if writer == "jax" else ("jax", "port")):
        # Each restart bumps the epoch: compare the first reader's view
        # against a fresh copy of the writer's journal for the second.
        recovered = _start(packages[name], kwargs, tmp_path / "j")
        try:
            snapshots[name] = recovered.state_snapshot()
        finally:
            recovered.stop()
    first, second = snapshots.values()
    assert second["recovery"]["journal_replays"] == first["recovery"]["journal_replays"] + 1
    assert {k: v for k, v in first.items() if k not in ("recovery", "fencing_epoch")} == \
        {k: v for k, v in second.items() if k not in ("recovery", "fencing_epoch")}


def test_later_slice_journal_records_are_refused_by_name(tmp_path):
    """No WAL record is refused by slice any more: each replays in the port
    as in the JAX dispatcher (states equal), a ``mixture_weights`` record
    into the job's mixture weight log, a ``dynamic_plan`` into the plan, the
    fleet's ``job_register`` into the job and ``autoscale`` into the
    worker's state and the counts."""
    from petastorm_tpu_torch.service.journal import Journal

    records = {
        "dynamic_plan": ("dynamic", {"client_id": "c", "epoch": 0,
                                     "owner": [[0, "w0", 4], [1, "w1", 4]],
                                     "generation": 4}),
        "job_register": ("static", {"job_id": "x", "weight": 2.0, "quota": None,
                                    "restart": True}),
        "mixture_weights": ("static", {"job_id": "x", "seq": 1, "weights": {"web": 1.0},
                                       "effective_epoch": 2, "token": "t"}),
        "autoscale": ("static", {"action": "admit", "worker_id": "w0"}),
    }
    for op, (mode, fields) in records.items():
        states = {}
        for name, package in (("port", port_service), ("jax", jax_service)):
            path = tmp_path / name / op
            journal = Journal(path)
            journal.snapshot(Dispatcher(mode=mode).state_snapshot())
            if op == "autoscale":
                journal.append({"op": "register_worker", "worker_id": "w0",
                                "host": "127.0.0.1", "port": 9, "num_pieces": 4,
                                "re_register": False, "standby": True})
            journal.append(dict(fields, op=op))
            journal.close()
            dispatcher = package.Dispatcher(mode=mode, journal_dir=str(path)).start()
            try:
                states[name] = dispatcher.state_snapshot()
            finally:
                dispatcher.stop()
        state = states["port"]
        assert state == states["jax"], op
        if op == "dynamic_plan":
            assert state["generation"] == 4
            assert state["dyn"] == {"c": {"epoch": 0, "owner": [[0, "w0", 4], [1, "w1", 4]],
                                          "done": [], "steals": {}}}
        elif op == "job_register":
            assert state["jobs"] == {"x": {"weight": 2.0, "quota": None, "fencing_offset": 0,
                                           "epoch": 0}}
        elif op == "mixture_weights":
            assert state["mixtures"] == {"x": {
                "seq": 1, "entries": [{"seq": 1, "weights": {"web": 1.0},
                                       "effective_epoch": 2}],
                "last_token": "t"}}
        else:
            assert state["workers"]["w0"]["state"] == "serving"
            assert state["autoscale"] == {"admit": 1, "drain": 0, "retire": 0}


def test_a_failed_journal_write_flips_both_read_only(tmp_path):
    steps = [_reg("w0", 4, 1), _assign("c", 0, 1), _assign("c", 0, 1),
             {"type": "status"}, _assign("c", 0, 1), {"type": "status"}]
    out = {}
    for name, package, fp in (("port", port_service, port_fp), ("jax", jax_service, jax_fp)):
        dispatcher = _start(package, {}, tmp_path / name)
        schedule = fp.FaultSchedule(0, points=["journal.append", "journal.compact"],
                                    fires={"journal.append": {1: "enospc"},
                                           "journal.compact": {0: "torn_rename"}})
        try:
            with fp.armed(schedule):
                replies = _play(dispatcher, steps)
        finally:
            dispatcher.stop()
        out[name] = (replies, schedule.log_snapshot())
    assert out["port"] == out["jax"]
    replies = out["port"][0]
    assert replies[1]["type"] == "assignment"  # applied; its WAL record was lost
    assert replies[2]["type"] == "error" and replies[2]["retryable"]  # read-only
    assert "read-only" in replies[2]["error"]
    assert replies[3]["degraded"].startswith("journal write failed")
    assert replies[4]["type"] == "assignment"  # the recovery snapshot succeeded
    assert replies[5]["degraded"] is None
    assert replies[5]["recovery"]["journal_write_failures"] == 2


# ---------------------------------------------------------------------------
# the JAX recovery tests, mirrored on the port
# ---------------------------------------------------------------------------

def test_dispatcher_restart_restores_state_byte_identical(tmp_path):
    journal_dir = str(tmp_path / "journal")
    with Dispatcher(num_epochs=2, journal_dir=journal_dir).start() as disp:
        _request(disp.address, _reg("w0", 10, 1))
        _request(disp.address, _reg("w1", 10, 2))
        _request(disp.address, _assign("c0", 0, 2, epoch=1))
        _request(disp.address, {"type": "report_failure", "client_id": "c0",
                                "worker_id": "w1", "pieces": [1, 3]})
        before = disp.state_snapshot()
        assignment_before = _request(disp.address, _assign("c0", 0, 2, epoch=1))
    with Dispatcher(num_epochs=2, journal_dir=journal_dir).start() as restarted:
        after = restarted.state_snapshot()
        volatile = ("fencing_epoch", "recovery")
        assert json.dumps({k: v for k, v in before.items() if k not in volatile},
                          sort_keys=True) == \
            json.dumps({k: v for k, v in after.items() if k not in volatile}, sort_keys=True)
        assert _request(restarted.address, _assign("c0", 0, 2, epoch=1))["assignments"] == \
            assignment_before["assignments"]
        assert after["recovery"]["journal_replays"] == 1
        assert after["fencing_epoch"] > before["fencing_epoch"]
        status = _request(restarted.address, {"type": "status"})
        assert status["recovery"]["journal_replays"] == 1
        assert status["journal"]["path"] == journal_dir


def test_dispatcher_restart_resumes_fcfs_cursor(tmp_path):
    journal_dir = str(tmp_path / "journal")
    seen = []
    with Dispatcher(mode="fcfs", journal_dir=journal_dir).start() as disp:
        _request(disp.address, _reg("w0", 5, 1))
        for _ in range(3):
            reply = _request(disp.address, {"type": "next_split", "client_id": "c"})
            seen.append(reply["piece"])
    with Dispatcher(mode="fcfs", journal_dir=journal_dir).start() as restarted:
        while True:
            reply = _request(restarted.address, {"type": "next_split", "client_id": "c"})
            if reply["type"] == "end_of_stream":
                break
            seen.append(reply["piece"])
    assert sorted(seen) == [0, 1, 2, 3, 4]


def test_dispatcher_journal_mode_mismatch_rejected(tmp_path):
    journal_dir = str(tmp_path / "journal")
    with Dispatcher(journal_dir=journal_dir).start() as disp:
        _request(disp.address, _reg("w0", 3, 1))
    with pytest.raises(ValueError, match="mode"):
        Dispatcher(mode="fcfs", journal_dir=journal_dir).start()
    with pytest.raises(ValueError, match="shuffle_seed"):
        Dispatcher(shuffle_seed=5, journal_dir=journal_dir).start()


def test_dispatcher_double_restart_counts_two_replays(tmp_path):
    journal_dir = str(tmp_path / "journal")
    with Dispatcher(journal_dir=journal_dir).start() as disp:
        _request(disp.address, _reg("w0", 3, 1))
    with Dispatcher(journal_dir=journal_dir).start():
        pass
    with Dispatcher(journal_dir=journal_dir).start() as third:
        assert third.state_snapshot()["recovery"]["journal_replays"] == 2
        assert sorted(third.state_snapshot()["workers"]) == ["w0"]


def test_client_heartbeat_reports_fencing_and_recovery():
    with Dispatcher().start() as disp:
        _request(disp.address, _reg("w0", 3, 1))
        reply = _request(disp.address, _hb("nobody"))
        assert (reply["type"], reply["known"], reply["fencing_epoch"]) == ("ok", False, 0)
        assert reply["recovery"]["journal_replays"] == 0
        assert reply["brownout_level"] == 0 and reply["trace"] is False
        _request(disp.address, _assign("c", 0, 1))
        assert _request(disp.address, _hb("c"))["known"] is True


def _run(source, on_batch=None):
    got = []
    for batch in source():
        got.extend(_ids(batch))
        if on_batch is not None:
            on_batch(got)
    return got


def test_fencing_bump_resync_is_noop_when_plan_unchanged(store):
    with fleet(store, worker_kwargs={"batch_delay_s": 0.03}) as (dispatcher, _):
        source = ServiceBatchSource(dispatcher.address, heartbeat_interval_s=0.05)
        bumped = []

        def bump(got):
            if not bumped and len(got) >= 8:
                with dispatcher._lock:  # an eviction-shaped epoch bump
                    dispatcher._bump_fencing_locked("test")
                bumped.append(True)

        got = _run(source, bump)
    assert sorted(got) == list(range(120))  # none lost, none twice
    recovery = source.diagnostics["recovery"]
    assert recovery["resyncs"] >= 1 and recovery["streams_retired"] == 0
    assert recovery["fencing_epoch"] >= 1 and recovery["dispatcher"]["fencing_bumps"] >= 1


def test_resync_failure_keeps_streams_and_training_alive(store):
    dispatcher = Dispatcher().start()
    port = dispatcher.address[1]
    state = {"dispatcher": dispatcher}
    try:
        # No worker heartbeats: the restarted dispatcher stays empty.
        with fleet(store, dispatcher=dispatcher,
                   worker_kwargs={"batch_delay_s": 0.03, "heartbeat_interval_s": None}):
            source = ServiceBatchSource(dispatcher.address, heartbeat_interval_s=0.05, **FAST)

            def restart(got):
                if len(got) >= 8 and state["dispatcher"] is dispatcher:
                    dispatcher.stop()
                    state["dispatcher"] = Dispatcher(port=port).start()  # amnesiac

            got = _run(source, restart)
    finally:
        state["dispatcher"].stop()
        dispatcher.stop()
    assert sorted(got) == list(range(120))
    recovery = source.diagnostics["recovery"]
    assert recovery["resync_failures"] >= 1 and recovery["streams_retired"] == 0


def test_dispatcher_kill_restart_mid_epoch_no_loss_no_dup(store, tmp_path):
    journal_dir = str(tmp_path / "journal")
    kwargs = dict(num_epochs=2, journal_dir=journal_dir, lease_timeout_s=5.0)
    dispatcher = Dispatcher(**kwargs).start()
    port = dispatcher.address[1]
    state = {"dispatcher": dispatcher, "fencing": None}
    try:
        with fleet(store, dispatcher=dispatcher,
                   worker_kwargs={"batch_delay_s": 0.03, "heartbeat_interval_s": 0.1}):
            source = ServiceBatchSource(dispatcher.address, max_retries=6, backoff_base=0.05,
                                        backoff_max=0.2, heartbeat_interval_s=0.05)

            def kill(got):
                if len(got) >= 12 and state["dispatcher"] is dispatcher:
                    state["fencing"] = dispatcher.state_snapshot()["fencing_epoch"]
                    dispatcher.stop()
                    dispatcher.drop_connections()
                    time.sleep(0.1)  # an outage the data plane rides out
                    state["dispatcher"] = Dispatcher(port=port, **kwargs).start()

            got = _run(source, kill)
            status = source.dispatcher_status()
    finally:
        state["dispatcher"].stop()
        dispatcher.stop()
    assert sorted(got) == sorted(list(range(120)) * 2)  # two epochs, exactly
    assert status["recovery"]["journal_replays"] == 1
    assert status["fencing_epoch"] > state["fencing"]
    recovery = source.diagnostics["recovery"]
    assert recovery["resyncs"] >= 1 and recovery["streams_retired"] == 0


# ---------------------------------------------------------------------------
# failpoints on the port's fleet
# ---------------------------------------------------------------------------

def test_hedging_races_a_slow_peer_and_delivers_every_row_once(store):
    # Two 1 s stalls of w1 against a threshold fit at the median gap (a high
    # quantile of a few gaps is the largest, a reader's start-up).
    schedule = port_fp.FaultSchedule(
        1, points=["slow-peer", "hedge-race"], delay_s=1.0, targets={"slow-peer": "w1"},
        fires={"slow-peer": {4: "delay", 12: "delay"}})
    with fleet(store) as (dispatcher, _), port_fp.armed(schedule):
        source = ServiceBatchSource(dispatcher.address, hedging=True, hedge_quantile=0.5,
                                    hedge_min_samples=4, hedge_floor_s=0.05,
                                    hedge_multiplier=2.0, credits=2, ordered=True)
        got = _run(source)
    assert sorted(got) == list(range(120))
    counts = source.diagnostics["resilience"]["hedge_counts"]
    assert counts["launched"] >= 1
    assert counts["launched"] >= counts["won"] + counts["lost"]
    assert any(p == "slow-peer" for p, _, _ in schedule.log)


def test_a_breaker_trips_routes_around_and_delivers_every_row_once(store):
    schedule = port_fp.FaultSchedule(2, points=["breaker-trip"],
                                     fires={"breaker-trip": {i: "reset" for i in range(8)}})
    with fleet(store, worker_kwargs={"batch_delay_s": 0.01}) as (dispatcher, workers):
        source = ServiceBatchSource(dispatcher.address, breaker_threshold=2, credits=2,
                                    **FAST)
        dropped = []

        def drop(got):
            if not dropped and len(got) >= 12:
                workers[1].drop_connections()
                dropped.append(True)

        # Only reconnects pass the breaker-trip point: w1's fail.
        with port_fp.armed(schedule):
            got = _run(source, drop)
        assert _wait(lambda: "w1" in _request(dispatcher.address, {"type": "status"})
                     ["fleet"]["breaker_open"], timeout=5)
        status = _request(dispatcher.address, {"type": "status"})
        assignment = _request(dispatcher.address, _assign("late", 0, 1))
    assert sorted(got) == list(range(120))
    assert status["fleet"]["breaker_open"]["w1"]["client_id"] == source.client_id
    assert sorted(assignment["workers"]) == ["w0"]  # new grants route around w1
    assert source.diagnostics["resilience"]["breakers"]["w1"]["state"] == "open"
    assert source.diagnostics["recovery"]["takeovers"] >= 1


def test_dropped_replies_and_heartbeats_lose_no_row(store):
    # Reply 2 is the client's list_workers, 4 its get_assignment (both
    # retried); the later ones are heartbeats and trace-free status polls.
    schedule = port_fp.FaultSchedule(
        3, points=["dispatcher.reply", "worker.heartbeat"],
        fires={"dispatcher.reply": {2: "drop", 4: "drop", 7: "drop"},
               "worker.heartbeat": {1: "drop", 2: "drop", 3: "drop"}})
    with port_fp.armed(schedule):
        with fleet(store, lease_timeout_s=2.0,
                   worker_kwargs={"heartbeat_interval_s": 0.05,
                                  "batch_delay_s": 0.01}) as (dispatcher, _):
            source = ServiceBatchSource(dispatcher.address, heartbeat_interval_s=0.05,
                                        max_retries=4, backoff_base=0.02, backoff_max=0.05)
            got = _run(source)
    assert sorted(got) == list(range(120))
    assert [(p, i) for p, i, _ in schedule.log if p == "dispatcher.reply"][:2] == \
        [("dispatcher.reply", 2), ("dispatcher.reply", 4)]
    assert ("worker.heartbeat", 3, "drop") in schedule.log


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

POISON = 7


class PoisonWorker(BatchWorker):
    """A worker whose piece ``POISON`` does not decode: it announces a
    ``piece_failed`` frame in place of the piece's batches."""

    def _stream_pieces_tagged(self, tx, conn_reader, state, pieces, flow, credits,
                              stream_key, starts, **kwargs):
        # ``tx``: the stream's negotiated transport (TCP or the shm ring).
        if POISON in pieces:
            tx.send({"type": "piece_failed", "piece": POISON,
                     "error": "undecodable row group"})
        healthy = [p for p in pieces if p != POISON]
        if not healthy:
            return 0
        return super()._stream_pieces_tagged(tx, conn_reader, state, healthy, flow,
                                             credits, stream_key, starts, **kwargs)


def test_a_quarantined_piece_is_left_out_journaled_and_survives_a_restart(store,
                                                                          tmp_path):
    journal_dir = str(tmp_path / "journal")
    kwargs = dict(num_epochs=2, journal_dir=journal_dir)
    poison_rows = list(range(POISON * 5, POISON * 5 + 5))
    with fleet(store, worker_cls=PoisonWorker, **kwargs) as (dispatcher, _):
        with pytest.raises(ServiceError, match="on_piece_error='fail'"):
            _run(ServiceBatchSource(dispatcher.address))
        source = ServiceBatchSource(dispatcher.address, on_piece_error="quarantine",
                                    ordered=True)
        got = _run(source)
        status = _request(dispatcher.address, {"type": "status"})
    healthy = sorted(set(range(120)) - set(poison_rows))
    assert sorted(got) == sorted(healthy * 2)  # both epochs, without the piece
    quarantined = source.diagnostics["quarantined_pieces"]
    assert [(q["piece"], q["epoch"]) for q in quarantined] == [(POISON, 0)]
    assert source.diagnostics["recovery"]["pieces_quarantined"] == 1
    assert status["quarantined"][str(POISON)]["error"] == "undecodable row group"
    with Dispatcher(**kwargs).start() as restarted:
        assert str(POISON) in restarted.state_snapshot()["quarantined"]
        _request(restarted.address, _reg("x", 24, 1))
        granted = _request(restarted.address, _assign("c", 0, 1))["assignments"]
        assert sorted(sum(granted.values(), [])) == [p for p in range(24) if p != POISON]


# ---------------------------------------------------------------------------
# the CLI, fleet tracing
# ---------------------------------------------------------------------------

def _serve(argv, stop, capsys, role):
    from petastorm_tpu_torch.service.cli import main

    thread = threading.Thread(target=main, args=(argv,),
                              kwargs={"run_seconds": 30, "stop_event": stop}, daemon=True)
    thread.start()
    record = {}

    def ready():
        for line in capsys.readouterr().out.splitlines():
            if line.startswith("{") and json.loads(line).get("role") == role:
                record.update(json.loads(line))
        return bool(record)

    assert _wait(ready)
    return thread, record


def test_cli_journal_flags_take_effect(tmp_path, capsys):
    from petastorm_tpu_torch.service.cli import _build_parser, build_service_node, main

    journal_dir = str(tmp_path / "journal")
    argv = ["dispatcher", "--port", "0", "--journal-dir", journal_dir,
            "--journal-compact-every", "2", "--journal-fsync"]
    node = build_service_node(_build_parser().parse_args(argv))
    assert node._journal._compact_every == 2 and node._journal._fsync is True
    for _ in range(2):
        stop = threading.Event()
        thread, record = _serve(argv, stop, capsys, "dispatcher")
        for wid in ("w0", "w1", "w2"):
            _request(("127.0.0.1", record["port"]), _reg(wid, 6, 1))
        assert main(["status", "--dispatcher", f"127.0.0.1:{record['port']}"]) == 0
        status = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert main(["status", "--table", "--dispatcher", f"127.0.0.1:{record['port']}"]) == 0
        table = capsys.readouterr().out
        stop.set()
        thread.join(timeout=15)
        assert not thread.is_alive()
    assert status["recovery"]["journal_replays"] == 1 and status["journal"]["compactions"] >= 1
    assert "BREAKER" in table and "brownout: level=0 shed=0 recover=0" in table
    assert f"journal: {journal_dir}" in table and "replays=1" in table


def test_fleet_tracing_through_heartbeats_and_the_cli(store, tmp_path, capsys):
    from petastorm_tpu_torch.service.cli import main
    from petastorm_tpu_torch.telemetry import tracing
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    with fleet(store, worker_kwargs={"heartbeat_interval_s": 0.05,
                                     "batch_delay_s": 0.01}) as (dispatcher, _):
        address = f"127.0.0.1:{dispatcher.address[1]}"
        assert main(["trace", "arm", "--dispatcher", address]) == 0
        assert json.loads(capsys.readouterr().out)["armed"] is True
        source = ServiceBatchSource(dispatcher.address, heartbeat_interval_s=0.05)
        loader = TorchDataLoader(None, source, device="cpu")
        got = [b for b in loader]
        assert sum(len(_ids(b)) for b in got) == 120
        out = str(tmp_path / "fleet.json")
        assert main(["trace", "collect", "--dispatcher", address, "--out", out]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert main(["diagnose", "--trace", out, "--stall-pct", "40"]) == 0
        rendered = capsys.readouterr().out
        assert main(["diagnose", "--dispatcher", address, "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        status = _request(dispatcher.address, {"type": "status"})
        assert main(["trace", "disarm", "--dispatcher", address]) == 0
        capsys.readouterr()
    with open(out, encoding="utf-8") as f:
        doc = json.load(f)
    assert summary["events"] == len(doc["traceEvents"]) > 0
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"loader.wait", "dispatcher.get_assignment"} <= names
    assert {"worker.decode", "worker.send", "client.recv"} & names
    assert set(doc["otherData"]["clock_alignment"]) >= {"w0", "w1"}
    assert "consumer wait" in rendered and "STALL%" in rendered
    assert "stage_profile" in report
    assert status["observability"]["trace_armed"] is True
    assert status["observability"]["stage_profiles"][-1]["source"] == "diagnose"
    assert not tracing.COLLECTOR.enabled  # every armer released


# ---------------------------------------------------------------------------
# families, the loader's diagnostics["source"]
# ---------------------------------------------------------------------------

CONTROL_FAMILIES = [
    "FAILPOINT_FIRES", "FAILPOINT_ARMED", "QUARANTINE_REPORTS", "QUARANTINE_PIECES",
    "RESILIENCE_DEADLINE_EXCEEDED", "RESILIENCE_RETRY_BUDGET", "RESILIENCE_BREAKER_STATE",
    "RESILIENCE_HEDGES", "FLEET_BROWNOUT_LEVEL", "TRACE_SHIP_EVENTS", "CLOCK_OFFSET_US",
    "DISPATCHER_RECOVERY_EVENTS"]


@pytest.mark.parametrize("name", CONTROL_FAMILIES)
def test_control_plane_families_equal_the_jax_families(name):
    from petastorm_tpu.telemetry import metrics as jax_metrics
    from petastorm_tpu_torch.telemetry import metrics as port_metrics

    port, jax = getattr(port_metrics, name), getattr(jax_metrics, name)
    assert (port.name, port.help, port.kind, port.label_names, port.buckets) == \
        (jax.name, jax.help, jax.kind, jax.label_names, jax.buckets)


class _StubSource:
    """A batch source with delivery counters of its own."""

    diagnostics = {"per_worker": {"w0": {"batches": 2}}}

    def __call__(self):
        return iter([{"x": np.arange(4)}, {"x": np.arange(4)}])


def test_the_loader_snapshots_a_source_s_diagnostics_like_jax():
    from petastorm_tpu.jax_utils.loader import JaxDataLoader
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    port = TorchDataLoader(None, _StubSource(), device="cpu")
    jax = JaxDataLoader(None, 4, batch_source=_StubSource(), stage_to_device=False)
    for loader in (port, jax):
        assert len(list(loader)) == 2
    assert port.diagnostics["source"] == jax.diagnostics["source"] == \
        {"per_worker": {"w0": {"batches": 2}}}
    plain = TorchDataLoader(None, lambda: iter([{"x": np.arange(4)}]), device="cpu")
    list(plain)
    assert "source" not in plain.diagnostics


def test_the_loader_surfaces_the_service_source_s_diagnostics(store):
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    with fleet(store) as (dispatcher, _):
        source = ServiceBatchSource(dispatcher.address)
        loader = TorchDataLoader(None, source, device="cpu")
        with loader:
            for _ in loader:
                pass
        diag = source.diagnostics
    per_worker = diag["per_worker"]
    assert diag["credits_window"] == 8 and diag["ready_queue_depth"] == 0
    assert sorted(per_worker) == ["w0", "w1"]
    assert all(c["batches"] > 0 and c["credits_outstanding"] == 0
               for c in per_worker.values())
    assert sum(c["batches"] for c in per_worker.values()) == loader.diagnostics["batches"]
    assert loader.diagnostics["source"]["per_worker"] == per_worker
