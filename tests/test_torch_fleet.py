"""The fleet in the port against the JAX package: jobs with fair shares,
worker states and the autoscaler, the job API, the chaos harness and the
``status --watch`` job lines.

- ``plan_fair_shares`` and ``credit_scales`` equal the JAX functions on
  their goldens and on ``hypothesis`` demands, weights, quotas and
  brownout levels (exact); ``AutoscaleConfig``'s refusals are the JAX
  ones; ``AutoscalePlanner.plan`` decides as the JAX planner on its unit
  cases and on seeded signal sequences.
- Request scripts through both dispatchers' ``_handle`` (jobs registered,
  restarted, refused and ended; dynamic plans, steals, takeovers and
  heartbeats scoped to jobs; standby, admit, drain and retire): the
  replies equal (clocks masked), the journals byte-equal, the state equal
  after a restart, and each package recovers the other's journal.
- The trainer's job API over sockets: ``register_job`` / ``end_job`` /
  ``JobHandle`` and the open-registration guard; fcfs refusals.
- ``Dispatcher(autoscale=...)``: the ``fleet-autoscale`` thread admits a
  standby worker under backlog; the model planner journals ``fleet_plan``
  records and exports its gauges.
- Loopback fleets of both packages: two jobs over one fleet cache give
  the same per-job ordered streams, the second job decodes nothing, and
  the workers attribute rows and lookups per job.
- The chaos harness: ``StreamDigest`` (numpy and torch tensors; bf16
  refused), ``delivery_invariants``, the seeded event plan and the cache
  corruption equal the JAX harness's.

The port's job registrations are guarded by this file's own fixture (the
shared one watches the JAX package's). The fleet soak is ``slow``, as the
JAX soak is.
"""

import copy
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from petastorm_tpu import service as jax_service
from petastorm_tpu.cache_impl import BatchCache as JaxBatchCache
from petastorm_tpu.service import chaos as jax_chaos
from petastorm_tpu.service import fleet as jax_fleet
from petastorm_tpu.service.cli import render_fleet_status as jax_render
from petastorm_tpu_torch import failpoints as port_fp
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.cache_impl import BatchCache
from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
from petastorm_tpu_torch.service import chaos, fleet
from petastorm_tpu_torch.service.cli import render_fleet_status, run_status
from petastorm_tpu_torch.service.client import ServiceError

ROWS = 60  # 12 pieces of 5: piece p holds ids [5p, 5p + 5)
EVEN, ODD = list(range(0, 12, 2)), list(range(1, 12, 2))


@pytest.fixture(autouse=True)
def _port_guards():
    """Fail a test that leaves a port job registration open or a port
    schedule armed (the shared guards watch the JAX package's only)."""
    before = fleet.open_job_registrations()
    yield
    leaked = fleet.open_job_registrations() - before
    armed = port_fp.ACTIVE is not None
    if armed:
        port_fp.disarm()
    with fleet._OPEN_JOBS_LOCK:
        fleet._OPEN_JOBS.difference_update(leaked)
    assert not leaked, f"job registrations left open: {leaked}"
    assert not armed, "a port FaultSchedule outlived its test"


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path_factory.mktemp('fleet')}/scalar"
    create_test_scalar_dataset(url, rows_count=ROWS, rows_per_row_group=5)
    return url


# ---------------------------------------------------------------------------
# fair shares and the streak planner
# ---------------------------------------------------------------------------

#: The JAX goldens (tests/test_fleet.py): capacity, demands, weights, quotas.
SHARE_CASES = {
    "equal": (6.0, {"a": 10.0, "b": 10.0, "c": 10.0}, None, None),
    "weighted": (6.0, {"heavy": 100.0, "light": 100.0}, {"heavy": 2.0, "light": 1.0}, None),
    "demand-capped": (9.0, {"a": 1.0, "b": 100.0, "c": 100.0}, None, None),
    "quota": (8.0, {"capped": 100.0, "free": 100.0}, None, {"capped": 2.0}),
    "never-over": (4.0, {"a": 100.0, "b": 3.0}, {"a": 1.0, "b": 10.0}, None),
    "idle": (2.0, {"a": 0.0, "b": 0.0}, None, {"a": None}),
}


@pytest.mark.parametrize("case", sorted(SHARE_CASES))
def test_fair_shares_and_credit_scales_equal_jax_on_its_goldens(case):
    capacity, demands, weights, quotas = SHARE_CASES[case]
    want = jax_fleet.plan_fair_shares(capacity, demands, weights, quotas)
    assert fleet.plan_fair_shares(capacity, demands, weights, quotas) == want
    assert fleet.credit_scales(want) == jax_fleet.credit_scales(want)
    if case == "weighted":
        assert want == pytest.approx({"heavy": 4.0, "light": 2.0})
        assert fleet.credit_scales(want) == pytest.approx({"heavy": 1.0, "light": 0.5})


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(st.sampled_from("abcdefg"), st.floats(0.0, 50.0), max_size=6),
       st.floats(0.0, 16.0), st.data())
def test_fair_shares_and_credit_scales_equal_jax_on_any_input(demands, capacity, data):
    jobs = sorted(demands)
    weights = {j: data.draw(st.floats(0.1, 8.0)) for j in jobs if data.draw(st.booleans())}
    quotas = {j: data.draw(st.one_of(st.none(), st.floats(0.0, 10.0)))
              for j in jobs if data.draw(st.booleans())}
    shares = fleet.plan_fair_shares(capacity, demands, weights, quotas)
    assert shares == jax_fleet.plan_fair_shares(capacity, demands, weights, quotas)
    assert sum(shares.values()) <= capacity + 1e-9
    level = data.draw(st.integers(0, 3))
    assert fleet.credit_scales(shares, brownout_level=level) == \
        jax_fleet.credit_scales(shares, brownout_level=level)


@pytest.mark.parametrize("kwargs,match", [
    ({"min_serving": 0}, "min_serving"),
    ({"scale_up_backlog": 1.0, "scale_down_backlog": 2.0}, "scale_down_backlog"),
    ({"scale_up_backlog": 1.0, "scale_down_backlog": 1.0}, "scale_down_backlog"),
    ({"planner": "oracle"}, "planner must be"),
])
def test_autoscale_config_refusals_equal_jax(kwargs, match):
    errors = []
    for package in (fleet, jax_fleet):
        with pytest.raises(ValueError, match=match) as err:
            package.AutoscaleConfig(**kwargs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(TypeError, match="autoscale must be"):
        fleet.AutoscaleConfig.coerce(3)
    config = fleet.AutoscaleConfig.coerce({"interval_s": 0.5, "planner": "model"})
    assert vars(config) == vars(jax_fleet.AutoscaleConfig.coerce(
        {"interval_s": 0.5, "planner": "model"}))
    assert fleet.AutoscaleConfig.coerce(config) is config
    assert vars(fleet.AutoscaleConfig.coerce(True)) == vars(jax_fleet.AutoscaleConfig())


def _signals(serving=(), standby=(), draining=(), backlog=None, known=True, rates=None):
    return {"serving": list(serving), "standby": list(standby), "draining": list(draining),
            "backlog": dict(backlog or {}), "rates": dict(rates or {}),
            "backlog_known": known}


#: The JAX planner cases as ``(config, [signals...])``.
STREAK_CASES = {
    "scale-up": ({"scale_up_backlog": 4.0, "up_windows": 2, "cooldown_windows": 1},
                 [_signals(["w0"], ["s0", "s1"], backlog={"w0": 10})] * 3),
    "drain-on-idle": ({"scale_down_backlog": 0.5, "down_windows": 2, "min_serving": 1},
                      [_signals(["w0", "w1"])] * 3 + [_signals(["w0"])] * 2),
    "retire": ({}, [_signals(["w0"], draining=["d0", "d1"],
                             backlog={"w0": 2, "d0": 0, "d1": 3})]),
    "no-flap": ({"scale_up_backlog": 4.0, "scale_down_backlog": 0.5, "up_windows": 2,
                 "down_windows": 2},
                [_signals(["w0", "w1"], ["s0"], backlog={"w0": 10, "w1": 10}),
                 _signals(["w0", "w1"], ["s0"], backlog={"w0": 2, "w1": 2})] * 6),
    "cooldown": ({"scale_up_backlog": 1.0, "up_windows": 1, "cooldown_windows": 2},
                 [_signals(["w0"], ["s0", "s1"], backlog={"w0": 50})] * 5),
    "emergency": ({"scale_down_backlog": 0.5, "down_windows": 1, "cooldown_windows": 5},
                  [_signals(["w0", "w1"]), _signals([], ["s0"], known=False)]),
    "no-signal": ({"down_windows": 1, "up_windows": 1},
                  [_signals(["w0", "w1"], ["s0"], ["d0"], known=False)] * 3),
    "rates-tiebreak": ({"scale_down_backlog": 0.5, "down_windows": 1},
                       [_signals(["w0", "w1", "w2"], rates={"w0": 9.0, "w1": 3.0, "w2": 3.0})]),
}


@pytest.mark.parametrize("case", sorted(STREAK_CASES))
def test_streak_planner_equals_jax_on_its_cases(case):
    config, sequence = STREAK_CASES[case]
    planners = [package.AutoscalePlanner(package.AutoscaleConfig(**config))
                for package in (fleet, jax_fleet)]
    got = [[planner.plan(copy.deepcopy(s)) for s in sequence] for planner in planners]
    assert got[0] == got[1]
    flat = [(d["action"], d["worker_id"]) for step in got[0] for d in step]
    expected_first = {"scale-up": ("admit", "s0"), "drain-on-idle": ("drain", "w0"),
                      "retire": ("retire", "d0"), "cooldown": ("admit", "s0"),
                      "emergency": ("drain", "w0"), "no-signal": ("retire", "d0"),
                      "rates-tiebreak": ("drain", "w1")}
    if case == "no-flap":
        assert flat == []
    else:
        assert flat[0] == expected_first[case]


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_streak_planner_equals_jax_on_seeded_sequences(seed):
    import random

    rng = random.Random(seed)
    config = {"scale_up_backlog": rng.choice([1.0, 4.0]), "scale_down_backlog": 0.5,
              "up_windows": rng.randint(1, 3), "down_windows": rng.randint(1, 3),
              "cooldown_windows": rng.randint(0, 2), "min_serving": rng.randint(1, 2)}
    planners = [package.AutoscalePlanner(package.AutoscaleConfig(**config))
                for package in (fleet, jax_fleet)]
    workers = [f"w{i}" for i in range(5)]
    for _ in range(rng.randint(1, 20)):
        rng.shuffle(workers)
        n = rng.randint(0, 3)
        serving, rest = workers[:n], workers[n:]
        signals = _signals(serving, rest[1:rng.randint(1, 3)], rest[:1] if rng.random() < 0.3
                           else [], backlog={w: rng.randint(0, 8) for w in workers},
                           known=rng.random() < 0.85,
                           rates={w: rng.choice([0.0, 1.0, 5.0]) for w in serving})
        assert planners[0].plan(copy.deepcopy(signals)) == \
            planners[1].plan(copy.deepcopy(signals))


# ---------------------------------------------------------------------------
# the same requests through both dispatchers
# ---------------------------------------------------------------------------

def _reg(wid, port, standby=False):
    return {"type": "register_worker", "worker_id": wid, "host": "127.0.0.1", "port": port,
            "num_pieces": 12, "standby": standby}


def _job(job, weight=1.0, quota=None):
    return {"type": "register_job", "job_id": job, "weight": weight, "quota": quota}


def _plan(client, job, epoch=0):
    return {"type": "dynamic_plan", "client_id": client, "job_id": job, "client_index": 0,
            "num_clients": 1, "epoch": epoch}


def _sync(client, job, done=(), owned=None, stealable=None, rates=None):
    return {"type": "dynamic_sync", "client_id": client, "job_id": job, "epoch": 0,
            "done": list(done), "owned": owned or {}, "stealable": stealable or {},
            "rates": rates or {}, "failed_steals": []}


#: The JAX multi-job lifecycle (tests/test_fleet.py:480) with more: a
#: refused weight, job-scoped heartbeats and fencing, a takeover scoped to
#: a job, a stale token, autoscale moves (``("call", ...)``), a restart of
#: one job, an ended job and an unknown one, model-planner and hand-off
#: records.
DYNAMIC_SCRIPT = [
    _reg("w0", 1), _reg("w1", 2), _reg("pool0", 3, standby=True),
    _job("jobA", 2.0), _job("jobB", 1.0, 1.5), _job("jobC"), _job("bad", 0.0),
    {"type": "list_workers"},
    _plan("cA", "jobA"), _plan("cB", "jobB"),
    _sync("cA", "jobA", done=ODD, owned={"w0": EVEN}, stealable={"w0": EVEN}),
    {"type": "client_heartbeat", "client_id": "cB", "job_id": "jobB", "epoch": 0},
    {"type": "client_heartbeat", "client_id": "cA"},
    ("call", "admit_worker", "pool0"), ("call", "drain_worker", "w1"),
    ("call", "retire_worker", "w0"), ("call", "drain_worker", "missing"),
    _sync("cB", "jobB", owned={"w0": EVEN, "w1": ODD}, stealable={"w0": EVEN, "w1": ODD},
          rates={"w0": 10.0, "w1": 30.0}),
    {"type": "worker_heartbeat", "worker_id": "w1"},
    _job("jobA", 2.0),
    {"type": "report_failure", "client_id": "cB", "job_id": "jobB", "worker_id": "w0",
     "pieces": [0, 2], "fencing_epoch": 0},
    {"type": "report_failure", "client_id": "cA", "worker_id": "pool0", "pieces": [4],
     "fencing_epoch": 0},
    {"type": "end_job", "job_id": "jobC"}, {"type": "end_job", "job_id": "nope"},
    ("call", "record_fleet_plan", {"action": "admit", "worker_id": "pool0",
                                   "model": {"per_worker_rows_s": 50.0,
                                             "ceiling_rows_s": None},
                                   "predicted_rows_s": 100.0, "whatif_error": 0.0,
                                   "probe": True}),
    {"type": "cache_handoff", "worker_id": "w1", "entries": 3, "bytes": 300,
     "peers": {"pool0": 3}, "errors": 0, "torn": False},
    {"type": "status"},
]

_VOLATILE = {"dispatcher_time_us", "lease_expires_in_s", "path", "metrics_address"}


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
            _, method, arg = step
            replies.append(getattr(dispatcher, method)(copy.deepcopy(arg)))
        else:
            reply = dict(dispatcher._handle(copy.deepcopy(step)))
            reply.pop("metrics_address", None)  # the port keeps it at the top level too
            replies.append(_mask(reply))
    return replies


def _start(package, journal, mode="dynamic"):
    return package.Dispatcher(mode=mode, journal_dir=str(journal), lease_timeout_s=None,
                              breaker_cooldown_s=0.0).start()


def _files(path):
    return {name: (path / name).read_bytes() for name in ("wal.jsonl", "snapshot.json")}


def test_multi_job_lifecycle_same_replies_journal_and_state(tmp_path):
    out = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        dispatcher = _start(package, tmp_path / name)
        try:
            replies = _play(dispatcher, DYNAMIC_SCRIPT)
            before = dispatcher.state_snapshot()
            signals = dispatcher.fleet_signals()
        finally:
            dispatcher.stop()
        files = _files(tmp_path / name)
        restarted = _start(package, tmp_path / name)
        try:
            after = restarted.state_snapshot()
        finally:
            restarted.stop()
        out[name] = (replies, files, before, after, signals)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]  # byte-equal journals
    assert out["port"][2:] == out["jax"][2:]
    replies, _, before, after, signals = out["port"]
    # A stale-token rejection is not journaled (in either package).
    volatile = ("fencing_epoch", "recovery", "job_recovery")
    assert json.dumps({k: v for k, v in before.items() if k not in volatile}, sort_keys=True) \
        == json.dumps({k: v for k, v in after.items() if k not in volatile}, sort_keys=True)
    assert replies[6] == {"type": "error", "error": "job weight must be > 0, got 0.0"}
    assert sorted(replies[7]["workers"]) == ["w0", "w1"]  # the standby worker is not listed
    assert replies[10]["steals"]  # jobA's drained w1 pulls from w0
    assert replies[11]["credit_scale"] == 0.5 and replies[12]["credit_scale"] == 1.0
    assert replies[13:17] == [True, True, False, False]  # retire needs a draining worker
    # jobB's sync: the drained w1 sheds its unstarted pieces to serving peers.
    assert all(d["from"] == "w1" and d["to"] in ("w0", "pool0") for d in replies[17]["steals"])
    assert replies[18]["worker_state"] == "draining"
    assert replies[19]["restarted"] is True and replies[19]["fencing_epoch"] == 1
    assert replies[21]["type"] == "stale_fencing"  # jobA's restart fenced its old token
    assert replies[22]["removed"] is True and replies[23]["removed"] is False
    status = replies[-1]
    assert sorted(status["jobs"]) == ["jobA", "jobB"]
    assert status["jobs"]["jobB"]["recovery"]["failures_reported"] == 1
    assert status["jobs"]["jobA"]["recovery"] == {"failures_reported": 0,
                                                  "stale_fencing_rejections": 1,
                                                  "fencing_bumps": 1}
    assert status["fleet"]["autoscale"] == {"admit": 1, "drain": 1, "retire": 0}
    assert after["job_fence_floor"] == 1 and after["jobs"]["jobB"]["quota"] == 1.5
    assert signals["draining"] == ["w1"] and signals["backlog_known"] is True


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_fleet_journal(writer, tmp_path):
    packages = {"port": port_service, "jax": jax_service}
    dispatcher = _start(packages[writer], tmp_path / "j")
    try:
        _play(dispatcher, DYNAMIC_SCRIPT)
    finally:
        dispatcher.stop()
    snapshots = {}
    for name in (("port", "jax") if writer == "jax" else ("jax", "port")):
        recovered = _start(packages[name], tmp_path / "j")
        try:
            snapshots[name] = recovered.state_snapshot()
            status = _mask(recovered._handle({"type": "status"}))
        finally:
            recovered.stop()
        # Each recovery bumps the fencing epoch: the second reader sees one more.
        jobs = {jid: {k: v for k, v in job.items() if k != "fencing_epoch"}
                for jid, job in status["jobs"].items()}
        snapshots[name + "-status"] = (jobs, status["fleet"], status["workers"])
    assert {k: v for k, v in snapshots["port"].items() if k not in ("recovery", "fencing_epoch")} \
        == {k: v for k, v in snapshots["jax"].items() if k not in ("recovery", "fencing_epoch")}
    assert snapshots["port-status"] == snapshots["jax-status"]
    assert snapshots["port"]["fleet_plans"] and snapshots["port"]["cache_handoffs"]


#: Static-mode jobs (the JAX fencing-isolation, credit-window, idle-job,
#: recreate and standby cases), through both dispatchers.
STATIC_SCRIPT = [
    _reg("w0", 1), _reg("pool0", 2, standby=True),
    {"type": "get_assignment", "client_id": "c0", "client_index": 0, "num_clients": 1,
     "epoch": 0},
    _job("heavy", 3.0), _job("light", 1.0), _job("big-idle", 5.0),
    {"type": "get_assignment", "client_id": "cH", "job_id": "heavy", "client_index": 0,
     "num_clients": 1, "epoch": 0},
    {"type": "get_assignment", "client_id": "cL", "job_id": "light", "client_index": 0,
     "num_clients": 1, "epoch": 0},
    {"type": "status"},
    _job("heavy", 3.0),
    {"type": "report_failure", "client_id": "cL", "job_id": "light", "worker_id": "w0",
     "pieces": []},
    {"type": "status"},
    {"type": "end_job", "job_id": "light"}, _job("light"),
    {"type": "report_failure", "client_id": "ghost", "job_id": "light", "worker_id": "w0",
     "pieces": [], "fencing_epoch": 1},
    ("call", "admit_worker", "pool0"),
    {"type": "get_assignment", "client_id": "cH", "job_id": "heavy", "client_index": 0,
     "num_clients": 1, "epoch": 1},
    {"type": "status"},
]


def test_static_jobs_same_replies_journal_and_state(tmp_path):
    out = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        dispatcher = _start(package, tmp_path / name, mode="static")
        try:
            out[name] = (_play(dispatcher, STATIC_SCRIPT), dispatcher.state_snapshot())
        finally:
            dispatcher.stop()
        out[name] += (_files(tmp_path / name),)
    assert out["port"] == out["jax"]
    replies = out["port"][0]
    assert replies[2]["credit_scale"] == 1.0  # the lone default job
    # heavy 3 : light 1 over one worker; big-idle has no clients, no demand.
    assert replies[6]["credit_scale"] == 1.0 and replies[7]["credit_scale"] == 0.3333
    jobs = replies[8]["jobs"]
    # With the default job's client: weights 3 : 1 : 1 over one worker.
    assert jobs["big-idle"]["fair_share"] == 0.0 and jobs["heavy"]["fair_share"] == 0.6
    later = replies[11]["jobs"]
    # heavy's restart moved heavy's epoch only; the failure moved both.
    assert later["heavy"]["fencing_epoch"] == jobs["heavy"]["fencing_epoch"] + 2
    assert later["light"]["fencing_epoch"] == jobs["light"]["fencing_epoch"] + 1
    assert later["light"]["recovery"]["failures_reported"] == 1
    assert replies[13]["fencing_epoch"] > later["light"]["fencing_epoch"] - 1
    assert replies[14]["type"] == "stale_fencing"  # a token of the ended namesake
    assert sorted(replies[16]["assignments"]) == ["pool0"]  # w0 was reported dead


def test_register_job_is_refused_under_fcfs_with_the_jax_message():
    errors = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        with package.Dispatcher(mode="fcfs", lease_timeout_s=None) as dispatcher:
            errors[name] = dispatcher._handle(_job("jobA"))
    assert errors["port"] == errors["jax"]
    assert "fcfs" in errors["port"]["error"] and "per-job" in errors["port"]["error"]


def test_the_job_api_over_sockets(store):
    with port_service.Dispatcher(mode="fcfs").start() as fcfs:
        with pytest.raises(ServiceError, match="fcfs"):
            fleet.register_job(fcfs.address, "jobA")
        assert not fleet.open_job_registrations()
        worker = port_service.BatchWorker(store, dispatcher_address=fcfs.address, batch_size=5,
                                          reader_factory="batch", worker_id="api-fcfs",
                                          reader_kwargs={"workers_count": 1}).start()
        try:
            with pytest.raises(ValueError, match="job_id requires static or dynamic"):
                port_service.ServiceBatchSource(fcfs.address, job_id="jobX")()
        finally:
            worker.stop()
    with port_service.Dispatcher(mode="dynamic").start() as dispatcher:
        address = dispatcher.address
        reply = fleet.register_job(address, "exp", weight=2.0, quota=1.0)
        assert reply["restarted"] is False and (address, "exp") in \
            fleet.open_job_registrations()
        assert fleet.end_job(address, "exp")["removed"] is True
        assert fleet.end_job(address, "exp")["removed"] is False
        with port_service.JobHandle(address, "ctx", weight=0.5) as handle:
            assert (address, "ctx") in fleet.open_job_registrations()
            assert dispatcher.state_snapshot()["jobs"]["ctx"]["weight"] == 0.5
        assert handle.job_id == "ctx" and "ctx" not in dispatcher.state_snapshot()["jobs"]
    # A dispatcher already gone: the end is logged and answered with None.
    assert fleet.end_job(address, "late", rpc_deadline_s=0.5) is None
    assert not fleet.open_job_registrations()


# ---------------------------------------------------------------------------
# the autoscaler's thread
# ---------------------------------------------------------------------------

def _rpc(address, header):
    with FramedConnection.connect(tuple(address), timeout=5.0) as conn:
        return conn.request(header)[0]


@pytest.mark.parametrize("planner", ["streak", "model"])
def test_the_autoscaler_thread_admits_a_standby_worker(planner):
    from petastorm_tpu_torch.telemetry.metrics import FLEET_MODEL_PREDICTED_ROWS

    config = {"interval_s": 0.05, "scale_up_backlog": 2.0, "up_windows": 2,
              "cooldown_windows": 1, "planner": planner}
    with port_service.Dispatcher(mode="dynamic", autoscale=config).start() as dispatcher:
        assert any(t.name == "fleet-autoscale-controller" for t in threading.enumerate())
        _rpc(dispatcher.address, _reg("w0", 9))
        _rpc(dispatcher.address, _reg("pool0", 10, standby=True))
        _rpc(dispatcher.address, _plan("c0", None))
        if planner == "model":  # the model needs a measured rate
            _rpc(dispatcher.address, _sync("c0", None, rates={"w0": 80.0}))
        deadline = time.monotonic() + 10.0
        while dispatcher.fleet_signals()["serving"] != ["pool0", "w0"] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        status = _rpc(dispatcher.address, {"type": "status"})
        assert dispatcher.fleet_signals()["serving"] == ["pool0", "w0"]
        assert status["fleet"]["autoscale"]["admit"] >= 1 and status["fleet"]["autoscaler_armed"]
        if planner == "model":
            plan = status["fleet"]["fleet_plans"][0]
            assert plan["action"] == "admit" and plan["worker_id"] == "pool0"
            assert plan["model"] == {"per_worker_rows_s": 80.0, "ceiling_rows_s": None}
            assert FLEET_MODEL_PREDICTED_ROWS.labels().value > 0
    assert not any(t.name.startswith("fleet-autoscale") for t in threading.enumerate())


# ---------------------------------------------------------------------------
# loopback fleets of both packages
# ---------------------------------------------------------------------------

def _two_job_fleet(package, url, tag):
    """Two jobs over one static fleet of two fleet-cache workers, the second
    after the first: each job's ordered stream digest, the workers' per-job
    lookups and rows, and their cache stats. Static, so no steal revokes a
    piece in decode (which decodes it again)."""
    port = package is port_service
    digest_cls = chaos.StreamDigest if port else jax_chaos.StreamDigest
    handle = port_service.JobHandle if port else jax_fleet.JobHandle
    cache_cls = BatchCache if port else JaxBatchCache
    dispatcher = package.Dispatcher(mode="static", shuffle_seed=4).start()
    workers = []
    try:
        for i in range(2):
            workers.append(package.BatchWorker(
                url, dispatcher_address=dispatcher.address, batch_size=5,
                reader_factory="batch", worker_id=f"{tag}-{i}", heartbeat_interval_s=0.05,
                batch_cache=cache_cls(mem_budget_bytes=16 << 20), fleet_cache=True,
                reader_kwargs={"workers_count": 2}).start())
        deadline = time.monotonic() + 10
        while any(w.cache_stats()["peers"] < 2 for w in workers) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        digests = {}
        with handle(dispatcher.address, "jobA", weight=2.0), \
                handle(dispatcher.address, "jobB"):
            for job in ("jobA", "jobB"):
                source = package.ServiceBatchSource(dispatcher.address, job_id=job,
                                                    client_id=f"client-{job}", ordered=True)
                digest, ids = digest_cls(), []
                for batch in source():
                    digest.update(batch)
                    ids.extend(int(i) for i in batch["id"])
                assert sorted(ids) == list(range(ROWS)), job
                digests[job] = digest.hexdigest()
        by_job = [w.cache_stats_by_job() for w in workers]
        rows = [w.rows_by_job() for w in workers]
        stats = [w.cache_stats() for w in workers]
        diagnostics = [w.diagnostics_snapshot() for w in workers]
        return digests, by_job, rows, stats, diagnostics
    finally:
        for worker in workers:
            worker.stop()
        dispatcher.stop()


def test_two_jobs_share_one_fleet_cache_and_equal_the_jax_streams(store):
    from petastorm_tpu_torch.telemetry.metrics import FLEET_JOB_ROWS

    rows_before = FLEET_JOB_ROWS.labels("jobB").value
    port = _two_job_fleet(port_service, store, "tj-port")
    jax = _two_job_fleet(jax_service, store, "tj-jax")
    assert port[0] == jax[0] and port[0]["jobA"] == port[0]["jobB"]
    digests, by_job, rows, stats, diagnostics = port
    assert sum(s["misses"] for s in stats) == 12  # jobA's one cold fill
    assert sum(b.get("jobB", {}).get("misses", 0) for b in by_job) == 0  # decoded nothing
    assert sum(b.get("jobB", {}).get("hits", 0) for b in by_job) == 12
    assert sum(r["jobA"]["rows"] for r in rows) == sum(r["jobB"]["rows"] for r in rows) == ROWS
    assert FLEET_JOB_ROWS.labels("jobB").value - rows_before == ROWS
    assert all(d["metrics"]["cache_tier"] == "fleet" for d in diagnostics)
    assert sum(d["jobs"]["jobB"]["rows"] for d in diagnostics) == ROWS
    assert all("cache_by_job" in d and "cache_remote_hits_total" in d["metrics"]
               for d in diagnostics)


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.RandomState(3)
    return [{"id": np.arange(4, dtype=np.int64) + 4 * i,
             "x": rng.rand(4, 3).astype(np.float32),
             "s": np.array([b"ab", b"c", "t", None], dtype=object)} for i in range(3)]


def test_stream_digest_equals_jax_on_numpy_and_torch_batches():
    port, jax = chaos.StreamDigest(), jax_chaos.StreamDigest()
    for batch in _batches():
        port.update(batch)
        jax.update(batch)
    assert port.hexdigest() == jax.hexdigest() and port.batches == jax.batches == 3
    tensors, arrays = chaos.StreamDigest(), jax_chaos.StreamDigest()
    for batch in _batches():
        tensors.update({"id": torch.from_numpy(batch["id"]), "x": torch.from_numpy(batch["x"])})
        arrays.update({"id": batch["id"], "x": batch["x"]})
    assert tensors.hexdigest() == arrays.hexdigest()
    with pytest.raises(TypeError, match="bfloat16"):
        chaos.StreamDigest().update({"x": torch.zeros(2, dtype=torch.bfloat16)})
    shifted = chaos.StreamDigest().update({"s": np.array([b"a", b"bc"], dtype=object)})
    assert shifted.hexdigest() != chaos.StreamDigest().update(
        {"s": np.array([b"ab", b"c"], dtype=object)}).hexdigest()


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 9), max_size=20), st.lists(st.integers(0, 9), max_size=20),
       st.booleans())
def test_delivery_invariants_equal_jax(expected, got, allow):
    result = chaos.delivery_invariants(expected, got, allow)
    assert result == jax_chaos.delivery_invariants(expected, got, allow)
    assert set(result) == {"lost_rows", "duplicate_rows", "ok"}


@pytest.mark.parametrize("seed", [None, 0, 7, 18, 19, 2**40 + 3])
def test_the_event_plan_equals_jax(seed):
    actions = [("a", None), ("b", None), ("c", None)]
    plans = [[package.ChaosInjector(actions, interval_s=0.5, seed=seed)._event_plan(i)
              for i in range(12)] for package in (chaos, jax_chaos)]
    assert plans[0] == plans[1]
    assert chaos.CHAOS_KINDS == jax_chaos.CHAOS_KINDS


def test_the_injector_records_events_and_survives_a_failing_action():
    calls = []

    def boom():
        raise RuntimeError("injected")
    with chaos.ChaosInjector([("ok", lambda: calls.append(1)), ("boom", boom)],
                             interval_s=0.01, initial_delay_s=0.0, max_events=4).start() as inj:
        deadline = time.monotonic() + 5
        while len(inj.events) + len(inj.errors) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert [label for _, label in inj.events] == ["ok", "ok"] and len(calls) == 2
    assert [label for label, _ in inj.errors] == ["boom", "boom"]
    with pytest.raises(ValueError, match="at least one"):
        chaos.ChaosInjector([])


def test_cache_corruption_equals_jax(tmp_path):
    from petastorm_tpu_torch.cache_impl.batch_cache import ENTRY_SUFFIX

    dirs = {}
    for name in ("port", "jax"):
        path = tmp_path / name
        path.mkdir()
        for i in range(3):
            (path / f"{i:02d}{ENTRY_SUFFIX}").write_bytes(bytes(range(40 + i)))
        dirs[name] = path
    actions = {"port": chaos.cache_corrupt_action(str(dirs["port"])),
               "jax": jax_chaos.cache_corrupt_action(str(dirs["jax"]))}
    for _ in range(4):
        for action in actions.values():
            action()
    assert {f.name: f.read_bytes() for f in dirs["port"].iterdir()} == \
        {f.name: f.read_bytes() for f in dirs["jax"].iterdir()}


def test_pieces_stolen_to_a_worker_being_taken_over_are_taken_over_too(store):
    """The dynamic client's fault that the JAX client keeps (ROADMAP Queue
    C): a worker is killed with pieces left; while the client retries it,
    the straggler rule steals the slow peer's pieces to it (its last rate
    was the fast one). Those grants wait for the recovery, and the takeover
    reply covers only the pieces the retry started with: the port takes the
    stolen ones over with a second report, where the JAX client kept them
    on the dead worker and the epoch never ended."""
    with port_service.Dispatcher(mode="dynamic") as dispatcher:
        dispatcher.start()
        workers = [port_service.BatchWorker(store, dispatcher_address=dispatcher.address,
                                            batch_size=5, reader_factory="batch",
                                            worker_id=f"strand-{i}", batch_delay_s=delay,
                                            reader_kwargs={"workers_count": 1}).start()
                   for i, delay in enumerate((0.2, 0.05))]
        source = port_service.ServiceBatchSource(dispatcher.address,
                                                 dynamic_sync_interval_s=0.05)
        ids, done, killed = [], threading.Event(), []

        def consume():
            for batch in source():
                ids.extend(int(i) for i in batch["id"])
                # Three of the fast worker's pieces in: kill it, three left.
                if not killed and sum(1 for i in ids if (i // 5) % 2) == 15:
                    killed.append(workers[1].kill())
            done.set()
        thread = threading.Thread(target=consume, daemon=True)
        try:
            thread.start()
            assert done.wait(30), f"the epoch never ended: {len(ids)} rows delivered"
        finally:
            for worker in workers:
                worker.stop()
        thread.join(timeout=10)
    assert sorted(ids) == list(range(ROWS))
    recovery = source.diagnostics["recovery"]
    assert recovery["takeovers"] == 2 and recovery["steals_applied"] >= 1


def test_a_dispatcher_restart_action_keeps_the_address(tmp_path):
    holder = [port_service.Dispatcher(journal_dir=str(tmp_path / "j")).start()]
    address = holder[0].address

    def factory(host, port):
        return port_service.Dispatcher(host=host, port=port, journal_dir=str(tmp_path / "j"))
    try:
        chaos.dispatcher_restart_action(holder, factory, downtime_s=0.0)()
        assert holder[0].address == address
        assert holder[0].state_snapshot()["recovery"]["journal_replays"] == 1
    finally:
        holder[0].stop()


# ---------------------------------------------------------------------------
# status --watch
# ---------------------------------------------------------------------------

def test_the_watch_job_lines_equal_jax_and_run_status_polls(store):
    with port_service.Dispatcher(mode="dynamic").start() as dispatcher:
        for step in DYNAMIC_SCRIPT[:12]:
            dispatcher._handle(copy.deepcopy(step))
        status = dispatcher._handle({"type": "status"})
        workers = {"w0": {"metrics": {"rows_sent_total": 100.0}, "jobs": {"jobA": {"rows": 40},
                                                                           "jobB": {"rows": 10}}},
                   "w1": {"metrics": {"rows_sent_total": 50.0}, "jobs": {"jobA": {"rows": 5}}},
                   "pool0": {"error": "unreachable"}}
        later = copy.deepcopy(workers)
        later["w0"]["jobs"]["jobA"]["rows"] = 140
        prev, cur = ({"t": 0.0, "status": status, "workers": workers},
                     {"t": 2.0, "status": status, "workers": later})
        text = render_fleet_status(prev, cur)
        assert text == jax_render(prev, cur)
        assert "job jobA: rows/s=50.0 share=" in text and "states: serving=2 standby=1" in text
        for step in DYNAMIC_SCRIPT[12:]:
            if isinstance(step, dict):
                dispatcher._handle(copy.deepcopy(step))
        out = io.StringIO()
        assert run_status(dispatcher.address, interval_s=0.05, out=out, max_refreshes=1) == 0
        assert "job jobA:" in out.getvalue() and "cache-handoff: w1 shipped 3" in out.getvalue()


# ---------------------------------------------------------------------------
# the soak
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fleet_soak_three_jobs_autoscaler_chaos(tmp_path):
    """The JAX soak on the port: 8 workers (2 standby), 3 equal-weight
    jobs, the autoscaler and chaos (job cancels, worker drains) on: every
    job's rows exactly once over 2 epochs, the three ordered streams
    byte-identical, at least one admit and one drain journaled and the
    fleet history replayed byte-identically."""
    from petastorm_tpu_torch.cache_impl import CacheConfig
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path}/soak"
    rows = 240
    create_test_scalar_dataset(url, rows_count=rows, rows_per_row_group=10)
    journal_dir = str(tmp_path / "journal")
    jobs = ("job0", "job1", "job2")
    dispatcher = port_service.Dispatcher(
        mode="dynamic", num_epochs=2, journal_dir=journal_dir, shuffle_seed=7,
        autoscale={"interval_s": 0.2, "scale_up_backlog": 3.0, "up_windows": 2,
                   "down_windows": 10, "min_serving": 4}).start()
    workers, results, errors = [], {}, []
    try:
        for i in range(8):
            workers.append(port_service.BatchWorker(
                url, dispatcher_address=dispatcher.address, batch_size=10,
                reader_factory="batch", worker_id=f"soak-w{i}", standby=i >= 6,
                batch_delay_s=0.03, heartbeat_interval_s=0.5,
                batch_cache=CacheConfig(mode="mem+disk", mem_mb=32.0,
                                        cache_dir=str(tmp_path / "cache")).build(),
                reader_kwargs={"workers_count": 2}).start())
        for job in jobs:
            fleet.register_job(dispatcher.address, job)

        def run_job(job):
            try:
                source = port_service.ServiceBatchSource(
                    dispatcher.address, job_id=job, client_id=f"client-{job}", ordered=True,
                    heartbeat_interval_s=0.3, dynamic_sync_interval_s=0.1)
                digest, ids = chaos.StreamDigest(), []
                for batch in source():
                    digest.update(batch)
                    ids.extend(int(i) for i in batch["id"])
                results[job] = (sorted(ids), digest.hexdigest())
            except BaseException as exc:
                errors.append((job, exc))

        warm = port_service.ServiceBatchSource(dispatcher.address, client_id="client-warmup",
                                               dynamic_sync_interval_s=0.1)
        assert sum(len(b["id"]) for b in warm()) == 2 * rows
        injector = chaos.ChaosInjector(
            [("worker-drain", chaos.worker_drain_action(lambda: dispatcher, min_serving=3)),
             ("job-cancel", chaos.job_cancel_action(lambda: dispatcher.address))],
            interval_s=0.35, initial_delay_s=0.2).start()
        threads = [threading.Thread(target=run_job, args=(job,)) for job in jobs]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=180)
        deadline = time.monotonic() + 8.0
        while {label for _, label in injector.events} < {"job-cancel", "worker-drain"} \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        injector.stop()
        assert not errors and not injector.errors, (errors, injector.errors)
        for job in jobs:
            assert results[job][0] == sorted(list(range(rows)) * 2), job
        assert len({results[job][1] for job in jobs}) == 1
        snapshot = dispatcher.state_snapshot()
        assert snapshot["autoscale"]["drain"] >= 1 and snapshot["autoscale"]["admit"] >= 1
        for job in jobs:
            fleet.end_job(dispatcher.address, job)
        before = dispatcher.state_snapshot()
    finally:
        for worker in workers:
            worker.stop()
        dispatcher.stop()
    with port_service.Dispatcher(mode="dynamic", num_epochs=2, journal_dir=journal_dir,
                                 shuffle_seed=7).start() as restarted:
        after = restarted.state_snapshot()
    volatile = ("fencing_epoch", "recovery")
    assert json.dumps({k: v for k, v in before.items() if k not in volatile}, sort_keys=True) \
        == json.dumps({k: v for k, v in after.items() if k not in volatile}, sort_keys=True)
    assert os.path.isdir(journal_dir)
