"""The fleet cache tier and the model planner in the port against the JAX
package.

- The consistent-hash ring: the JAX golden placement vector, and
  ``owner`` / ``owners`` / ``placement`` equal to the JAX ring's over 1,000
  seeded keys for 1 to 8 peers (exact).
- The throughput model: ``fit_throughput_model``, ``whatif_replay`` and
  ``to_dict`` equal on the JAX goldens and on ``hypothesis`` samples
  (floats within 1e-12 relative); ``ModelPlanner`` decisions equal on the
  JAX cases and on seeded signal sequences.
- ``BatchCache``'s fleet methods (``peek``, ``put_entry``, ``hot_entries``,
  ``note_miss``) and its ``cache.write`` / ``cache.read`` failpoints;
  ``entry_wire_meta`` / ``entry_wire_payload`` give the JAX bytes.
- ``FleetCacheTier`` over an in-process wire that mirrors the worker's
  ``cache_fetch`` / ``cache_put`` handlers (with the JSON round trip), a
  port tier and a JAX tier as the two peers: remote warm serves byte for
  byte and promoted, frame-seekable adoptions, write-through placement,
  the drain hand-off, breaker-open degradation to a local fill, the
  ``cache-peer-gone`` and ``handoff-torn`` failpoints, torn payloads
  refused, merged stats.
- The dispatcher: the cache-peer list (seeded at registration, draining
  peers left out) and the ``cache_handoff`` / ``fleet_plan`` records,
  replayed byte-identically and across the packages.
- ``status --watch``'s CACHE column, hit-rate baseline and fleet-plan /
  hand-off lines equal the JAX CLI's.
- A loopback fleet of three fleet-cache workers with a mid-stream drain:
  the ordered stream equals a cold fleet's, the hand-off re-homes the
  drained worker's memory tier and the fleet decodes each piece once.
"""

import copy
import json
import math
import random
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from petastorm_tpu import service as jax_service
from petastorm_tpu.cache_impl import BatchCache as JaxBatchCache
from petastorm_tpu.cache_impl import fleet_tier as jax_tier
from petastorm_tpu.cache_impl import hash_ring as jax_ring
from petastorm_tpu.service import fleet_model as jax_model
from petastorm_tpu.service.cli import render_fleet_status as jax_render
from petastorm_tpu_torch import failpoints as port_fp
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.cache_impl import BatchCache, live_cache_dirs
from petastorm_tpu_torch.cache_impl import fleet_tier
from petastorm_tpu_torch.cache_impl.hash_ring import DEFAULT_VNODES, HashRing, placement
from petastorm_tpu_torch.service import fleet, fleet_model
from petastorm_tpu_torch.service.cli import render_fleet_status

#: The JAX placement contract (tests/test_fleet_cache.py).
GOLDEN_PLACEMENT = {
    "k00": "w1", "k01": "w0", "k02": "w0", "k03": "w1",
    "k04": "w3", "k05": "w3", "k06": "w1", "k07": "w3",
    "k08": "w2", "k09": "w3", "k10": "w0", "k11": "w1",
    "fp:deadbeef": "w1", "fp:cafef00d": "w0",
    "piece:7:mem": "w2", "piece:8:mem": "w1",
}


@pytest.fixture(autouse=True)
def _port_guards():
    """Fail a test that leaves a port job registration open, a port
    schedule armed or a port cache directory behind (the shared guards
    watch the JAX package's only)."""
    jobs, dirs = fleet.open_job_registrations(), live_cache_dirs()
    yield
    leaked_jobs = fleet.open_job_registrations() - jobs
    leaked_dirs = live_cache_dirs() - dirs
    armed = port_fp.ACTIVE is not None
    if armed:
        port_fp.disarm()
    assert not leaked_jobs, f"job registrations left open: {leaked_jobs}"
    assert not leaked_dirs, f"cache directories left behind: {leaked_dirs}"
    assert not armed, "a port FaultSchedule outlived its test"


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_hash_ring_golden_placement_and_the_default_vnodes():
    assert DEFAULT_VNODES == jax_ring.DEFAULT_VNODES == 64
    assert placement(list(GOLDEN_PLACEMENT), ["w0", "w1", "w2", "w3"]) == GOLDEN_PLACEMENT


@pytest.mark.parametrize("peers", range(1, 9))
def test_hash_ring_equals_jax_over_seeded_keys(peers):
    rng = random.Random(peers)
    keys = [f"{rng.getrandbits(128):032x}" for _ in range(1000)]
    ids = [f"worker-{rng.getrandbits(16)}" for _ in range(peers)]
    ring, twin = HashRing(reversed(ids)), jax_ring.HashRing(ids)
    assert ring.peers == twin.peers and len(ring) == len(twin) == len(set(ids))
    for n in (1, 2, 3):
        assert [ring.owners(k, n=n) for k in keys] == [twin.owners(k, n=n) for k in keys]
    assert [ring.owner(k) for k in keys] == [twin.owner(k) for k in keys]
    assert [ring.owner(k.encode()) for k in keys[:50]] == \
        [twin.owner(k.encode()) for k in keys[:50]]
    assert placement(keys, ids, vnodes=7) == jax_ring.placement(keys, ids, vnodes=7)
    # Leaving moves only the leaver's keys, onto the ring without it.
    before, after = placement(keys, ids), placement(keys, ids[1:])
    assert all(before[k] == ids[0] for k in keys if before[k] != after[k])


def test_hash_ring_membership_empty_ring_and_refusals():
    ring = HashRing(["a", "b"])
    ring.replace({"b": None, "c": None})
    assert ring.peers == ("b", "c") and "a" not in ring and "c" in ring
    assert HashRing().owner("k") is None and HashRing().owners("k") == []
    for cls in (HashRing, jax_ring.HashRing):
        with pytest.raises(ValueError, match="vnodes must be >= 1"):
            cls(["a"], vnodes=0)


# ---------------------------------------------------------------------------
# the throughput model and its planner
# ---------------------------------------------------------------------------

def _close(got, want):
    """Equal, floats within 1e-12 relative (``None`` and ints exactly)."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_close(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(_close(g, w) for g, w in zip(got, want))
    if isinstance(want, float):
        return isinstance(got, float) and math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0)
    return got == want


MODEL_CASES = {
    "linear": ([(1, 100.0), (2, 200.0), (1, 100.0)], ()),
    "ceiling": ([(2, 200.0), (4, 210.0)], ()),
    "prior": ([], [{"profile": {"decode": {"mean_us": 2000.0},
                                "serialize": {"mean_us": 500.0}}}]),
    "nothing": ([], []),
    "zero": ([(0, 0.0)], []),
    "inconsistent": ([(1, 100.0), (2, 100.0), (3, 100.0)], ()),
}


def _model_view(package, samples, profiles):
    model = package.fit_throughput_model(samples, profiles)
    if model is None:
        return None
    return {"dict": model.to_dict(), "predict": [model.predict(n) for n in range(6)],
            "marginal": [model.marginal(n) for n in range(5)],
            "whatif": list(package.whatif_replay(model, samples))}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_throughput_model_equals_jax_on_its_goldens(case):
    samples, profiles = MODEL_CASES[case]
    want = _model_view(jax_model, samples, profiles)
    assert _close(_model_view(fleet_model, samples, profiles), want)
    if case == "ceiling":
        assert want["dict"] == {"per_worker_rows_s": 100.0, "ceiling_rows_s": 210.0}
    if case == "prior":
        assert want["dict"]["per_worker_rows_s"] == pytest.approx(500.0)
    assert fleet_model.whatif_replay(fleet_model.ThroughputModel(100.0), []) == (None, False)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(-1, 6),
                          st.one_of(st.none(), st.floats(-10.0, 5000.0, allow_nan=False))),
                max_size=12))
def test_throughput_model_equals_jax_on_any_samples(samples):
    assert _close(_model_view(fleet_model, samples, ()), _model_view(jax_model, samples, ()))


def _signals(serving=(), standby=(), draining=(), rates=None, backlog=None, profiles=()):
    return {"serving": list(serving), "standby": list(standby), "draining": list(draining),
            "rates": dict(rates or {}), "backlog": dict(backlog or {}),
            "stage_profiles": list(profiles)}


#: The JAX ModelPlanner cases as ``(probe_windows, observed, [signals...])``.
PLANNER_CASES = {
    "admit": (3, [], [_signals(["w0", "w1"], ["w9", "w2"], rates={"w0": 100.0, "w1": 100.0})]),
    "drain": (3, [], [_signals(["a", "b"], rates={"a": 100.0, "b": 100.0}),
                      _signals(["a", "b", "c", "d"],
                               rates={"a": 50.0, "b": 50.0, "c": 50.0, "d": 60.0})]),
    "whatif-gate": (3, [(2, 200.0), (2, 50.0), (2, 500.0)],
                    [_signals(["a", "b"], ["c"], rates={"a": 125.0, "b": 125.0})]),
    "probe-revert": (1, [], [_signals(["a", "b"], ["c"], rates={"a": 100.0, "b": 100.0}),
                             _signals(["a", "b", "c"],
                                      rates={"a": 70.0, "b": 70.0, "c": 70.0})]),
    "probe-kept": (1, [], [_signals(["a", "b"], ["c"], rates={"a": 100.0, "b": 100.0}),
                           _signals(["a", "b", "c"],
                                    rates={"a": 98.0, "b": 99.0, "c": 100.0})]),
    "probe-dropped": (1, [], [_signals(["a", "b"], ["c"], rates={"a": 100.0, "b": 100.0}),
                              _signals(["a", "b"], rates={"a": 10.0, "b": 10.0})]),
    "retire": (3, [], [_signals(["a"], draining=["d"], rates={"a": 100.0},
                                backlog={"d": 0})]),
    "prior": (3, [], [_signals(["a"], ["b"], profiles=[{"profile": {"x": {"mean_us": 10.0}}}])]),
}


def _run_planner(package, probe_windows, observed, sequence, config=None):
    planner = package.ModelPlanner(config, probe_windows=probe_windows)
    for n, rows in observed:
        planner.observe(n, rows)
    out = [planner.plan(copy.deepcopy(signals)) for signals in sequence]
    return out, planner.samples, planner.last_whatif_error


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_model_planner_equals_jax_on_its_cases(case):
    want = _run_planner(jax_model, *PLANNER_CASES[case])
    got = _run_planner(fleet_model, *PLANNER_CASES[case])
    assert _close(got, want)
    decisions = want[0]
    if case == "admit":
        assert decisions[0][0]["worker_id"] == "w2" and decisions[0][0]["probe"] is True
    if case == "probe-revert":
        assert decisions[1][0]["action"] == "drain" and "probe revert" in \
            decisions[1][0]["reason"]
    if case == "whatif-gate":
        assert decisions == [[]]
    assert fleet_model.ModelPlanner().config.interval_s == 1.0


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_model_planner_equals_jax_on_seeded_sequences(seed):
    rng = random.Random(seed)
    workers = [f"w{i}" for i in range(6)]
    sequence = []
    for _ in range(rng.randint(1, 14)):
        rng.shuffle(workers)
        n = rng.randint(0, 4)
        serving, rest = workers[:n], workers[n:]
        draining = rest[:rng.randint(0, 1)]
        standby = rest[len(draining):][:rng.randint(0, 2)]
        sequence.append(_signals(
            serving, standby, draining,
            rates={w: rng.choice([0.0, 50.0, 100.0, 101.5, 400.0]) for w in serving},
            backlog={w: rng.randint(0, 3) for w in draining}))
    config = {"cooldown_windows": rng.randint(0, 2), "min_serving": rng.randint(1, 2)}
    probe = rng.randint(1, 3)
    assert _close(_run_planner(fleet_model, probe, [], sequence, config),
                  _run_planner(jax_model, probe, [], sequence, config))


# ---------------------------------------------------------------------------
# the cache's fleet methods, its failpoints and the wire format
# ---------------------------------------------------------------------------

def _batch(seed, kb=4):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(kb * 128).astype(np.float64), "i": np.arange(6, dtype=np.int64),
            "s": np.array([b"a", b"bc"], dtype=object)}


def test_entry_wire_format_and_fleet_methods_equal_jax():
    caches = {"port": BatchCache(mem_budget_bytes=8 << 20),
              "jax": JaxBatchCache(mem_budget_bytes=8 << 20)}
    wires = {}
    try:
        for name, cache in caches.items():
            tier = fleet_tier if name == "port" else jax_tier
            for i in range(3):
                cache.put_batches(f"k{i}", [_batch(i), _batch(i + 10)])
            entry = cache.peek("k1")
            meta = tier.entry_wire_meta(entry)
            payload = tier.entry_wire_payload(entry)["buf"]
            assert payload.dtype == np.uint8
            # Adopted as shipped (through the JSON a frame header takes).
            adopted = cache.put_entry("copy", json.loads(json.dumps(meta)), payload)
            with pytest.raises(ValueError, match="meta frames sum to"):
                cache.put_entry("torn", meta, bytes(payload)[:-3])
            cache.get_tiered("absent", count_miss=False)
            cache.get_tiered("absent")
            cache.note_miss()
            wires[name] = (meta, payload.tobytes(), adopted.meta, bytes(adopted.buf),
                           [k for k, _ in cache.hot_entries()],
                           {k: v for k, v in cache.stats().items() if k != "cache_dir"},
                           cache.peek("torn"))
    finally:
        for cache in caches.values():
            cache.cleanup()
    assert wires["port"] == wires["jax"]
    meta, payload, _, _, hot, stats, torn = wires["port"]
    assert hot == ["copy", "k2", "k1", "k0"] and torn is None
    assert stats["misses"] == 2 and stats["hits_mem"] == 0  # peek counts nothing


def test_cache_write_and_read_failpoints(tmp_path):
    """``cache.write`` ``partial`` publishes a torn entry the load detects
    and deletes (a miss, never a stream error); ``oserror`` skips the disk
    write; ``cache.read`` ``oserror`` makes the load a miss."""
    cache = BatchCache(mem_budget_bytes=1, cache_dir=str(tmp_path / "d"), spill_to_disk=True)
    try:
        schedule = port_fp.FaultSchedule(
            3, points=["cache.write"], fires={"cache.write": {0: "partial", 1: "oserror"}})
        with port_fp.armed(schedule):
            cache.put_batches("torn", [_batch(0)])
            cache.put_batches("skipped", [_batch(1)])
            cache.put_batches("kept", [_batch(2)])
        assert cache.get("torn") is None and cache.corrupt_entries == 1
        assert cache.get("skipped") is None and cache.disk_write_errors == 1
        with port_fp.armed(port_fp.FaultSchedule(
                3, points=["cache.read"], fires={"cache.read": {0: "oserror"}})):
            assert cache.get("kept") is None
        assert cache.get("kept").to_dicts()[0]["i"].tolist() == list(range(6))
        assert [p for p, _, _ in schedule.log] == ["cache.write", "cache.write"]
    finally:
        cache.cleanup()


# ---------------------------------------------------------------------------
# the tier over an in-process wire
# ---------------------------------------------------------------------------

def _wire(tiers):
    """The peer transport as the worker's handlers answer it, with the JSON
    round trip a frame header takes."""
    def peer_request(self, peer_id, header, payload=None):
        fp = port_fp.ACTIVE
        if fp is not None and fp.fire("cache-peer-gone") == "gone":
            raise ConnectionRefusedError("failpoint cache-peer-gone: peer dial refused")
        peer = tiers[peer_id]
        header = json.loads(json.dumps(header))
        if header["type"] == "cache_fetch":
            reply, reply_payload = peer.serve_fetch(str(header["key"]))
            return json.loads(json.dumps(reply)), reply_payload
        if header["type"] == "cache_put":
            entry = peer.adopt(str(header["key"]), header.get("meta") or [],
                               (payload or {}).get("buf", b""),
                               origin=str(header.get("origin", "placement")))
            return {"type": "ok", "rows": entry.rows}, None
        raise AssertionError(f"unexpected peer request {header['type']!r}")
    return peer_request


@pytest.fixture()
def tiers(monkeypatch):
    """A port tier (``wa``) and a JAX tier (``wb``) peering in-process."""
    out = {"wa": fleet_tier.FleetCacheTier(BatchCache(mem_budget_bytes=32 << 20), "wa"),
           "wb": jax_tier.FleetCacheTier(JaxBatchCache(mem_budget_bytes=32 << 20), "wb")}
    monkeypatch.setattr(fleet_tier.FleetCacheTier, "_peer_request", _wire(out))
    monkeypatch.setattr(jax_tier.FleetCacheTier, "_peer_request", _wire(out))
    for tier in out.values():
        tier.update_peers([[wid, "127.0.0.1", 1] for wid in out])
    yield out
    for tier in out.values():
        tier.cleanup()


def _keys_owned_by(owner, count, peers=("wa", "wb")):
    ring = HashRing(peers)
    return [k for k in (f"entry-{i}" for i in range(400)) if ring.owner(k) == owner][:count]


@pytest.mark.parametrize("owner,reader", [("wa", "wb"), ("wb", "wa")])
def test_remote_warm_serves_cross_the_packages_byte_for_byte(tiers, owner, reader):
    keys = _keys_owned_by(owner, 2)
    tiers[owner].local.put_batches(keys[0], [_batch(i) for i in range(4)])
    original = tiers[owner].local.peek(keys[0])
    entry, tier = tiers[reader].get_tiered(keys[0])
    assert tier == "remote" and bytes(entry.buf) == bytes(original.buf)
    assert entry.meta == original.meta
    for index in range(4):  # every watermark seek of the adopted entry
        assert [bytes(f) for f in entry.batch_at(index).frames] == \
            [bytes(f) for f in original.batch_at(index).frames]
    assert tiers[owner].local.stats()["hits_mem"] == 0  # a peer's fetch counts nothing
    assert tiers[reader].get_tiered(keys[0])[1] == "mem"  # promoted
    assert tiers[reader].get_tiered(keys[1]) == (None, None)  # a fleet-wide miss
    stats = tiers[reader].stats()
    assert (stats["remote_hits"], stats["remote_misses"], stats["misses"]) == (1, 1, 1)
    assert stats["hits"] == 2 and stats["tier"] == "fleet" and stats["peers"] == 2


def test_write_through_placement_and_the_drain_hand_off(tiers):
    wa, wb = tiers["wa"], tiers["wb"]
    pushed = _keys_owned_by("wb", 3)
    for i, key in enumerate(pushed + _keys_owned_by("wa", 1)):
        builder = wa.begin_fill(key)
        builder.add_batch(_batch(i))
        builder.commit()
    deadline = time.monotonic() + 10
    while wa.pushes_sent < len(pushed) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert wa.pushes_sent == 3 and wa.fills == 4
    assert all(wb.local.peek(k) is not None for k in pushed)
    assert wb.local.peek(_keys_owned_by("wa", 1)[0]) is None  # owned here: not pushed
    summary = wa.handoff()
    assert summary == {"entries": 4, "bytes": summary["bytes"], "peers": {"wb": 4},
                       "errors": 0, "torn": False} and summary["bytes"] > 0
    assert wb.handoff_entries_received == 4 and wa.handoff_entries_sent == 4
    wb.update_peers([["wb", "127.0.0.1", 1]])
    assert wb.handoff() == {"entries": 0, "bytes": 0, "peers": {}, "errors": 0,
                            "torn": False}


def test_handoff_torn_and_peer_gone_failpoints_degrade(tiers):
    wa, wb = tiers["wa"], tiers["wb"]
    for i in range(4):
        wa.local.put_batches(f"h{i}", [_batch(i)])
    with port_fp.armed(port_fp.FaultSchedule(
            5, points=["handoff-torn"], fires={"handoff-torn": {2: "torn"}})):
        summary = wa.handoff()
    assert summary["torn"] is True and summary["entries"] == 2
    key = _keys_owned_by("wb", 1)[0]
    wb.local.put_batches(key, [_batch(7)])
    with port_fp.armed(port_fp.FaultSchedule(
            5, points=["cache-peer-gone"], fires={"cache-peer-gone": {0: "gone"}})):
        assert wa.get_tiered(key) == (None, None)  # a local fill, never an error
    assert wa.remote_errors == 1 and wa.get_tiered(key)[1] == "remote"


def test_breaker_open_degrades_to_local_fills(monkeypatch):
    clock = [0.0]
    tier = fleet_tier.FleetCacheTier(BatchCache(mem_budget_bytes=8 << 20), "wa",
                                     clock=lambda: clock[0])
    try:
        tier.update_peers([["wa", "127.0.0.1", 1], ["wb", "127.0.0.1", 2]])

        def refuse(self, peer_id, header, payload=None):
            raise ConnectionRefusedError("peer gone")
        monkeypatch.setattr(fleet_tier.FleetCacheTier, "_peer_request", refuse)
        key = _keys_owned_by("wb", 1)[0]
        for _ in range(5):
            assert tier.get_tiered(key) == (None, None)
        assert tier.remote_errors == 5 and tier.stats()["breakers_open"] == 1
        assert tier.get_tiered(key) == (None, None) and tier.breaker_skips == 1
        tier.put_batches(key, [_batch(3)])
        assert tier.get_tiered(key)[1] == "mem"
        assert tier.stats()["misses"] == 6  # one a cold lookup, never counted twice
        clock[0] = 60.0  # past the cooldown: the half-open probe dials again
        tier.get_tiered(_keys_owned_by("wb", 2)[1])
        assert tier.remote_errors == 6
    finally:
        tier.cleanup()


def test_torn_payloads_are_refused_and_the_tier_delegates(tiers):
    wa, wb = tiers["wa"], tiers["wb"]
    wa.local.put_batches("k", [_batch(0)])
    entry = wa.local.peek("k")
    meta = fleet_tier.entry_wire_meta(entry)
    for tier in (wa, wb):
        with pytest.raises(ValueError):
            tier.adopt("t", meta, bytes(entry.buf)[:-7])
        assert tier.local.peek("t") is None
    assert wa.contains("nope") is False and wa.worker_id == "wa"
    assert isinstance(fleet_tier.PeerError("x"), ValueError)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def _reg(wid, port, cache_fleet=True):
    return {"type": "register_worker", "worker_id": wid, "host": "127.0.0.1", "port": port,
            "num_pieces": 4, "cache_fleet": cache_fleet}


PLAN = {"action": "drain", "worker_id": "wb", "reason": "marginal 3.0 rows/s < 50.0",
        "model": {"per_worker_rows_s": 100.0, "ceiling_rows_s": 210.0},
        "predicted_rows_s": 210.0, "whatif_error": 0.01, "probe": True}


def _cache_script(dispatcher):
    """The JAX cache-peer and hand-off script; the replies with the clock
    fields dropped."""
    replies = [dispatcher._handle(step) for step in (
        _reg("wa", 11), _reg("wb", 12), _reg("wc", 13, cache_fleet=False),
        {"type": "worker_heartbeat", "worker_id": "wa"})]
    dispatcher.drain_worker("wb")
    replies.append(dispatcher._handle({"type": "worker_heartbeat", "worker_id": "wb"}))
    replies.append(dispatcher._handle({"type": "cache_handoff", "worker_id": "wb",
                                       "entries": 7, "bytes": 4096, "peers": {"wa": 7},
                                       "errors": 1, "torn": True}))
    replies.append(dispatcher._handle({"type": "cache_handoff"}))
    replies.append(dispatcher.record_fleet_plan(dict(PLAN)))
    return [{k: v for k, v in r.items() if k != "dispatcher_time_us"}
            if isinstance(r, dict) else r for r in replies]


def test_cache_peers_hand_offs_and_fleet_plans_equal_jax(tmp_path):
    out = {}
    for name, package in (("port", port_service), ("jax", jax_service)):
        journal = tmp_path / name
        with package.Dispatcher(journal_dir=str(journal), lease_timeout_s=None).start() as d:
            replies = _cache_script(d)
            live = d._handle({"type": "status"})["fleet"]
            handoffs = d.cache_handoffs()
        with package.Dispatcher(journal_dir=str(journal), lease_timeout_s=None).start() as d:
            replayed = d._handle({"type": "status"})["fleet"]
            with d._lock:
                d._journal.snapshot(d._state_dict_locked())
        with package.Dispatcher(journal_dir=str(journal), lease_timeout_s=None).start() as d:
            compacted = d._handle({"type": "status"})["fleet"]
        files = {f: (journal / f).read_bytes() for f in ("wal.jsonl", "snapshot.json")}
        out[name] = (replies, live, handoffs, replayed, compacted, files)
    assert out["port"] == out["jax"]  # the journal files byte for byte too
    replies, live, handoffs, replayed, compacted, _ = out["port"]
    assert replies[0]["cache_peers"] == [["wa", "127.0.0.1", 11]]
    assert replies[1]["cache_peers"] == [["wa", "127.0.0.1", 11], ["wb", "127.0.0.1", 12]]
    assert "cache_peers" not in replies[2]
    assert replies[4]["worker_state"] == "draining"
    assert [p[0] for p in replies[4]["cache_peers"]] == ["wa"]
    assert replies[6] == {"type": "error", "error": "cache_handoff requires a worker_id"}
    assert handoffs == [{"worker_id": "wb", "entries": 7, "bytes": 4096, "peers": {"wa": 7},
                         "errors": 1, "torn": True}]
    for fleet_view in (replayed, compacted):
        assert fleet_view["cache_handoffs"] == live["cache_handoffs"]
        assert fleet_view["fleet_plans"] == live["fleet_plans"] == [
            dict(sorted(PLAN.items()))]
    assert [p[0] for p in replayed["cache_peers"]] == ["wa"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_cache_journal(writer, tmp_path):
    packages = {"port": port_service, "jax": jax_service}
    with packages[writer].Dispatcher(journal_dir=str(tmp_path / "j"),
                                     lease_timeout_s=None).start() as d:
        _cache_script(d)
    views = {}
    for name in (("port", "jax") if writer == "jax" else ("jax", "port")):
        with packages[name].Dispatcher(journal_dir=str(tmp_path / "j"),
                                       lease_timeout_s=None).start() as d:
            snapshot = d.state_snapshot()
            views[name] = {k: v for k, v in snapshot.items()
                           if k not in ("recovery", "fencing_epoch")}
    assert views["port"] == views["jax"]
    assert views["port"]["autoscale"] == {"admit": 0, "drain": 1, "retire": 0}
    assert views["port"]["workers"]["wa"]["cache_fleet"] is True


# ---------------------------------------------------------------------------
# status --watch
# ---------------------------------------------------------------------------

def _sample(t, workers, status=None):
    base = {"mode": "static", "fencing_epoch": 0,
            "workers": {wid: {"alive": True} for wid in workers}, "clients": {}, "fleet": {}}
    base.update(status or {})
    return {"t": t, "status": base, "workers": workers}


def _metrics(rows=1000.0, hits=None, misses=None, tier=None, entries=0):
    metrics = {"rows_sent_total": rows, "batches_sent_total": rows / 10,
               "credit_wait_seconds_total": 0.0, "active_streams": 1.0}
    if hits is not None:
        metrics["cache_hits_total"] = hits
        metrics["cache_misses_total"] = misses
    if tier is not None:
        metrics["cache_tier"] = tier
        metrics["cache_entries_mem"] = entries
    return {"metrics": metrics}


WATCH_SAMPLES = {
    "cache-column": (
        _sample(0.0, {"w-fleet": _metrics(hits=0, misses=0, tier="fleet", entries=3),
                      "w-local": _metrics(hits=0, misses=0, tier="local", entries=1),
                      "w-off": _metrics()}),
        _sample(1.0, {"w-fleet": _metrics(rows=2000.0, hits=8, misses=2, tier="fleet",
                                          entries=12),
                      "w-local": _metrics(rows=2000.0, hits=1, misses=1, tier="local",
                                          entries=4),
                      "w-off": _metrics(rows=2000.0), "w-gone": {"error": "unreachable"}})),
    "baseline": (_sample(0.0, {"w0": _metrics()}),
                 _sample(1.0, {"w0": _metrics(rows=2000.0, hits=900, misses=100,
                                              tier="local", entries=4)})),
    "plan-and-handoff": (
        _sample(0.0, {"w0": _metrics()}),
        _sample(1.0, {"w0": _metrics(rows=2000.0)}, status={"fleet": {
            "workers_by_state": {"serving": ["w0"], "standby": ["w1"], "draining": []},
            "autoscale": {"admit": 1, "drain": 0, "retire": 0}, "autoscaler_armed": True,
            "fleet_plans": [{"action": "admit", "worker_id": "w1", "predicted_rows_s": 300.0,
                             "whatif_error": 0.02}],
            "cache_handoffs": [{"worker_id": "w2", "entries": 7, "bytes": 4096,
                                "peers": {"w0": 7}, "errors": 0, "torn": True}],
            "brownout": {"level": 1, "counts": {"shed": 1, "recover": 0}, "reason": "x",
                         "armed": True}, "breaker_open": {"w0": {}}},
            "recovery": {"evictions": 2, "journal_replays": 0}})),
}


@pytest.mark.parametrize("case", sorted(WATCH_SAMPLES))
def test_watch_lines_equal_jax(case):
    prev, cur = WATCH_SAMPLES[case]
    text = render_fleet_status(prev, cur)
    assert text == jax_render(prev, cur)
    if case == "cache-column":
        assert "fleet:12" in next(l for l in text.splitlines() if l.startswith("w-fleet"))
    if case == "baseline":
        assert next(l for l in text.splitlines() if l.startswith("w0")).split()[7] == "--"
    if case == "plan-and-handoff":
        assert ("fleet-plan: admit worker=w1 predicted_rows/s=300.0 whatif_err=2.0%") in text
        assert ("cache-handoff: w2 shipped 7 entries (4096 bytes) to 1 peers, 0 errors "
                "[TORN]") in text


# ---------------------------------------------------------------------------
# a loopback fleet
# ---------------------------------------------------------------------------

ROWS = 60  # 12 pieces of 5


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    url = f"file://{tmp_path_factory.mktemp('fleet_cache')}/scalar"
    create_test_scalar_dataset(url, rows_count=ROWS, rows_per_row_group=5)
    return url


def _fleet_stream(url, tag, fleet_cache, drain_after=None, workers=3, epochs=3):
    """Ordered, seeded epochs through ``workers`` dynamic workers with
    memory caches: the stream's digest and ids, the workers' cache stats
    and lookups by epoch, and the dispatcher's hand-offs. ``drain_after``
    drains the last worker after that many batches and waits for its
    hand-off before taking the next batch."""
    from petastorm_tpu_torch.service.chaos import StreamDigest

    dispatcher = port_service.Dispatcher(mode="dynamic", num_epochs=epochs,
                                         shuffle_seed=11).start()
    fleet_workers = []
    try:
        for i in range(workers):
            fleet_workers.append(port_service.BatchWorker(
                url, dispatcher_address=dispatcher.address, batch_size=5,
                reader_factory="batch", worker_id=f"{tag}-{i}", heartbeat_interval_s=0.05,
                batch_cache=BatchCache(mem_budget_bytes=16 << 20), fleet_cache=fleet_cache,
                reader_kwargs={"workers_count": 2}).start())
        if fleet_cache:
            deadline = time.monotonic() + 10
            while any(w.cache_stats()["peers"] < workers for w in fleet_workers) \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
        source = port_service.ServiceBatchSource(dispatcher.address, ordered=True,
                                                 dynamic_sync_interval_s=0.05)
        digest, ids = StreamDigest(), []
        for n, batch in enumerate(source()):
            digest.update(batch)
            ids.extend(int(i) for i in batch["id"])
            if drain_after is not None and n + 1 == drain_after:
                assert dispatcher.drain_worker(fleet_workers[-1].worker_id)
                deadline = time.monotonic() + 10
                while not dispatcher.cache_handoffs() and time.monotonic() < deadline:
                    time.sleep(0.02)
        stats = [w.cache_stats() for w in fleet_workers]
        by_epoch = [w.cache_stats_by_epoch() for w in fleet_workers]
        return digest.hexdigest(), sorted(ids), stats, dispatcher.cache_handoffs(), by_epoch
    finally:
        for worker in fleet_workers:
            worker.stop()
        dispatcher.stop()


def test_a_drain_hands_off_warmth_and_the_stream_stays_the_same(store):
    """A drain in the second epoch: the stream equals a cold fleet's, and
    once the hand-off landed the survivors decode nothing (the third
    epoch's lookups are all hits; a piece stolen while it decodes in the
    first is decoded twice, so that epoch may count more than 12)."""
    cold = _fleet_stream(store, "fc-cold", fleet_cache=False)
    drained = _fleet_stream(store, "fc-drain", fleet_cache=True, drain_after=14)
    assert drained[0] == cold[0] and drained[1] == sorted(list(range(ROWS)) * 3)
    stats, handoffs, by_epoch = drained[2], drained[3], drained[4]
    assert sum(e.get(0, {}).get("misses", 0) for e in by_epoch) >= 12
    assert sum(e.get(2, {}).get("misses", 0) for e in by_epoch) == 0
    assert sum(e.get(2, {}).get("hits", 0) for e in by_epoch) >= 12
    assert not by_epoch[-1].get(2)  # the drained worker served no third epoch
    assert sum(s["remote_errors"] for s in stats) == 0
    assert handoffs and handoffs[-1]["worker_id"] == "fc-drain-2" and not handoffs[-1]["torn"]
    sent = stats[-1]["handoff_entries_sent"]
    assert sent == handoffs[-1]["entries"] > 0
    assert sum(s["handoff_entries_received"] for s in stats[:-1]) == sent
