"""The port's shared-memory ring and transport negotiation, against the JAX
package.

The ring cases run a producer and a consumer over one socketpair in this
process, in three pairings: both the port's, a JAX producer read by a port
consumer, and a port producer read by a JAX consumer (the arena layout and
the records are the same bytes, which one case checks directly). They
cover the round trip, privately writable arrays, wrap-around under back
pressure, the spill to the socket, mapped frames from a shared frame pool,
the inline fallback for foreign frames, a producer's close, the receive
timeout, each shm failpoint, the live-resource registry, arena set-up
failure and pool exhaustion. One more case puts the producer in a process
of its own: the port's ring (pipe doorbells) is attached through
``/proc`` and carries inline, wrapped and mapped messages; the JAX ring's
eventfd doorbells cannot be reopened there, and its attach is refused.

The negotiation cases run a one-worker loopback fleet: ``auto`` on both
sides negotiates shm, ``tcp`` on either side serves TCP, a peer of another
host is served TCP without a downgrade, an arena that cannot be set up and
a client that cannot attach each downgrade the same request to TCP
(counted), and a JAX client negotiates shm with a port worker.

Each test checks that the port's ``live_shm_counts`` are back where they
started (the conftest guard reads only the JAX registry). Tolerance: none.
"""

import errno
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from petastorm_tpu import failpoints as jax_failpoints
from petastorm_tpu.reader_impl import framed_socket as jax_wire
from petastorm_tpu.service import shm_ring as jax_ring
from petastorm_tpu_torch import failpoints
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.reader_impl import framed_socket as port_wire
from petastorm_tpu_torch.service import shm_ring
from petastorm_tpu_torch.service import transport as transport_mod
from petastorm_tpu_torch.telemetry.metrics import SHM_FRAMES, TRANSPORT_DOWNGRADES

#: (producer module, consumer module, consumer's framed_socket) by pairing.
PAIRS = {
    "port": (shm_ring, shm_ring, port_wire),
    "jax-to-port": (jax_ring, shm_ring, port_wire),
    "port-to-jax": (shm_ring, jax_ring, jax_wire),
}


@pytest.fixture(autouse=True)
def no_shm_leak():
    before = shm_ring.live_shm_counts()
    yield
    assert shm_ring.live_shm_counts() == before


@pytest.fixture
def sock_pair():
    a, b = socket.socketpair()
    yield a, b
    for s in (a, b):
        try:
            s.close()
        except OSError:
            pass


@pytest.fixture(params=sorted(PAIRS))
def pairing(request):
    return PAIRS[request.param]


def _make_ring(pairing, sock_pair, data_size=1 << 16, pool=None):
    producer_mod, consumer_mod, wire = pairing
    wsock, csock = sock_pair
    producer = producer_mod.RingProducer(wsock, pool=pool, data_size=data_size)
    consumer = consumer_mod.RingConsumer(producer.descriptor(), csock,
                                         wire.FramedReader(csock))
    return producer, consumer


def _close(*ends):
    for end in ends:
        if end is not None:
            end.close()


def test_inline_roundtrip_preserves_header_and_payload(pairing, sock_pair):
    producer, consumer = _make_ring(pairing, sock_pair)
    try:
        batch = {"a": np.arange(100, dtype=np.int64), "b": np.ones((4, 7), dtype=np.float32)}
        producer.send({"type": "batch", "bid": 1}, batch)
        producer.send({"type": "end", "rows": 100})
        header, payload = consumer.recv(timeout=5)
        assert header == {"type": "batch", "bid": 1}
        np.testing.assert_array_equal(payload["a"], batch["a"])
        np.testing.assert_array_equal(payload["b"], batch["b"])
        assert consumer.recv(timeout=5) == ({"type": "end", "rows": 100}, None)
    finally:
        _close(producer, consumer)


def test_records_are_the_jax_producers_bytes(sock_pair):
    """The same messages written by each package's producer leave the same
    header page and data region, byte for byte."""
    other = socket.socketpair()
    rings = [shm_ring.RingProducer(sock_pair[0], data_size=4096),
             jax_ring.RingProducer(other[0], data_size=4096)]
    try:
        for ring in rings:
            for i in range(9):  # wraps the 4 KiB region
                ring.send({"type": "batch", "i": i},
                          {"x": np.arange(40 * i, dtype=np.int32), "s": np.array(["a", "bc"])})
                ring._arena.put(40 + 8, ring._write_pos)  # consume: read_pos = write_pos
        assert bytes(rings[0]._arena.mm) == bytes(rings[1]._arena.mm)
    finally:
        _close(*rings)
        for s in other:
            s.close()


def test_delivered_arrays_are_privately_writable(pairing, sock_pair):
    producer, consumer = _make_ring(pairing, sock_pair)
    try:
        producer.send({"type": "batch"}, {"x": np.zeros(8, np.int64)})
        _, payload = consumer.recv(timeout=5)
        payload["x"] += 7  # neither read-only nor aliasing the ring
        assert payload["x"].sum() == 56
    finally:
        _close(producer, consumer)


def test_wraparound_under_backpressure_preserves_order(pairing, sock_pair):
    producer, consumer = _make_ring(pairing, sock_pair, data_size=4096)
    rng = np.random.default_rng(7)
    sent = [rng.integers(0, 255, size=700, dtype=np.uint8) for _ in range(60)]
    received, errors = [], []

    def consume():
        try:
            while True:
                header, payload = consumer.recv(timeout=20)
                if header["type"] == "end":
                    return
                received.append((header["i"], payload))
        except Exception as exc:  # reported through errors
            errors.append(exc)

    thread = threading.Thread(target=consume)
    thread.start()
    try:
        for i, arr in enumerate(sent):
            producer.send({"type": "batch", "i": i}, arr)
        producer.send({"type": "end"})
        thread.join(timeout=30)
        assert not thread.is_alive() and not errors
        assert [i for i, _ in received] == list(range(len(sent)))
        for (_, got), want in zip(received, sent):
            np.testing.assert_array_equal(got, want)
    finally:
        _close(producer, consumer)


def test_oversized_message_spills_to_socket_in_ring_order(pairing, sock_pair):
    producer, consumer = _make_ring(pairing, sock_pair, data_size=4096)
    big = np.arange(20_000, dtype=np.uint8)
    received, errors = [], []

    def consume():
        try:
            for _ in range(3):
                received.append(consumer.recv(timeout=20))
        except Exception as exc:
            errors.append(exc)

    thread = threading.Thread(target=consume)
    thread.start()
    try:
        producer.send({"i": 0}, np.ones(10, np.uint8))
        producer.send({"i": 1}, big)  # bigger than the ring: spilled
        producer.send({"i": 2}, np.full(10, 2, np.uint8))
        thread.join(timeout=30)
        assert not thread.is_alive() and not errors
        assert [h["i"] for h, _ in received] == [0, 1, 2]
        np.testing.assert_array_equal(received[1][1], big)
    finally:
        _close(producer, consumer)


def test_mapped_frames_roundtrip_from_shared_pool(pairing, sock_pair):
    """Frames that live in the producer's frame pool travel as references
    and decode to the same payload; the consumer attaches the pool with
    its own package's FramePool."""
    producer_mod, consumer_mod, wire = pairing
    pool = producer_mod.FramePool(size=1 << 20)
    consumer_pool = None
    producer, consumer = _make_ring(pairing, sock_pair, pool=pool)
    try:
        consumer_pool = consumer_mod.FramePool.attach(pool.descriptor())
        consumer.attach_pool(consumer_pool)
        batch = {"a": np.arange(500, dtype=np.float64)}
        fmt, frames = port_wire.encode_payload(batch)
        parts = [bytes(memoryview(f).cast("B")) for f in frames]
        buf = pool.allocate(sum(len(p) for p in parts))
        buf[:] = b"".join(parts)
        views, off = [], 0
        for part in parts:
            views.append(buf[off:off + len(part)])
            off += len(part)
        assert pool.locate(views) is not None
        mapped = SHM_FRAMES.labels("mapped").value
        producer.send_frames({"type": "batch", "bid": 9}, fmt, views)
        header, payload = consumer.recv(timeout=5)
        assert header["bid"] == 9
        np.testing.assert_array_equal(payload["a"], batch["a"])
        if producer_mod is shm_ring:
            assert SHM_FRAMES.labels("mapped").value == mapped + len(views)
        del views, buf  # release the pool's exports before it unmaps
    finally:
        _close(producer, consumer, consumer_pool, pool)


def test_foreign_frames_fall_back_to_inline_copy(pairing, sock_pair):
    pool = pairing[0].FramePool(size=1 << 20)
    producer, consumer = _make_ring(pairing, sock_pair, pool=pool)
    try:
        assert pool.locate([np.arange(16)]) is None
        producer.send({"type": "batch"}, {"x": np.arange(16)})
        _, payload = consumer.recv(timeout=5)
        np.testing.assert_array_equal(payload["x"], np.arange(16))
    finally:
        _close(producer, consumer, pool)


def test_producer_close_lets_consumer_drain_then_signals_closed(pairing, sock_pair):
    producer, consumer = _make_ring(pairing, sock_pair)
    closed = pairing[2].ConnectionClosedError
    try:
        producer.send({"type": "batch", "i": 0}, np.arange(5))
        producer.send({"type": "end"})
        producer.close()
        assert consumer.recv(timeout=5)[0] == {"type": "batch", "i": 0}
        assert consumer.recv(timeout=5)[0] == {"type": "end"}
        with pytest.raises(closed):
            consumer.recv(timeout=5)
    finally:
        _close(producer, consumer)


def test_recv_timeout_raises_socket_timeout(pairing, sock_pair):
    producer, consumer = _make_ring(pairing, sock_pair)
    try:
        with pytest.raises(socket.timeout):
            consumer.recv(timeout=0.05)
    finally:
        _close(producer, consumer)


@pytest.mark.parametrize("point,action,error", [
    ("shm-detach", "detach", "ConnectionClosedError"),
    ("torn-doorbell", "torn", "ProtocolError"),
    ("stale-arena", "stale", "ProtocolError"),
])
def test_shm_failpoints_break_both_ends(pairing, sock_pair, point, action, error):
    """Each failpoint resets the producer and reaches the consumer as the
    exception the broken-stream recovery expects, whichever package wrote
    the ring; the schedule of the producer's package decides, as the JAX
    one does for the same seed."""
    producer, consumer = _make_ring(pairing, sock_pair)
    fp = failpoints if pairing[0] is shm_ring else jax_failpoints
    schedule = fp.FaultSchedule(seed=1, points=(point,), fires={point: {1: action}})
    try:
        with fp.armed(schedule):
            producer.send({"i": 0}, np.arange(4))
            assert consumer.recv(timeout=5)[0] == {"i": 0}
            with pytest.raises(ConnectionResetError):
                producer.send({"i": 1}, np.arange(4))
            with pytest.raises(getattr(pairing[2], error)):
                consumer.recv(timeout=5)
        assert (point, 1, action) in schedule.log
    finally:
        _close(producer, consumer)


#: A producer in its own process: it offers its ring and frame pool over
#: the socket, and on an ack sends 20 seeded int32 batches through a 4 KiB
#: ring (it waits for space on the doorbell), one batch mapped from the pool
#: and an end.
_CHILD_PRODUCER = """
import socket, sys
import numpy as np
pkg = sys.argv[2]
wire = __import__(pkg + ".reader_impl.framed_socket", fromlist=["x"])
ring = __import__(pkg + ".service.shm_ring", fromlist=["x"])
sock = socket.socket(fileno=int(sys.argv[1]))
pool = ring.FramePool(size=1 << 16)
producer = ring.RingProducer(sock, pool=pool, data_size=4096)
wire.send_framed(sock, {"ring": producer.descriptor(), "pool": pool.descriptor()})
reader = wire.FramedReader(sock)
if reader.recv()[0]["attached"]:
    rng = np.random.default_rng(3)
    for i in range(20):
        producer.send({"type": "batch", "i": i}, {"x": rng.integers(0, 1 << 30, 100 + 20 * i,
                                                                 dtype=np.int32)})
    fmt, frames = wire._encode_payload({"m": np.arange(64, dtype=np.int16)})
    pooled = []
    for frame in frames:
        buf = pool.allocate(memoryview(frame).nbytes)
        buf[:] = memoryview(frame).cast("B")
        pooled.append(buf)
    producer.send_frames({"type": "mapped"}, fmt, pooled)
    producer.send({"type": "end"})
try:
    reader.recv()  # the consumer closes its end when it is done
except (ConnectionError, OSError):
    pass
producer.close()
pool.close()
"""


@pytest.mark.parametrize("package", ["petastorm_tpu_torch", "petastorm_tpu"])
def test_a_producer_in_another_process_is_attached_through_proc(package):
    parent, child_end = socket.socketpair()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-c", _CHILD_PRODUCER, str(child_end.fileno()),
                              package], pass_fds=(child_end.fileno(),), env=env)
    child_end.close()
    consumer = pool = None
    try:
        reader = port_wire.FramedReader(parent)
        offer, _ = reader.recv()
        if package == "petastorm_tpu":  # eventfd doorbells: /proc refuses them (ENXIO)
            with pytest.raises(shm_ring.ShmAttachError, match="No such device"):
                shm_ring.RingConsumer(offer["ring"], parent, reader)
            port_wire.send_framed(parent, {"attached": False})
            return
        consumer = shm_ring.RingConsumer(offer["ring"], parent, reader)
        pool = shm_ring.FramePool.attach(offer["pool"])
        consumer.attach_pool(pool)
        mapped_before = SHM_FRAMES.labels("mapped").value
        port_wire.send_framed(parent, {"attached": True})
        rng = np.random.default_rng(3)
        for i in range(20):
            header, payload = consumer.recv(timeout=30)
            assert header == {"type": "batch", "i": i}
            np.testing.assert_array_equal(
                payload["x"], rng.integers(0, 1 << 30, 100 + 20 * i, dtype=np.int32))
        header, payload = consumer.recv(timeout=30)
        assert header == {"type": "mapped"}
        np.testing.assert_array_equal(payload["m"], np.arange(64, dtype=np.int16))
        assert SHM_FRAMES.labels("mapped").value == mapped_before  # counted in the child
        assert consumer.recv(timeout=30) == ({"type": "end"}, None)
    finally:
        _close(consumer, pool)
        parent.close()
        assert child.wait(timeout=60) == 0


def test_live_resource_registry_returns_to_baseline(sock_pair):
    base = shm_ring.live_shm_counts()
    assert base.keys() == jax_ring.live_shm_counts().keys()
    pool = shm_ring.FramePool(size=1 << 16)
    producer, consumer = _make_ring(PAIRS["port"], sock_pair, pool=pool)
    during = shm_ring.live_shm_counts()
    assert (during["rings"], during["pools"], during["eventfds"]) == \
        (base["rings"] + 2, base["pools"] + 1, base["eventfds"] + 4)
    names = [os.readlink(f"/proc/self/fd/{fd}") for fd in os.listdir("/proc/self/fd")
             if os.path.exists(f"/proc/self/fd/{fd}")]
    assert sum("ptshm" in name for name in names) >= 3  # what the conftest guard scans
    _close(producer, consumer, pool)
    assert shm_ring.live_shm_counts() == base
    _close(producer, consumer, pool)  # idempotent: counts never go negative
    assert shm_ring.live_shm_counts() == base


def test_arena_setup_failure_is_catchable_shm_setup_error(sock_pair, monkeypatch):
    def full_pwrite(fd, data, offset):
        raise OSError(errno.ENOSPC, "no space left on device")

    monkeypatch.setattr(os, "pwrite", full_pwrite)
    for mod in (shm_ring, jax_ring):
        with pytest.raises(mod.ShmSetupError):
            mod.RingProducer(sock_pair[0], data_size=1 << 16)
        with pytest.raises(mod.ShmSetupError):
            mod.FramePool(size=1 << 16)


def test_pool_allocate_and_locate_equal_jax():
    pools = [mod.FramePool(size=1 << 12) for mod in (shm_ring, jax_ring)]
    try:
        results = []
        for pool in pools:
            first = pool.allocate(1 << 10)
            second = pool.allocate(13)
            refs = pool.locate([first, second[:5], second[5:]])
            results.append((refs, pool.allocate(1 << 12), pool.allocate(0), pool.used_bytes(),
                            pool.locate([first, np.zeros(3)])))
            del first, second
        assert results[0] == results[1]
        refs, overflow, empty, used, mixed = results[0]
        assert refs == [(0, 1024), (1024, 5), (1029, 8)]
        assert (overflow, empty, used, mixed) == (None, None, 1040, None)
    finally:
        _close(*pools)


# ---------------------------------------------------------------------------
# negotiation
# ---------------------------------------------------------------------------

def test_resolve_mode_and_advertisement_equal_jax(monkeypatch):
    from petastorm_tpu.service import transport as jax_transport

    monkeypatch.delenv("PETASTORM_TRANSPORT", raising=False)
    for value in (None, "tcp", "auto", "shm"):
        assert transport_mod.resolve_mode(value) == jax_transport.resolve_mode(value)
    monkeypatch.setenv("PETASTORM_TRANSPORT", "tcp")
    assert transport_mod.resolve_mode() == "tcp" and transport_mod.resolve_mode("shm") == "shm"
    with pytest.raises(ValueError, match="transport must be one of"):
        transport_mod.resolve_mode("carrier-pigeon")
    assert transport_mod.advertisement("tcp") is jax_transport.advertisement("tcp") is None
    assert transport_mod.advertisement("auto") == jax_transport.advertisement("auto")
    assert transport_mod.host_token() == jax_transport.host_token()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_dataset

    url = f"file://{tmp_path_factory.mktemp('shm')}/rows"
    create_test_dataset(url, rows_count=40, rows_per_row_group=10)
    return url


def _fleet_ids(url, client=port_service, worker_transport=None, **source_kwargs):
    """Every id one iteration delivers, and the worker's transport counts."""
    dispatcher = port_service.Dispatcher(port=0, mode="static", num_epochs=1).start()
    worker = port_service.BatchWorker(url, dispatcher_address=dispatcher.address,
                                      batch_size=7, transport=worker_transport,
                                      reader_kwargs={"workers_count": 2}).start()
    try:
        source = client.ServiceBatchSource(dispatcher.address, **source_kwargs)
        ids = sorted(int(i) for batch in source() for i in batch["id"])
        metrics = worker.diagnostics_snapshot()["metrics"]
        return ids, (metrics["transport_streams_shm_total"],
                     metrics["transport_streams_tcp_total"]), source
    finally:
        worker.stop()
        dispatcher.stop()


def _downgrades():
    return sum(TRANSPORT_DOWNGRADES.labels(reason).value
               for reason in ("arena_setup", "client_nack"))


def test_loopback_auto_negotiates_shm(store):
    ids, (shm, tcp), _ = _fleet_ids(store)
    assert ids == list(range(40))
    assert shm >= 1 and tcp == 0


def test_a_jax_client_negotiates_shm_with_a_port_worker(store):
    from petastorm_tpu import service as jax_service

    ids, (shm, tcp), _ = _fleet_ids(store, client=jax_service)
    assert ids == list(range(40))
    assert shm >= 1 and tcp == 0


@pytest.mark.parametrize("side", ["client", "worker"])
def test_transport_tcp_on_either_side_forces_tcp(store, side):
    before = _downgrades()
    ids, (shm, tcp), _ = _fleet_ids(store, worker_transport="tcp" if side == "worker" else None,
                                    transport="tcp" if side == "client" else None)
    assert ids == list(range(40))
    assert shm == 0 and tcp >= 1
    assert _downgrades() == before  # choosing TCP is not a downgrade


def test_cross_host_peer_serves_tcp_without_counting_a_downgrade(store, monkeypatch):
    monkeypatch.setattr(transport_mod, "advertisement",
                        lambda mode: None if mode == "tcp" else
                        {"modes": ["shm"], "host": "some-other-host", "pid": 1})
    before = _downgrades()
    ids, (shm, tcp), _ = _fleet_ids(store)
    assert ids == list(range(40))
    assert shm == 0 and tcp >= 1
    assert _downgrades() == before


def test_arena_setup_failure_downgrades_same_request(store, monkeypatch):
    """The ring cannot be made: this same request is served over TCP with
    its credit window whole (a 2-credit stream would stall otherwise)."""
    def exploding_producer(*args, **kwargs):
        raise shm_ring.ShmSetupError("injected: /dev/shm exhausted")

    monkeypatch.setattr(shm_ring, "RingProducer", exploding_producer)
    before = TRANSPORT_DOWNGRADES.labels("arena_setup").value
    ids, (shm, tcp), source = _fleet_ids(store, credits=2)
    assert ids == list(range(40))
    assert source.diagnostics["recovery"]["takeovers"] == 0
    assert shm == 0 and tcp >= 1
    assert TRANSPORT_DOWNGRADES.labels("arena_setup").value > before


def test_client_attach_failure_nacks_and_downgrades_same_request(store, monkeypatch):
    def exploding_consumer(*args, **kwargs):
        raise shm_ring.ShmAttachError("injected: attach refused")

    monkeypatch.setattr(shm_ring, "RingConsumer", exploding_consumer)
    before = TRANSPORT_DOWNGRADES.labels("client_nack").value
    ids, (shm, tcp), source = _fleet_ids(store, credits=2)
    assert ids == list(range(40))
    assert source.diagnostics["recovery"]["takeovers"] == 0
    assert shm == 0 and tcp >= 1
    assert TRANSPORT_DOWNGRADES.labels("client_nack").value > before
