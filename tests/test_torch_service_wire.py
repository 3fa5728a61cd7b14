"""The port's framed transport against the JAX package's.

- ``send_framed`` / ``send_framed_frames`` put the same bytes on the wire
  as the JAX functions for pickle, Arrow-table, COLUMNAR and ``None``
  payloads, and past IOV_MAX frames (the ``sendmsg`` split);
- each package receives the other's messages (``recv_framed`` and
  ``FramedReader``), decoded arrays stay intact while the reader's
  transient buffers are recycled (``BufferPool``), and the transport
  counters move as the JAX package's do for the same traffic;
- header and frame length caps are refused before any allocation, a header
  that is not a JSON object is a ``ProtocolError``, and a peer's close
  raises ``ConnectionClosedError``;
- ``FramedConnection`` / ``FramedServer`` request-reply and stop, and the
  transport mode resolution.

Everything is compared exactly.
"""

import socket
import struct
import threading

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.reader_impl import framed_socket as jax_wire
from petastorm_tpu.telemetry import metrics as jax_metrics
from petastorm_tpu_torch.reader_impl import framed_socket as port_wire
from petastorm_tpu_torch.telemetry import metrics as port_metrics


def _payloads():
    rng = np.random.RandomState(5)
    return {
        "none": None,
        "columnar": {"id": np.arange(6), "x": rng.rand(6, 3).astype(np.float32),
                     "when": np.arange(6).astype("datetime64[s]")},
        "pickle": {"id": np.arange(5), "s": np.array(["a", "bb", None, "d", "e"], dtype=object),
                   "x": rng.rand(5, 2)},
        "list": [1, "two", {"three": 3.0}],
        "arrow": pa.table({"c": [1, 2, 3], "d": ["x", "y", "z"],
                           "e": pa.array([[1.5], [], [2.5, 3.5]])}),
    }


def _wire_bytes(send, *args):
    """The bytes ``send(sock, *args)`` writes, read back from a socketpair."""
    a, b = socket.socketpair()
    out = []

    def drain():
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return
            out.append(chunk)

    reader = threading.Thread(target=drain)
    reader.start()
    try:
        send(a, *args)
    finally:
        a.shutdown(socket.SHUT_WR)
        reader.join(timeout=10)
        a.close()
        b.close()
    return b"".join(out)


@pytest.mark.parametrize("kind", sorted(_payloads()))
def test_send_framed_bytes_equal_jax(kind):
    header = {"type": "batch", "rows": 6, "bid": "w:s:0", "piece": 3, "ordinal": 1}
    payload = _payloads()[kind]
    port = _wire_bytes(port_wire.send_framed, header, payload)
    assert port == _wire_bytes(jax_wire.send_framed, header, payload)
    fmt = struct.unpack_from("!B", port, 8 + struct.unpack_from("!Q", port)[0])[0]
    assert fmt == {"none": port_wire.PAYLOAD_NONE, "columnar": port_wire.PAYLOAD_COLUMNAR,
                   "pickle": port_wire.PAYLOAD_PICKLE, "list": port_wire.PAYLOAD_PICKLE,
                   "arrow": port_wire.PAYLOAD_ARROW}[kind]


@pytest.mark.parametrize("frames", [0, 3, 511, 700])
def test_send_framed_frames_past_iov_max_equal_jax(frames):
    """700 frames are 1,404 iovec entries: split across two ``sendmsg``."""
    parts = [bytes([i % 251]) * (i % 7 + 1) for i in range(frames)]
    header = {"type": "batch", "n": frames}
    syscalls = port_metrics.TRANSPORT_SYSCALLS.labels("tcp")
    before = syscalls.value
    port = _wire_bytes(port_wire.send_framed_frames, header, port_wire.PAYLOAD_PICKLE, parts)
    assert syscalls.value - before >= (2 if 2 * frames + 4 > 1024 else 1)
    assert port == _wire_bytes(jax_wire.send_framed_frames, header, jax_wire.PAYLOAD_PICKLE,
                               parts)


def _assert_payload_equal(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, pa.Table):
        assert got.equals(want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    else:
        assert got == want


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_each_package_receives_the_others_messages(direction):
    send, recv_mods = ((port_wire.send_framed, jax_wire) if direction == "port_to_jax"
                       else (jax_wire.send_framed, port_wire))
    payloads = _payloads()
    for buffered in (False, True):
        # A FramedReader owns its socket's receive side (it reads ahead),
        # so each receiver gets a connection of its own.
        a, b = socket.socketpair()
        try:
            for i, payload in enumerate(payloads.values()):
                send(a, {"type": "m", "i": i}, payload)
            receive = recv_mods.FramedReader(b).recv if buffered \
                else (lambda: recv_mods.recv_framed(b))
            for i, (name, payload) in enumerate(payloads.items()):
                header, got = receive()
                assert header == {"type": "m", "i": i}, name
                _assert_payload_equal(got, payload)
        finally:
            a.close()
            b.close()


def test_framed_reader_recycles_buffers_and_keeps_arrays_intact():
    pool = port_wire.BufferPool()
    a, b = socket.socketpair()
    try:
        reader = port_wire.FramedReader(b, pool=pool)
        sent, got = [], []
        for i in range(40):
            batch = {"id": np.arange(i, i + 64), "x": np.full((64, 16), i, np.float32),
                     "s": np.array([str(i)] * 64, dtype=object)}
            sent.append(batch)
            threading.Thread(target=port_wire.send_framed, args=(a, {"i": i}, batch)).start()
            header, payload = reader.recv()
            assert header == {"i": i}
            got.append(payload)
        for want, have in zip(sent, got):  # earlier batches untouched by later receives
            _assert_payload_equal(have, want)
            assert have["x"].flags.writeable  # private receive buffers
        assert pool.hits > 0 and pool.misses <= 2
    finally:
        a.close()
        b.close()


def test_buffer_pool_equals_jax():
    for module in (port_wire, jax_wire):
        pool = module.BufferPool()
        buf = pool.acquire(100)
        assert len(buf) == 128
        pool.release(buf)
        assert pool.acquire(100) is buf and (pool.hits, pool.misses) == (1, 1)
        small = module.BufferPool(max_buffers=1, max_pooled_bytes=1024)
        first, second = small.acquire(64), small.acquire(64)
        small.release(first)
        small.release(second)
        assert small.acquire(64) is first and small.acquire(64) is not second
        big = small.acquire(5000)
        assert len(big) == 5000
        small.release(big)
        assert small.acquire(5000) is not big


def _raw(header_len=None, header=b"{}", frames=(), fmt=1):
    out = struct.pack("!Q", len(header) if header_len is None else header_len) + header
    out += struct.pack("!B", fmt) + struct.pack("!I", len(frames))
    for frame_len in frames:
        out += struct.pack("!Q", frame_len)
    return out


@pytest.mark.parametrize("case", ["header_cap", "frame_cap", "default_frame_cap",
                                  "not_json", "not_object"])
@pytest.mark.parametrize("receiver", ["recv_framed", "FramedReader"])
def test_caps_and_bad_headers_raise_protocol_error(case, receiver):
    data, kwargs = {
        "header_cap": (_raw(header_len=port_wire.MAX_HEADER_BYTES + 1), {}),
        "frame_cap": (_raw(frames=[1 << 20]), {"max_frame_bytes": 1 << 10}),
        "default_frame_cap": (_raw(frames=[port_wire.MAX_FRAME_BYTES + 1]), {}),
        "not_json": (_raw(header=b"\xff\xfe"), {}),
        "not_object": (_raw(header=b"[1, 2]"), {}),
    }[case]
    assert (port_wire.MAX_FRAME_BYTES, port_wire.MAX_HEADER_BYTES) == \
        (jax_wire.MAX_FRAME_BYTES, jax_wire.MAX_HEADER_BYTES)
    a, b = socket.socketpair()
    try:
        a.sendall(data)  # nothing follows the prefixes: an allocation would hang the read
        with pytest.raises(port_wire.ProtocolError):
            if receiver == "recv_framed":
                port_wire.recv_framed(b, **kwargs)
            else:
                port_wire.FramedReader(b, **kwargs).recv()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("where", ["between_messages", "mid_header", "mid_frame"])
@pytest.mark.parametrize("receiver", ["recv_framed", "FramedReader"])
def test_peer_close_raises_connection_closed(where, receiver):
    full = _wire_bytes(port_wire.send_framed, {"type": "x"}, {"a": np.arange(100)})
    cut = {"between_messages": 0, "mid_header": 11, "mid_frame": len(full) - 50}[where]
    a, b = socket.socketpair()
    try:
        a.sendall(full[:cut])
        a.close()
        with pytest.raises(port_wire.ConnectionClosedError):
            if receiver == "recv_framed":
                port_wire.recv_framed(b)
            else:
                port_wire.FramedReader(b).recv()
        assert issubclass(port_wire.ConnectionClosedError, ConnectionError)
    finally:
        b.close()


def test_transport_counters_move_as_jax():
    """The same two messages move each package's four transport families
    by the same amounts."""
    deltas = {}
    for name, wire, metrics in (("port", port_wire, port_metrics),
                                ("jax", jax_wire, jax_metrics)):
        children = [metrics.TRANSPORT_MESSAGES.labels(d, "tcp") for d in ("sent", "recv")] + \
            [metrics.TRANSPORT_FRAMES.labels(d, "tcp") for d in ("sent", "recv")] + \
            [metrics.TRANSPORT_BYTES.labels(d, "tcp") for d in ("sent", "recv")]
        before = [c.value for c in children]
        a, b = socket.socketpair()
        try:
            for payload in (_payloads()["columnar"], None):
                wire.send_framed(a, {"type": "m"}, payload)
                wire.recv_framed(b)
        finally:
            a.close()
            b.close()
        deltas[name] = [c.value - v for c, v in zip(children, before)]
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][0] == deltas["port"][1] == 2


def test_framed_server_and_connection_request_reply():
    def echo(sock):
        reader = port_wire.FramedReader(sock)
        while True:
            header, payload = reader.recv()
            port_wire.send_framed(sock, dict(header, echoed=True), payload)

    server = port_wire.FramedServer(echo, name="wire-test").start()
    try:
        with port_wire.FramedConnection.connect(server.address, timeout=5.0,
                                                keepalive=True) as conn:
            header, payload = conn.request({"type": "ping"}, {"v": np.arange(3)})
            assert header == {"type": "ping", "echoed": True}
            np.testing.assert_array_equal(payload["v"], np.arange(3))
        with jax_wire.FramedConnection.connect(server.address, timeout=5.0) as conn:
            assert conn.request({"type": "jax"})[0] == {"type": "jax", "echoed": True}
        held = port_wire.FramedConnection.connect(server.address, timeout=5.0)
        held.request({"type": "hold"})
    finally:
        server.stop()
    assert server.join(timeout=5.0) == []
    with pytest.raises(port_wire.ConnectionClosedError):
        held.recv()  # the server closed the tracked connection at stop
    held.close()
    with pytest.raises(OSError):
        port_wire.FramedConnection.connect(server.address, timeout=1.0)


def test_transport_mode_resolution(monkeypatch):
    from petastorm_tpu.service import transport as jax_transport
    from petastorm_tpu_torch.service import transport

    monkeypatch.delenv("PETASTORM_TRANSPORT", raising=False)
    assert transport.MODES == jax_transport.MODES
    assert transport.resolve_mode() == jax_transport.resolve_mode() == "auto"
    assert transport.resolve_mode("TCP") == "tcp"
    monkeypatch.setenv("PETASTORM_TRANSPORT", "tcp")
    assert transport.resolve_mode() == jax_transport.resolve_mode() == "tcp"
    assert transport.resolve_mode("auto") == "auto"
    monkeypatch.setenv("PETASTORM_TRANSPORT", "shm")
    assert transport.resolve_mode() == jax_transport.resolve_mode() == "shm"
    with pytest.raises(ValueError, match="transport must be one of"):
        transport.resolve_mode("udp")
