"""Length-prefixed framed messages over a stream socket: the wire format
of the data service (the port's own copy of
``petastorm_tpu/reader_impl/framed_socket.py``).

One message is::

    !Q header_len | header JSON (utf-8)
    !B payload_format            # NONE / PICKLE / ARROW / COLUMNAR
    !I n_frames
    (!Q frame_len | frame bytes) * n_frames

For the same header and payload the bytes on the wire equal the JAX
package's, so a worker of either package serves a client of the other.

Payload formats (``encode_payload`` / ``decode_payload``, also the frames
the decoded-batch cache stores, :mod:`petastorm_tpu_torch.cache_impl`):

- ``PAYLOAD_COLUMNAR``: a ``{field: ndarray}`` batch of plain dtypes is one
  JSON meta frame (names, dtypes, shapes), then each column's C-contiguous
  bytes as a frame. Decoding is ``np.frombuffer`` views over the frames,
  which inherit the frames' writability: a cache entry's immutable
  ``bytes`` come back as read-only arrays, a received message's private
  buffers as writable ones.
- ``PAYLOAD_PICKLE``: anything else (object columns, extension dtypes):
  a protocol-5 pickle head with the arrays' buffers out of band as frames.
- ``PAYLOAD_ARROW``: a ``pa.Table`` as one Arrow IPC stream frame.

The send side coalesces a message into one ``sendmsg`` (split at IOV_MAX
entries); :class:`FramedReader` receives with few large ``recv_into``
calls into a per-connection buffer, bulk frames directly into their own
buffers, and recycles transient buffers through :class:`BufferPool`.
``recv_framed`` is the stateless field-by-field form. A peer's close
raises :class:`ConnectionClosedError`; a length prefix past the frame or
header cap raises :class:`ProtocolError` before anything is allocated for
it. :class:`FramedConnection` is a client socket; :class:`FramedServer`
the threaded accept loop the dispatcher and the workers serve on.
"""

from __future__ import annotations

import json
import pickle
import socket
import struct
import sys
import threading
import time

from petastorm_tpu_torch import failpoints as _failpoints
from petastorm_tpu_torch.telemetry.metrics import (
    TRANSPORT_BYTES,
    TRANSPORT_FRAMES,
    TRANSPORT_MESSAGES,
    TRANSPORT_SYSCALLS,
)

# Interned label children: this module is the tcp tier.
_TX_MESSAGES = TRANSPORT_MESSAGES.labels("sent", "tcp")
_TX_FRAMES = TRANSPORT_FRAMES.labels("sent", "tcp")
_TX_BYTES = TRANSPORT_BYTES.labels("sent", "tcp")
_RX_MESSAGES = TRANSPORT_MESSAGES.labels("recv", "tcp")
_RX_FRAMES = TRANSPORT_FRAMES.labels("recv", "tcp")
_RX_BYTES = TRANSPORT_BYTES.labels("recv", "tcp")
_TX_SYSCALLS = TRANSPORT_SYSCALLS.labels("tcp")

_LEN = struct.Struct("!Q")
_FMT = struct.Struct("!B")
_NFRAMES = struct.Struct("!I")

PAYLOAD_NONE = 0
PAYLOAD_PICKLE = 1
PAYLOAD_ARROW = 2
PAYLOAD_COLUMNAR = 3

#: Default frame-size cap: a larger length prefix is a corrupt, desynced or
#: hostile stream, refused before the allocation. Receivers take a
#: per-connection ``max_frame_bytes``.
MAX_FRAME_BYTES = 1 << 34
#: Headers are small JSON dicts; a longer header length means a desynced
#: or non-protocol byte stream.
MAX_HEADER_BYTES = 1 << 20

#: Max iovec entries per ``sendmsg`` (Linux's IOV_MAX; more fail with
#: EMSGSIZE), so a very wide batch is sent in slices.
_SENDMSG_IOV_CAP = 1024


class ConnectionClosedError(ConnectionError):
    """The peer closed the connection (mid-message or between messages)."""


class ProtocolError(ValueError):
    """The byte stream is not a sane framed message (an oversized header or
    frame length, a header that is not a JSON object): framing is lost and
    the connection should be closed."""


def _check_frame_len(frame_len, max_frame_bytes):
    limit = MAX_FRAME_BYTES if max_frame_bytes is None else max_frame_bytes
    if frame_len > limit:
        raise ProtocolError(
            f"Framed payload frame of {frame_len} bytes exceeds the {limit}-byte "
            "max_frame_bytes limit (desynced, corrupt, or hostile peer?) — refusing "
            "the allocation")


def _check_header_len(header_len):
    if header_len > MAX_HEADER_BYTES:
        raise ProtocolError(
            f"Framed header length {header_len} exceeds the {MAX_HEADER_BYTES}-byte "
            "header limit (desynced or non-protocol peer?)")


def _decode_header(raw):
    try:
        header = json.loads(str(raw, "utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(f"framed header is not valid JSON ({exc}) — desynced or "
                            "non-protocol peer") from exc
    if not isinstance(header, dict):
        raise ProtocolError(f"framed header decodes to {type(header).__name__}, not an "
                            "object — desynced or non-protocol peer")
    return header


class BufferPool:
    """Per-connection pool of reusable receive buffers for the fields a
    decoder consumes before the next message (the pickle head, the
    COLUMNAR meta). Data frames are never pooled: the decoded arrays keep
    them. Buffers are size-classed to powers of two (at least 64 bytes);
    at most ``max_buffers`` per class and none above ``max_pooled_bytes``
    are kept. One pool belongs to one connection's receive loop."""

    def __init__(self, max_buffers=8, max_pooled_bytes=1 << 22):
        self._free = {}
        self._max_buffers = max_buffers
        self._max_pooled_bytes = max_pooled_bytes
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _size_class(n):
        return 1 << max(6, (n - 1).bit_length())

    def acquire(self, n):
        """A ``bytearray`` of at least ``n`` bytes."""
        cls = self._size_class(n)
        bucket = self._free.get(cls)
        if bucket:
            self.hits += 1
            return bucket.pop()
        self.misses += 1
        return bytearray(cls if cls <= self._max_pooled_bytes else n)

    def release(self, buf):
        cls = self._size_class(len(buf))
        if len(buf) != cls or cls > self._max_pooled_bytes:
            return
        bucket = self._free.setdefault(cls, [])
        if len(bucket) < self._max_buffers:
            bucket.append(buf)


__all__ = ["PAYLOAD_NONE", "PAYLOAD_PICKLE", "PAYLOAD_ARROW", "PAYLOAD_COLUMNAR",
           "MAX_FRAME_BYTES", "MAX_HEADER_BYTES", "ConnectionClosedError", "ProtocolError",
           "BufferPool", "encode_payload", "decode_payload", "send_framed",
           "send_framed_frames", "recv_framed", "FramedReader", "FramedConnection",
           "close_socket", "FramedServer"]


def _is_arrow_table(payload):
    pa = sys.modules.get("pyarrow")
    return pa is not None and isinstance(payload, pa.Table)


def _columnar_frames(payload):
    """``{field: ndarray}`` → COLUMNAR frames, or ``None`` when a column
    is not an ndarray of a plain dtype (object columns; extension dtypes,
    kind ``'V'``, whose ``dtype.str`` does not round-trip)."""
    np = sys.modules.get("numpy")
    if np is None or not payload:
        return None
    for value in payload.values():
        if not isinstance(value, np.ndarray) or value.dtype.kind not in "biufcSUmM":
            return None
    meta = [[str(name), arr.dtype.str, list(arr.shape)] for name, arr in payload.items()]
    frames = [json.dumps(meta).encode("utf-8")]
    for arr in payload.values():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.kind in "mM":
            # datetime64/timedelta64 refuse the buffer protocol; a uint8
            # view exports, and the meta's dtype restores them on decode.
            arr = arr.view("u1")
        frames.append(memoryview(arr).cast("B"))
    return frames


def _decode_columnar(frames):
    """COLUMNAR frames → ``{field: ndarray}`` views over the frames."""
    import numpy as np

    meta = json.loads(bytes(frames[0]))
    if len(frames) != len(meta) + 1:
        raise ValueError(f"COLUMNAR payload carries {len(frames) - 1} column frames "
                         f"for {len(meta)} declared columns")
    return {name: np.frombuffer(frame, dtype=np.dtype(dtype)).reshape(shape)
            for (name, dtype, shape), frame in zip(meta, frames[1:])}


def _pickle_frames(payload):
    """``[head, buffer, ...]``: the protocol-5 pickle with out-of-band
    buffers, the buffers as zero-copy views of the arrays' memory."""
    buffers = []
    head = pickle.dumps(payload, protocol=5, buffer_callback=buffers.append)
    return [head] + [b.raw() for b in buffers]


def _arrow_frames(table):
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return [sink.getvalue()]


def _decode_arrow(frames):
    import pyarrow as pa

    buf = frames[0] if len(frames) == 1 else b"".join(bytes(f) for f in frames)
    with pa.ipc.open_stream(pa.BufferReader(pa.py_buffer(buf))) as reader:
        return reader.read_all()


def _encode_payload(payload):
    """payload → ``(format tag, [frame, ...])``."""
    if payload is None:
        return PAYLOAD_NONE, []
    if _is_arrow_table(payload):
        return PAYLOAD_ARROW, _arrow_frames(payload)
    if isinstance(payload, dict):
        frames = _columnar_frames(payload)
        if frames is not None:
            # The columnar serialize boundary: the decode.columnar
            # failpoint's "fallback" sends this batch as a pickle, which
            # decodes to the same arrays.
            fp = _failpoints.ACTIVE
            if fp is None or fp.fire("decode.columnar") != "fallback":
                return PAYLOAD_COLUMNAR, frames
    return PAYLOAD_PICKLE, _pickle_frames(payload)


def _decode_payload(fmt, frames):
    if fmt == PAYLOAD_NONE:
        return None
    if fmt == PAYLOAD_ARROW:
        return _decode_arrow(frames)
    if fmt == PAYLOAD_PICKLE:
        head = frames[0]
        if not isinstance(head, (bytes, bytearray, memoryview)):
            head = memoryview(head)
        # Frames this package or the JAX package's cache wrote.
        return pickle.loads(head, buffers=frames[1:])  # noqa: S301
    if fmt == PAYLOAD_COLUMNAR:
        return _decode_columnar(frames)
    raise ValueError(f"Unknown payload format tag {fmt}")


#: The names the cache imports.
encode_payload = _encode_payload
decode_payload = _decode_payload


def _recv_into_exact(sock, view, n):
    """Fill ``view[:n]`` from ``sock`` or raise :class:`ConnectionClosedError`."""
    got = 0
    while got < n:
        k = sock.recv_into(view[got:n], n - got)
        if k == 0:
            raise ConnectionClosedError(
                f"peer closed the connection ({got}/{n} bytes of the current field "
                "received)")
        got += k


def _recv_exact(sock, n):
    """Exactly ``n`` bytes as a ``bytearray`` (no ``bytes`` copy)."""
    buf = bytearray(n)
    _recv_into_exact(sock, memoryview(buf), n)
    return buf


def _sendmsg_all(sock, parts):
    """Scatter-gather send of ``parts``: one ``sendmsg`` per message in the
    common case, resumed from the first unsent byte after a short write and
    split at ``_SENDMSG_IOV_CAP`` entries."""
    views = [memoryview(p) for p in parts]
    syscalls = 0
    while views:
        sent = sock.sendmsg(views[:_SENDMSG_IOV_CAP])
        syscalls += 1
        while views and sent >= views[0].nbytes:
            sent -= views[0].nbytes
            views.pop(0)
        if sent:
            views[0] = views[0][sent:]
    _TX_SYSCALLS.inc(syscalls)


def send_framed(sock, header, payload=None):
    """Send one ``(header dict, payload)`` message on ``sock``."""
    fmt, frames = _encode_payload(payload)
    send_framed_frames(sock, header, fmt, frames)


def send_framed_frames(sock, header, fmt, frames):
    """Send one message whose payload is already encoded as frames (a cache
    entry's slices go out as they are stored)."""
    header_bytes = json.dumps(header).encode("utf-8")
    fp = _failpoints.ACTIVE
    if fp is not None and fp.fire("transport.send") == "torn":
        # A torn frame: half the length prefix reaches the peer, then the
        # connection dies (a sender crashing mid-write, the only way TCP
        # tears a frame). Shut down, not just raise: a live socket whose
        # sender swallows send errors (credit acks) would stay desynced,
        # a hang no real fault produces.
        try:
            sock.sendall(_LEN.pack(len(header_bytes))[:_LEN.size // 2])
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # an already-broken socket: the reset below still lands
        raise ConnectionResetError("failpoint transport.send: torn frame injected")
    parts = [_LEN.pack(len(header_bytes)), header_bytes, _FMT.pack(fmt),
             _NFRAMES.pack(len(frames))]
    total_bytes = len(header_bytes) + _LEN.size + _FMT.size + _NFRAMES.size
    for frame in frames:
        view = memoryview(frame)
        parts.append(_LEN.pack(view.nbytes))
        parts.append(view)
        total_bytes += _LEN.size + view.nbytes
    if hasattr(sock, "sendmsg"):
        _sendmsg_all(sock, parts)
    else:
        for part in parts:
            sock.sendall(part)
        _TX_SYSCALLS.inc(len(parts))
    _TX_MESSAGES.inc()
    _TX_FRAMES.inc(len(frames))
    _TX_BYTES.inc(total_bytes)


def recv_framed(sock, max_frame_bytes=None):
    """Receive one message as ``(header dict, payload)``, one ``recv_into``
    per field (never reads past the message). Raises
    :class:`ConnectionClosedError` when the peer hung up and
    :class:`ProtocolError` for a length past the caps, before allocating."""
    fp = _failpoints.ACTIVE
    if fp is not None:
        fp.fire("transport.recv")
    header_len = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    _check_header_len(header_len)
    header = _decode_header(_recv_exact(sock, header_len))
    fmt = _FMT.unpack(_recv_exact(sock, _FMT.size))[0]
    n_frames = _NFRAMES.unpack(_recv_exact(sock, _NFRAMES.size))[0]
    total_bytes = _LEN.size + header_len + _FMT.size + _NFRAMES.size
    frames = []
    for _ in range(n_frames):
        frame_len = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
        _check_frame_len(frame_len, max_frame_bytes)
        frames.append(_recv_exact(sock, frame_len))
        total_bytes += _LEN.size + frame_len
    _RX_MESSAGES.inc()
    _RX_FRAMES.inc(n_frames)
    _RX_BYTES.inc(total_bytes)
    return header, _decode_payload(fmt, frames)


class FramedReader:
    """The buffered receive side of one connection: few large ``recv_into``
    calls into a per-connection buffer serve the small fields, and a frame
    longer than what is buffered is received directly into its own buffer
    (the decoded arrays are views of it). Bytes read past one message
    belong to the next, so the reader owns the socket's receive side for
    the connection's lifetime."""

    #: Refill target once the connection carries a stream of batches.
    CHUNK = 1 << 18
    #: First allocation: a control connection never needs the full CHUNK.
    FIRST_CHUNK = 1 << 13

    def __init__(self, sock, pool=None, max_frame_bytes=None):
        self._sock = sock
        self._pool = pool if pool is not None else BufferPool()
        self._max_frame_bytes = max_frame_bytes
        self._buf = None
        self._view = None
        self._start = 0  # the unread region is [_start, _end)
        self._end = 0
        self._received = 0

    def _refill(self, need):
        """At least ``need`` unread bytes buffered (compacting or growing)."""
        if self._buf is None:
            self._buf = bytearray(max(self.FIRST_CHUNK, need))
            self._view = memoryview(self._buf)
        elif len(self._buf) < self.CHUNK and self._received >= 8 * len(self._buf):
            # Sustained traffic: a batch stream; grow to the full target.
            self._grow(max(self.CHUNK, need))
        if need <= self._end - self._start:
            return
        if self._start + need > len(self._buf):
            if need > len(self._buf):
                self._grow(max(need, 2 * len(self._buf)))
            else:
                self._view[:self._end - self._start] = self._view[self._start:self._end]
                self._end -= self._start
                self._start = 0
        while self._end - self._start < need:
            k = self._sock.recv_into(self._view[self._end:], len(self._buf) - self._end)
            if k == 0:
                raise ConnectionClosedError(
                    f"peer closed the connection ({self._end - self._start}/{need} bytes "
                    "of the current field received)")
            self._end += k
            self._received += k

    def _grow(self, size):
        grown = bytearray(size)
        grown[:self._end - self._start] = self._view[self._start:self._end]
        self._buf, self._view = grown, memoryview(grown)
        self._end -= self._start
        self._start = 0

    def _take(self, n):
        """A view of the next ``n`` bytes, valid until the next read."""
        self._refill(n)
        view = self._view[self._start:self._start + n]
        self._start += n
        return view

    def data_pending(self):
        """True when a read can progress without blocking on the peer."""
        return self.wait_data(0.0)

    def wait_data(self, timeout):
        """Wait up to ``timeout`` seconds for a read to be able to progress
        (buffered bytes, or bytes readable on the socket); whether it can.
        A serve loop polls this instead of parking in a timeout-less recv,
        so it can re-check its stop flag."""
        if self._end > self._start:
            return True
        import select

        readable, _, _ = select.select([self._sock], [], [], max(0.0, timeout))
        return bool(readable)

    def _read_into(self, out, n):
        """Fill ``out[:n]``: buffered bytes first, the rest received
        directly into ``out``."""
        have = min(n, self._end - self._start)
        if have:
            out[:have] = self._view[self._start:self._start + have]
            self._start += have
        if have < n:
            _recv_into_exact(self._sock, out[have:], n - have)

    def recv(self):
        """Receive one message as ``(header dict, payload)``."""
        fp = _failpoints.ACTIVE
        if fp is not None:
            fp.fire("transport.recv")
        header_len = _LEN.unpack_from(self._take(_LEN.size))[0]
        _check_header_len(header_len)
        header = _decode_header(self._take(header_len))
        meta = self._take(_FMT.size + _NFRAMES.size)
        fmt = _FMT.unpack_from(meta, 0)[0]
        n_frames = _NFRAMES.unpack_from(meta, _FMT.size)[0]
        total_bytes = _LEN.size + header_len + _FMT.size + _NFRAMES.size
        frames = []
        head_buf = None
        for i in range(n_frames):
            frame_len = _LEN.unpack_from(self._take(_LEN.size))[0]
            _check_frame_len(frame_len, self._max_frame_bytes)
            total_bytes += _LEN.size + frame_len
            if fmt in (PAYLOAD_PICKLE, PAYLOAD_COLUMNAR) and i == 0:
                # The pickle head / COLUMNAR meta: consumed by the decoder
                # and then recycled.
                head_buf = self._pool.acquire(frame_len)
                view = memoryview(head_buf)[:frame_len]
                self._read_into(view, frame_len)
                frames.append(view)
            else:
                buf = bytearray(frame_len)
                self._read_into(memoryview(buf), frame_len)
                frames.append(buf)
        payload = _decode_payload(fmt, frames)
        if head_buf is not None:
            self._pool.release(head_buf)
        _RX_MESSAGES.inc()
        _RX_FRAMES.inc(n_frames)
        _RX_BYTES.inc(total_bytes)
        return header, payload


class FramedConnection:
    """A client socket speaking framed messages, with a request/reply
    helper; its receive side is a :class:`FramedReader`."""

    #: Keepalive of long-lived batch streams: the first probe after 30 s
    #: idle, then every 10 s, dead after 6 missed probes.
    KEEPALIVE_IDLE_S = 30
    KEEPALIVE_INTERVAL_S = 10
    KEEPALIVE_COUNT = 6

    def __init__(self, sock, max_frame_bytes=None):
        self._sock = sock
        self._reader = FramedReader(sock, max_frame_bytes=max_frame_bytes)

    @classmethod
    def connect(cls, address, timeout=None, stream_timeout="same", keepalive=False,
                max_frame_bytes=None):
        """Open a TCP connection to ``(host, port)``. ``timeout`` bounds the
        dial; the socket keeps it (``stream_timeout="same"``, control
        channels) or takes ``stream_timeout`` (``None`` for batch streams,
        whose gaps have no bound). ``keepalive=True`` arms TCP keepalive
        probes, so a peer host that dies without FIN/RST surfaces as an
        ``OSError``."""
        sock = socket.create_connection(tuple(address), timeout=timeout)
        if sock.getsockname() == sock.getpeername():
            # TCP self-connect to a free port in the ephemeral range: the
            # peer is not listening.
            close_socket(sock)
            raise ConnectionRefusedError(
                f"self-connected to {tuple(address)} (peer not listening)")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if keepalive:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            for opt, value in (("TCP_KEEPIDLE", cls.KEEPALIVE_IDLE_S),
                               ("TCP_KEEPINTVL", cls.KEEPALIVE_INTERVAL_S),
                               ("TCP_KEEPCNT", cls.KEEPALIVE_COUNT)):
                if hasattr(socket, opt):
                    sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), value)
        if stream_timeout != "same":
            sock.settimeout(stream_timeout)
        return cls(sock, max_frame_bytes=max_frame_bytes)

    def send(self, header, payload=None):
        send_framed(self._sock, header, payload)

    def recv(self):
        return self._reader.recv()

    def request(self, header, payload=None):
        """Send one message and wait for the single reply."""
        self.send(header, payload)
        return self.recv()

    def close(self):
        close_socket(self._sock)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()


def close_socket(sock):
    """Shutdown and close, ignoring an already dead socket."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class FramedServer:
    """A threaded TCP server for framed services: the listener, the accept
    loop, one daemon thread and one tracked socket per connection, and
    stop-time cleanup (closing the tracked sockets unblocks handler threads
    parked in ``recv``). ``handle_connection(sock)`` serves one connection;
    :class:`ConnectionClosedError`, ``OSError`` and :class:`ProtocolError`
    from it mean the peer hung up or desynced and end the connection."""

    def __init__(self, handle_connection, host="127.0.0.1", port=0, name="framed-server"):
        self._handle_connection = handle_connection
        self._host = host
        self._port = port
        self._name = name
        self._listener = None
        self._accept_thread = None
        self._conns = set()
        self._threads = set()
        self._conns_lock = threading.Lock()
        self.stopped = threading.Event()

    def start(self):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._host, self._port))
        self._listener.listen(128)
        self._port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name=f"{self._name}-accept")
        self._accept_thread.start()
        return self

    @property
    def address(self):
        return (self._host, self._port)

    def stop(self):
        self.stopped.set()
        if self._listener is not None:
            # shutdown() before close(): close alone does not wake a thread
            # blocked in accept(), which would keep the port in LISTEN.
            close_socket(self._listener)
        if self._accept_thread is not None \
                and self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=5)
        self.close_connections()

    def close_connections(self):
        """Drop every open connection (stop-time cleanup; also a worker's
        kill-style failure injection)."""
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            close_socket(sock)

    def join(self, timeout=5.0):
        """Wait up to ``timeout`` seconds for the handler threads (after
        :meth:`stop`); returns those still alive."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._conns_lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(timeout=None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
        return [t for t in threads if t.is_alive()]

    def _accept_loop(self):
        while not self.stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # the listener was closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            thread = threading.Thread(target=self._serve, args=(conn,), daemon=True,
                                      name=f"{self._name}-conn")
            with self._conns_lock:
                self._conns.add(conn)
                self._threads.add(thread)
            thread.start()

    def _serve(self, sock):
        try:
            self._handle_connection(sock)
        except (ConnectionClosedError, OSError, ProtocolError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(sock)
                self._threads.discard(threading.current_thread())
            sock.close()
