"""Shared-memory ring transport (the port's own copy of
``petastorm_tpu/service/shm_ring.py``; the arena layout and the record
bytes are the JAX package's, so either package's consumer reads the
other's producer).

A worker and a client on one host pay TCP framing, socket syscalls and a
copy per batch for bytes that never leave the machine. This module is the
tier the negotiation (:mod:`petastorm_tpu_torch.service.transport`) moves
such a stream onto: a memfd-backed, mmap'd **ring arena** carrying the
framed messages of :mod:`petastorm_tpu_torch.reader_impl.framed_socket`,
plus a worker-wide **frame pool**, so that frames of a warm decoded-batch
cache entry (stored as one contiguous buffer) are *mapped* into the ring
as ``(offset, length)`` references instead of copied.

Layout: one arena is a 256-byte header page followed by a byte-stream
single-producer single-consumer circular data region. Header fields are
8-byte little-endian words at fixed offsets::

    0   magic "PTSHMR1\\0"      40  write_pos  (producer-owned, monotonic)
    8   version                 48  read_pos   (consumer-owned, monotonic)
    16  generation              56  consumer_waiting
    24  data_offset             64  producer_waiting
    32  data_size               72  flags (1=producer gone, 2=consumer gone)

``write_pos`` and ``read_pos`` are absolute byte counts, never wrapped, so
``write_pos - read_pos`` is the occupancy and a full ring is unambiguous.
The producer copies a whole record into the data region (wrapping at the
edge) and only then publishes it by moving ``write_pos``: the consumer
never sees a partial record. Records are ``u8 kind | u64 payload_len |
payload``:

- **kind 1 (inline)**: the payload is the byte string the TCP transport
  would have put on the wire (header JSON, format tag, frame table).
- **kind 2 (mapped)**: the frame table carries ``(pool_offset, len)``
  references into the shared frame pool instead of frame bytes (a warm
  cache hit: a few dozen bytes of offsets for a batch of megabytes).
- **kind 3 (spill)**: an ordering marker with no payload; the framed
  message follows on the paired TCP socket (it was bigger than the ring).
  The marker is committed before the TCP send, so the ring order is the
  message order.

The doorbells are two nonblocking pipes (data: producer→consumer,
space: consumer→producer), rung with an 8-byte token only when the peer
said in the header that it is waiting: under steady flow both sides find
the next record or space in shared memory and a message costs no syscall
(``petastorm_transport_syscalls_total``). A waiter publishes its flag,
re-checks the condition (so no wake-up is lost), then parks in a bounded
``select`` that also watches the paired socket, so a peer that dies
without ringing surfaces as TCP EOF within one park interval. A consumer
in another process reopens the producer's memfd and doorbells through
``/proc/<pid>/fd``: a pipe allows that, an eventfd (the JAX package's
doorbell) refuses it with ENXIO, so a JAX ring attaches only inside its
producer's process. The token is an eventfd's write, so there either
package's end rings the other's. While a trace is armed each park is a
span: ``shm.park`` (the consumer waits for a record) and
``shm.wait_space`` (the producer waits for room).

Failures read as on TCP: a vanished producer is
:class:`ConnectionClosedError` (after every committed record was drained,
so a clean ``end`` is never lost to the close after it), a desynced or
fenced arena is :class:`ProtocolError`; both reach the client's
broken-stream recovery. Three failpoints are compiled into the producer
(``shm-detach``, ``torn-doorbell``, ``stale-arena``;
:data:`petastorm_tpu_torch.failpoints.POINTS`).

Every live mapping and doorbell fd is counted here
(:func:`live_shm_counts`), and the memfd names carry the ``ptshm``
prefix, so a leak guard that scans ``/proc/self/fd`` finds an orphaned
arena of either package.
"""

from __future__ import annotations

import errno
import gc
import json
import mmap
import os
import select
import socket
import struct
import tempfile
import threading
import time

import numpy as np

from petastorm_tpu_torch import failpoints as _failpoints
from petastorm_tpu_torch.reader_impl.framed_socket import (
    _FMT,
    _LEN,
    _NFRAMES,
    ConnectionClosedError,
    ProtocolError,
    _check_header_len,
    _decode_header,
    _decode_payload,
    _encode_payload,
    send_framed_frames,
)
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.log import service_logger
from petastorm_tpu_torch.telemetry.metrics import (
    SHM_ARENAS,
    SHM_FRAMES,
    TRANSPORT_BYTES,
    TRANSPORT_FRAMES,
    TRANSPORT_MESSAGES,
    TRANSPORT_SYSCALLS,
)

logger = service_logger(__name__)

# Interned children (one lock-guarded add per message, no dict lookup) —
# the shm-tier counterparts of framed_socket's tcp children.
_TX_MESSAGES = TRANSPORT_MESSAGES.labels("sent", "shm")
_TX_FRAMES = TRANSPORT_FRAMES.labels("sent", "shm")
_TX_BYTES = TRANSPORT_BYTES.labels("sent", "shm")
_RX_MESSAGES = TRANSPORT_MESSAGES.labels("recv", "shm")
_RX_FRAMES = TRANSPORT_FRAMES.labels("recv", "shm")
_RX_BYTES = TRANSPORT_BYTES.labels("recv", "shm")
_SYSCALLS = TRANSPORT_SYSCALLS.labels("shm")
_FRAMES_MAPPED = SHM_FRAMES.labels("mapped")
_FRAMES_COPIED = SHM_FRAMES.labels("copied")
_FRAMES_SPILLED = SHM_FRAMES.labels("spilled")
_ARENAS_RING = SHM_ARENAS.labels("ring")
_ARENAS_POOL = SHM_ARENAS.labels("pool")

_MAGIC = b"PTSHMR1\0"
_VERSION = 1
_HEADER_BYTES = 256
_OFF_MAGIC = 0
_OFF_VERSION = 8
_OFF_GENERATION = 16
_OFF_DATA_OFFSET = 24
_OFF_DATA_SIZE = 32
_OFF_WRITE_POS = 40
_OFF_READ_POS = 48
_OFF_CONSUMER_WAITING = 56
_OFF_PRODUCER_WAITING = 64
_OFF_FLAGS = 72

FLAG_PRODUCER_DETACHED = 1
FLAG_CONSUMER_DETACHED = 2

_U64 = struct.Struct("<Q")
_REC = struct.Struct("<BQ")       # record prefix: kind, payload length
_POOL_REF = struct.Struct("!QQ")  # mapped frame reference: offset, length

REC_INLINE = 1
REC_MAPPED = 2
REC_SPILL = 3

#: Default ring data-region size. Big enough that typical collated batch
#: messages (tens of KB to ~1 MB) ride inline or mapped; anything larger
#: spills to the paired socket behind an ordering marker.
DEFAULT_RING_BYTES = int(os.environ.get("PETASTORM_SHM_RING_BYTES",
                                        4 * 1024 * 1024))
#: Default worker-global frame pool size (backs mapped cache serves).
DEFAULT_POOL_BYTES = int(os.environ.get("PETASTORM_SHM_POOL_BYTES",
                                        32 * 1024 * 1024))
#: Copies of at least this many bytes go through numpy, which releases the
#: GIL while it copies and while a fresh destination's pages fault in: the
#: other end of a ring in the same process, and the trainer, run meanwhile
#: (a socket's send and receive copy in the kernel, also without the GIL).
#: Smaller copies are slice assignments.
_BULK_COPY_BYTES = 1 << 16
#: Bounded-park interval: a waiter re-checks peer liveness (TCP EOF,
#: detach flags) at least this often even if every doorbell is lost.
_PARK_S = 0.2

memfd_name_prefix = "ptshm"


class ShmSetupError(OSError):
    """Arena/pool creation failed (memfd unavailable, shm exhaustion).
    The negotiation layer downgrades the stream to TCP — never errors it."""


class ShmAttachError(OSError):
    """The consumer could not attach an offered arena (container
    boundary, dead producer, fd-reopen refused). The client nacks the
    offer and the stream proceeds over TCP."""


# ---------------------------------------------------------------------------
# the live-resource registry (what a leak guard reads)

_LIVE_LOCK = threading.Lock()
_LIVE = {"rings": 0, "pools": 0, "eventfds": 0}


def live_shm_counts():
    """Snapshot of live shm resources in this process: mapped ring ends
    (producer and consumer each count one), mapped pools, and open
    doorbells (``eventfds``, the JAX package's key: two a ring end). All
    zero between tests; anything else is a leak."""
    with _LIVE_LOCK:
        return dict(_LIVE)


def _register(key, n=1):
    with _LIVE_LOCK:
        _LIVE[key] += n
    if key == "rings":
        _ARENAS_RING.inc(n)
    elif key == "pools":
        _ARENAS_POOL.inc(n)


def _deregister(key, n=1):
    with _LIVE_LOCK:
        _LIVE[key] -= n
    if key == "rings":
        _ARENAS_RING.dec(n)
    elif key == "pools":
        _ARENAS_POOL.dec(n)


# ---------------------------------------------------------------------------
# arena plumbing

def _create_shm_fd(name, size):
    """A pre-faulted shared-memory fd of ``size`` bytes, or
    :class:`ShmSetupError`. memfd first (name-scoped so the leak guard
    can spot orphans in /proc/self/fd; not subject to the /dev/shm mount
    cap); an unlinked /dev/shm tempfile as the fallback. Pre-faulting
    writes every page NOW so tmpfs exhaustion surfaces here as a
    catchable setup error — not later as SIGBUS on a lazy first touch
    mid-stream."""
    fd = None
    try:
        fd = os.memfd_create(f"{memfd_name_prefix}-{name}")
    except (AttributeError, OSError) as exc:
        try:
            tmp = tempfile.NamedTemporaryFile(
                prefix=f"{memfd_name_prefix}-{name}-", dir="/dev/shm",
                delete=False)
        except OSError:
            raise ShmSetupError(
                f"no shared-memory backing available (memfd_create: "
                f"{exc})") from exc
        fd = os.dup(tmp.file.fileno())
        tmp.file.close()
        try:
            os.unlink(tmp.name)
        except OSError:
            logger.warning("could not unlink shm fallback file %s",
                           tmp.name)
    try:
        os.ftruncate(fd, size)
        chunk = b"\0" * min(size, 1 << 20)
        off = 0
        while off < size:
            off += os.pwrite(fd, chunk[:min(len(chunk), size - off)], off)
    except OSError as exc:
        os.close(fd)
        raise ShmSetupError(
            f"could not pre-fault {size}-byte shm arena "
            f"({errno.errorcode.get(exc.errno, exc.errno)}: {exc}) — "
            f"shared memory exhausted?") from exc
    return fd


def _reopen_fd(pid, fd, nonblock=False):
    """A local fd for a peer's fd: same process → dup; otherwise reopen
    through /proc (works for memfds and pipes, not for eventfds, when the
    peer is truly on this host and not behind a container/pidns
    boundary)."""
    if pid == os.getpid():
        return os.dup(fd)
    flags = os.O_RDWR | (os.O_NONBLOCK if nonblock else 0)
    return os.open(f"/proc/{pid}/fd/{fd}", flags)


def _close_fd_quiet(fd):
    try:
        os.close(fd)
    except OSError:
        pass


def _shutdown_quiet(sock):
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _close_mmap(mm, what):
    """Close ``mm``, absorbing lingering buffer exports: collect and
    retry once; an export that survives (a frame still referenced
    somewhere) downgrades to a logged leak-until-exit rather than a
    crash. Returns whether the mapping actually closed."""
    try:
        mm.close()
        return True
    except BufferError:
        gc.collect()
        try:
            mm.close()
            return True
        except BufferError:
            logger.warning(
                "%s mmap still has exported buffers at close; leaving "
                "the mapping to process exit", what)
            return False


def _sock_eof(sock):
    """Nonblocking peek: has the peer closed its end? (False on plain
    'no data yet'; True on EOF or a reset — both mean the peer is gone.)"""
    try:
        return sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
    except (BlockingIOError, InterruptedError):
        return False
    except OSError:
        return True


def _eventfd_drain(efd):
    """Clear a doorbell: every pending token of a pipe, the counter of an
    eventfd (which reads as one 8-byte word)."""
    try:
        os.read(efd, 4096)
    except (BlockingIOError, InterruptedError):
        pass
    except OSError:
        pass  # closed under us during teardown


class _Arena:
    """One mapped arena end (producer or consumer): the mmap, the header
    accessors, and wrap-aware data-region copies."""

    def __init__(self, mm, size):
        self.mm = mm
        self.size = size
        self.data_offset = self.get(_OFF_DATA_OFFSET)
        self.data_size = self.get(_OFF_DATA_SIZE)
        if (self.data_offset != _HEADER_BYTES
                or self.data_offset + self.data_size != size):
            raise ProtocolError(
                f"shm arena geometry is inconsistent (data_offset="
                f"{self.data_offset}, data_size={self.data_size}, "
                f"mapped={size})")

    def get(self, off):
        return _U64.unpack_from(self.mm, off)[0]

    def put(self, off, value):
        _U64.pack_into(self.mm, off, value)

    def _spans(self, pos, n):
        """The one or two ``(arena offset, length)`` spans that hold ``n``
        stream bytes from absolute position ``pos`` (wrapping)."""
        rel = pos % self.data_size
        first = min(n, self.data_size - rel)
        spans = [(self.data_offset + rel, first)]
        if first < n:
            spans.append((self.data_offset, n - first))
        return spans

    def copy_in(self, pos, buf):
        """Write ``buf`` at absolute stream position ``pos`` (wrapping);
        returns the next absolute position."""
        view = memoryview(buf).cast("B") if not isinstance(buf, bytes) \
            else buf
        done = 0
        for start, length in self._spans(pos, len(view)):
            if length >= _BULK_COPY_BYTES:
                np.copyto(np.frombuffer(self.mm, np.uint8, length, start),
                          np.frombuffer(view, np.uint8, length, done))
            else:
                self.mm[start:start + length] = view[done:done + length]
            done += length
        return pos + done

    def copy_out(self, pos, n):
        """Read ``n`` bytes at absolute stream position ``pos`` (wrapping)
        into a fresh writable buffer: a bytearray, or from
        ``_BULK_COPY_BYTES`` on a uint8 ndarray."""
        done = 0
        if n < _BULK_COPY_BYTES:
            out = bytearray(n)
            with memoryview(out) as dst, memoryview(self.mm) as src:
                for start, length in self._spans(pos, n):
                    dst[done:done + length] = src[start:start + length]
                    done += length
            return out
        out = np.empty(n, np.uint8)
        for start, length in self._spans(pos, n):
            np.copyto(out[done:done + length],
                      np.frombuffer(self.mm, np.uint8, length, start))
            done += length
        return out


class RingProducer:
    """The worker-side end of one stream's ring: creates the arena and
    doorbells, exposes the framed ``send``/``send_frames`` interface, and
    carries the three shm failpoints. One producer per stream, driven by
    one serve thread."""

    def __init__(self, sock, pool=None, data_size=None):
        data_size = DEFAULT_RING_BYTES if data_size is None else data_size
        total = _HEADER_BYTES + data_size
        fd = _create_shm_fd("ring", total)
        try:
            data_r, data_w = os.pipe2(os.O_NONBLOCK | os.O_CLOEXEC)
        except OSError as exc:
            _close_fd_quiet(fd)
            raise ShmSetupError(f"doorbell pipe unavailable ({exc})") from exc
        try:
            space_r, space_w = os.pipe2(os.O_NONBLOCK | os.O_CLOEXEC)
        except OSError as exc:
            for f in (fd, data_r, data_w):
                _close_fd_quiet(f)
            raise ShmSetupError(f"doorbell pipe unavailable ({exc})") from exc
        doorbells = (data_r, data_w, space_r, space_w)
        try:
            mm = mmap.mmap(fd, total)
        except (OSError, ValueError) as exc:
            for f in (fd,) + doorbells:
                _close_fd_quiet(f)
            raise ShmSetupError(f"could not map ring arena ({exc})") \
                from exc
        mm[_OFF_MAGIC:_OFF_MAGIC + len(_MAGIC)] = _MAGIC
        for off, value in ((_OFF_VERSION, _VERSION),
                           (_OFF_GENERATION, 1),
                           (_OFF_DATA_OFFSET, _HEADER_BYTES),
                           (_OFF_DATA_SIZE, data_size),
                           (_OFF_WRITE_POS, 0), (_OFF_READ_POS, 0),
                           (_OFF_CONSUMER_WAITING, 0),
                           (_OFF_PRODUCER_WAITING, 0), (_OFF_FLAGS, 0)):
            _U64.pack_into(mm, off, value)
        self._arena = _Arena(mm, total)
        self._fd = fd
        # The consumer's ends (the read end of data, the write end of
        # space) stay open here until close: a consumer in another process
        # reopens them from this process's fd table.
        self._doorbells = doorbells
        self._efd_data = data_w
        self._efd_space = space_r
        self._sock = sock
        self._pool = pool
        self._write_pos = 0
        self._generation = 1
        self._closed = False
        self.transport = "shm"
        _register("rings")
        _register("eventfds", 2)

    def descriptor(self):
        """What the ``shm_offer`` message carries: everything a colocated
        consumer needs to attach (fds are reopened via /proc when the
        consumer is another process)."""
        return {"pid": os.getpid(), "fd": self._fd,
                "efd_data": self._doorbells[0],
                "efd_space": self._doorbells[3],
                "size": self._arena.size,
                "data_size": self._arena.data_size,
                "generation": self._generation}

    def drop_pool(self):
        """Stop emitting mapped (pool-reference) records: the negotiation
        layer calls this when the consumer acked the ring but could not
        attach the frame pool — every frame then travels inline, which is
        correct (just copied) for any consumer."""
        self._pool = None

    # -- framed send interface ------------------------------------------

    def send(self, header, payload=None):
        fmt, frames = _encode_payload(payload)
        self.send_frames(header, fmt, frames)

    def send_frames(self, header, fmt, frames):
        if self._closed:
            raise ConnectionClosedError("shm ring producer is closed")
        fp = _failpoints.ACTIVE
        if fp is not None:  # disarmed cost: one global load + None branch
            self._inject(fp)
        header_bytes = json.dumps(header).encode("utf-8")
        refs = None
        if self._pool is not None and frames:
            refs = self._pool.locate(frames)
        if refs is not None:
            self._send_mapped(header_bytes, fmt, frames, refs)
        else:
            self._send_inline(header, header_bytes, fmt, frames)

    def _send_mapped(self, header_bytes, fmt, frames, refs):
        parts = [_LEN.pack(len(header_bytes)), header_bytes,
                 _FMT.pack(fmt), _NFRAMES.pack(len(refs))]
        frame_bytes = 0
        for off, length in refs:
            parts.append(_POOL_REF.pack(off, length))
            frame_bytes += length
        payload_len = sum(len(p) for p in parts)
        self._append(REC_MAPPED, parts, payload_len)
        _TX_MESSAGES.inc()
        _TX_FRAMES.inc(len(refs))
        _TX_BYTES.inc(payload_len + frame_bytes)
        _FRAMES_MAPPED.inc(len(refs))

    def _send_inline(self, header, header_bytes, fmt, frames):
        views = [memoryview(f) for f in frames]
        parts = [_LEN.pack(len(header_bytes)), header_bytes,
                 _FMT.pack(fmt), _NFRAMES.pack(len(views))]
        payload_len = sum(len(p) for p in parts)
        for view in views:
            parts.append(_LEN.pack(view.nbytes))
            parts.append(view)
            payload_len += _LEN.size + view.nbytes
        if _REC.size + payload_len > self._arena.data_size:
            # Bigger than the ring can ever hold: spill to the paired
            # socket. The marker is committed BEFORE the socket send so
            # the consumer's ring order is the message order.
            self._append(REC_SPILL, (), 0)
            send_framed_frames(self._sock, header, fmt, frames)
            _FRAMES_SPILLED.inc(len(views))
            return
        self._append(REC_INLINE, parts, payload_len)
        _TX_MESSAGES.inc()
        _TX_FRAMES.inc(len(views))
        _TX_BYTES.inc(payload_len)
        _FRAMES_COPIED.inc(len(views))

    def _append(self, kind, parts, payload_len):
        needed = _REC.size + payload_len
        self._wait_space(needed)
        pos = self._arena.copy_in(self._write_pos,
                                  _REC.pack(kind, payload_len))
        for part in parts:
            pos = self._arena.copy_in(pos, part)
        self._write_pos = pos
        self._arena.put(_OFF_WRITE_POS, pos)
        if self._arena.get(_OFF_CONSUMER_WAITING):
            self._ring(self._efd_data)

    def _ring(self, efd):
        try:
            os.eventfd_write(efd, 1)
            _SYSCALLS.inc()
        except OSError:
            pass  # peer-side teardown race: the flags/EOF checks govern

    def _wait_space(self, needed):
        arena = self._arena
        while True:
            if self._closed:
                raise ConnectionClosedError("shm ring producer is closed")
            if arena.get(_OFF_FLAGS) & FLAG_CONSUMER_DETACHED:
                raise ConnectionClosedError(
                    "shm ring consumer detached")
            free = arena.data_size - (self._write_pos
                                      - arena.get(_OFF_READ_POS))
            if free >= needed:
                return
            arena.put(_OFF_PRODUCER_WAITING, 1)
            try:
                free = arena.data_size - (self._write_pos
                                          - arena.get(_OFF_READ_POS))
                if free >= needed:
                    continue
                t0 = time.perf_counter()
                try:
                    readable, _, _ = select.select(
                        [self._efd_space], [], [], _PARK_S)
                except (OSError, ValueError):
                    raise ConnectionClosedError(
                        "shm ring doorbell closed while waiting for "
                        "space") from None
                _SYSCALLS.inc()
                if tracing.COLLECTOR.enabled:
                    tracing.COLLECTOR.record_span("shm.wait_space", t0,
                                                  time.perf_counter())
                if readable:
                    _eventfd_drain(self._efd_space)
                    _SYSCALLS.inc()
                elif _sock_eof(self._sock):
                    raise ConnectionClosedError(
                        "peer closed the paired socket while the shm "
                        "ring was full")
            finally:
                arena.put(_OFF_PRODUCER_WAITING, 0)

    # -- failpoints ------------------------------------------------------

    def _inject(self, fp):
        if fp.fire("shm-detach") == "detach":
            self._arena.put(
                _OFF_FLAGS,
                self._arena.get(_OFF_FLAGS) | FLAG_PRODUCER_DETACHED)
            self._ring(self._efd_data)
            _shutdown_quiet(self._sock)
            raise ConnectionResetError(
                "failpoint shm-detach: producer detached mid-stream")
        if fp.fire("torn-doorbell") == "torn":
            # A garbage record header is published — the shm analogue of
            # a torn TCP length prefix. The consumer must refuse it as a
            # protocol error; the socket reset makes the damage
            # two-sided, as a real producer crash would.
            free = self._arena.data_size - (
                self._write_pos - self._arena.get(_OFF_READ_POS))
            if free >= _REC.size:
                pos = self._arena.copy_in(
                    self._write_pos, _REC.pack(0xFF, (1 << 63) + 1))
                self._write_pos = pos
                self._arena.put(_OFF_WRITE_POS, pos)
            self._ring(self._efd_data)
            _shutdown_quiet(self._sock)
            raise ConnectionResetError(
                "failpoint torn-doorbell: garbage record committed")
        if fp.fire("stale-arena") == "stale":
            self._arena.put(_OFF_GENERATION, self._generation + 1)
            self._ring(self._efd_data)
            _shutdown_quiet(self._sock)
            raise ConnectionResetError(
                "failpoint stale-arena: arena generation fenced")

    def close(self):
        """Detach: raise the producer-gone flag, ring the doorbell so a
        parked consumer wakes to drain what is committed, then release
        the mapping and fds. Never tears down the paired socket — the
        connection owner does that."""
        if self._closed:
            return
        self._closed = True
        try:
            self._arena.put(
                _OFF_FLAGS,
                self._arena.get(_OFF_FLAGS) | FLAG_PRODUCER_DETACHED)
            self._ring(self._efd_data)
        except (OSError, ValueError):
            logger.warning("shm ring producer flag/doorbell write failed "
                           "at close", exc_info=True)
        _close_mmap(self._arena.mm, "ring producer")
        for fd in (self._fd,) + self._doorbells:
            _close_fd_quiet(fd)
        _deregister("rings")
        _deregister("eventfds", 2)


class RingConsumer:
    """The client-side end: attaches a producer's descriptor and exposes
    the framed ``recv`` interface. One consumer per stream, driven by one
    reader thread. ``reader`` is the connection's FramedReader — spilled
    messages are received through it so its buffered bytes stay coherent."""

    def __init__(self, descriptor, sock, reader):
        self._sock = sock
        self._reader = reader
        pid = int(descriptor["pid"])
        fds = []
        try:
            self._fd = _reopen_fd(pid, int(descriptor["fd"]))
            fds.append(self._fd)
            self._efd_data = _reopen_fd(pid, int(descriptor["efd_data"]),
                                        nonblock=True)
            fds.append(self._efd_data)
            self._efd_space = _reopen_fd(pid, int(descriptor["efd_space"]),
                                         nonblock=True)
            fds.append(self._efd_space)
            mm = mmap.mmap(self._fd, int(descriptor["size"]))
        except (OSError, ValueError) as exc:
            for fd in fds:
                _close_fd_quiet(fd)
            raise ShmAttachError(
                f"could not attach shm arena from pid {pid} ({exc})") \
                from exc
        if mm[_OFF_MAGIC:_OFF_MAGIC + len(_MAGIC)] != _MAGIC:
            mm.close()
            for fd in fds:
                _close_fd_quiet(fd)
            raise ShmAttachError("attached arena has no ring magic")
        try:
            self._arena = _Arena(mm, int(descriptor["size"]))
        except ProtocolError as exc:
            mm.close()
            for fd in fds:
                _close_fd_quiet(fd)
            raise ShmAttachError(str(exc)) from exc
        self._generation = int(descriptor["generation"])
        self._read_pos = self._arena.get(_OFF_READ_POS)
        self._pool = None
        self._closed = False
        self.transport = "shm"
        _register("rings")
        _register("eventfds", 2)

    def attach_pool(self, pool):
        """Arm the mapped-record path with an attached FramePool (or
        leave unattached: mapped records then fail as protocol errors,
        which negotiation prevents by ack'ing ``pool: false``)."""
        self._pool = pool

    # -- framed recv interface ------------------------------------------

    def recv(self, timeout=None):
        """Receive one framed message → ``(header dict, payload)`` —
        same contract (and exception vocabulary) as FramedReader.recv."""
        deadline = None if timeout is None else time.monotonic() + timeout
        empty_sock_strikes = 0
        while True:
            if self._closed:
                raise ConnectionClosedError("shm ring consumer is closed")
            gen = self._arena.get(_OFF_GENERATION)
            if gen != self._generation:
                raise ProtocolError(
                    f"shm arena generation moved {self._generation} → "
                    f"{gen} under the stream (stale arena) — the mapping "
                    f"is fenced")
            record = self._try_pop()
            if record is not None:
                kind, pos, payload_len = record
                try:
                    if kind != REC_SPILL:
                        header, fmt, frames, total_bytes = self._copy_record(
                            kind, pos, payload_len)
                finally:
                    self._release(pos + payload_len)
                if kind == REC_SPILL:
                    return self._reader.recv()
                result = _decode_payload(fmt, frames)
                _RX_MESSAGES.inc()
                _RX_FRAMES.inc(len(frames))
                _RX_BYTES.inc(total_bytes)
                return header, result
            if self._arena.get(_OFF_FLAGS) & FLAG_PRODUCER_DETACHED:
                raise ConnectionClosedError(
                    "shm ring producer detached (every committed record "
                    "was drained first)")
            if deadline is not None and time.monotonic() >= deadline:
                raise socket.timeout("timed out waiting on the shm ring")
            empty_sock_strikes = self._park(deadline, empty_sock_strikes)

    def _park(self, deadline, strikes):
        """Publish the waiting flag, re-check, park in a bounded select
        on the doorbell + the paired socket. Returns the updated
        consecutive count of 'socket readable but ring empty' wakeups —
        a few in a row mean bytes arrived with no marker committed
        first, which no healthy producer can produce."""
        arena = self._arena
        arena.put(_OFF_CONSUMER_WAITING, 1)
        try:
            if arena.get(_OFF_WRITE_POS) != self._read_pos \
                    or arena.get(_OFF_FLAGS) & FLAG_PRODUCER_DETACHED \
                    or arena.get(_OFF_GENERATION) != self._generation:
                return 0
            wait = _PARK_S if deadline is None \
                else max(0.0, min(_PARK_S, deadline - time.monotonic()))
            t0 = time.perf_counter()
            try:
                readable, _, _ = select.select(
                    [self._efd_data, self._sock], [], [], wait)
            except (OSError, ValueError):
                raise ConnectionClosedError(
                    "shm ring doorbell or paired socket closed while "
                    "waiting for data") from None
            if tracing.COLLECTOR.enabled:
                tracing.COLLECTOR.record_span("shm.park", t0,
                                              time.perf_counter())
            if not readable:
                return 0
            if self._efd_data in readable:
                _eventfd_drain(self._efd_data)
                return 0
            # Socket readable with (apparently) nothing in the ring:
            # either EOF (peer gone — drain, then the caller raises), or
            # a spill marker that became visible between our check and
            # the select (benign), or a true desync.
            if arena.get(_OFF_WRITE_POS) != self._read_pos:
                return 0
            if _sock_eof(self._sock):
                if arena.get(_OFF_WRITE_POS) == self._read_pos:
                    raise ConnectionClosedError(
                        "peer closed the paired socket with the shm "
                        "ring drained")
                return 0
            strikes += 1
            if strikes >= 3:
                raise ProtocolError(
                    "bytes arrived on the spill socket with no marker "
                    "committed to the shm ring — desynced producer")
            time.sleep(0.005)
            return strikes
        finally:
            arena.put(_OFF_CONSUMER_WAITING, 0)

    def _try_pop(self):
        """The next committed record as ``(kind, payload position,
        payload length)``, or ``None`` — never blocks. Validates the
        record header against the committed region: a kind outside the
        vocabulary or a length beyond what the producer published is a
        desync (the torn-doorbell failure mode). The record's bytes stay
        in the ring until :meth:`_release`."""
        arena = self._arena
        write_pos = arena.get(_OFF_WRITE_POS)
        avail = write_pos - self._read_pos
        if avail == 0:
            return None
        if avail > arena.data_size or avail < _REC.size:
            raise ProtocolError(
                f"shm ring positions desynced (write_pos={write_pos}, "
                f"read_pos={self._read_pos}, data_size="
                f"{arena.data_size})")
        kind, payload_len = _REC.unpack(
            bytes(arena.copy_out(self._read_pos, _REC.size)))
        if kind not in (REC_INLINE, REC_MAPPED, REC_SPILL) \
                or _REC.size + payload_len > avail:
            raise ProtocolError(
                f"shm ring record header is garbage (kind={kind}, "
                f"payload_len={payload_len}, committed={avail}) — torn "
                f"producer write")
        return kind, self._read_pos + _REC.size, payload_len

    def _release(self, end):
        """Hand the ring up to stream position ``end`` back to the
        producer, waking it if it waits for space."""
        arena = self._arena
        self._read_pos = end
        arena.put(_OFF_READ_POS, end)
        if arena.get(_OFF_PRODUCER_WAITING):
            try:
                os.eventfd_write(self._efd_space, 1)
            except OSError:
                pass  # producer-side teardown race

    def _copy_record(self, kind, pos, payload_len):
        """``(header, fmt, frames, bytes)`` of the record at ``pos``:
        each frame copied once, straight from the ring (inline) or the
        pool (mapped), into a buffer of its own."""
        arena = self._arena
        end = pos + payload_len

        def field(st):
            nonlocal pos
            if pos + st.size > end:
                raise ProtocolError(
                    f"shm record payload truncated (a {st.size}-byte field "
                    f"at {pos - end + payload_len} of {payload_len}) — torn "
                    f"producer write")
            value = st.unpack(bytes(arena.copy_out(pos, st.size)))
            pos += st.size
            return value

        header_len = field(_LEN)[0]
        _check_header_len(header_len)
        if pos + header_len > end:
            raise ProtocolError(
                "shm record header overruns its payload — torn producer "
                "write")
        header = _decode_header(bytes(arena.copy_out(pos, header_len)))
        pos += header_len
        fmt = field(_FMT)[0]
        n_frames = field(_NFRAMES)[0]
        frames = []
        total_bytes = pos - (end - payload_len)
        if kind == REC_INLINE:
            for _ in range(n_frames):
                frame_len = field(_LEN)[0]
                if pos + frame_len > end:
                    raise ProtocolError(
                        "shm inline record frame overruns its payload — "
                        "torn producer write")
                # Each frame keeps TCP's writable-private-buffer
                # semantics: out-of-band reconstruction may hand it to a
                # numpy array the trainer mutates.
                frames.append(arena.copy_out(pos, frame_len))
                pos += frame_len
                total_bytes += _LEN.size + frame_len
        else:  # REC_MAPPED: (pool offset, length) references
            if self._pool is None:
                raise ProtocolError(
                    "mapped shm record but no frame pool attached — "
                    "negotiation desync")
            for _ in range(n_frames):
                off, frame_len = field(_POOL_REF)
                frames.append(self._pool.read(off, frame_len))
                total_bytes += frame_len
        return header, fmt, frames, total_bytes

    def close(self):
        """Detach: raise the consumer-gone flag (waking a producer parked
        on space), release the mapping and fds."""
        if self._closed:
            return
        self._closed = True
        try:
            self._arena.put(
                _OFF_FLAGS,
                self._arena.get(_OFF_FLAGS) | FLAG_CONSUMER_DETACHED)
            os.eventfd_write(self._efd_space, 1)
        except (OSError, ValueError):
            pass  # producer already gone: nothing to wake
        _close_mmap(self._arena.mm, "ring consumer")
        for fd in (self._fd, self._efd_data, self._efd_space):
            _close_fd_quiet(fd)
        _deregister("rings")
        _deregister("eventfds", 2)


class FramePool:
    """A worker-global shared-memory bump allocator for pre-serialized
    frame bytes. The decoded-batch cache routes entry buffers through
    :meth:`allocate`, so a warm hit's frames already live in shared
    memory and the ring publishes them as ``(offset, len)`` references —
    the mapped-serve path. Allocation is bump-only (no free): offsets
    handed to a consumer stay valid for the pool's lifetime, which is
    what makes the references safe without cross-process refcounting. A
    full pool degrades new entries to heap buffers (served inline), never
    errors."""

    def __init__(self, size=None, _attach=None):
        self._lock = threading.Lock()
        if _attach is None:
            self.size = DEFAULT_POOL_BYTES if size is None else int(size)
            self._fd = _create_shm_fd("pool", self.size)
            try:
                self._mm = mmap.mmap(self._fd, self.size)
            except (OSError, ValueError) as exc:
                _close_fd_quiet(self._fd)
                raise ShmSetupError(
                    f"could not map frame pool ({exc})") from exc
            self._owner = True
        else:
            pid, fd, self.size = _attach
            try:
                self._fd = _reopen_fd(pid, fd)
            except OSError as exc:
                raise ShmAttachError(
                    f"could not reopen frame pool fd from pid {pid} "
                    f"({exc})") from exc
            try:
                self._mm = mmap.mmap(self._fd, self.size)
            except (OSError, ValueError) as exc:
                _close_fd_quiet(self._fd)
                raise ShmAttachError(
                    f"could not map frame pool ({exc})") from exc
            self._owner = False
        self._mv = memoryview(self._mm)
        arr = np.frombuffer(self._mm, dtype=np.uint8)
        self._base = int(arr.__array_interface__["data"][0])
        del arr
        self._bump = 0
        self._closed = False
        _register("pools")

    @classmethod
    def attach(cls, descriptor):
        """Consumer-side attach from a producer's :meth:`descriptor`."""
        return cls(_attach=(int(descriptor["pid"]),
                            int(descriptor["fd"]),
                            int(descriptor["size"])))

    def descriptor(self):
        return {"pid": os.getpid(), "fd": self._fd, "size": self.size}

    def allocate(self, nbytes):
        """A writable memoryview of ``nbytes`` pool bytes, or ``None``
        when the pool is exhausted (bump-only — the caller degrades to a
        heap buffer). This is the cache's frame-allocator hook."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return None
        with self._lock:
            if self._closed or self._bump + nbytes > self.size:
                return None
            offset = self._bump
            self._bump = (self._bump + nbytes + 7) & ~7  # 8-byte align
            return self._mv[offset:offset + nbytes]

    def locate(self, frames):
        """``[(offset, len), ...]`` when EVERY frame's bytes live inside
        this pool, else ``None`` (one foreign frame makes the whole
        message inline — a mixed record would still copy, for no win).
        Detection is by address: frames served from a pool-backed cache
        entry are memoryview slices of this very mapping."""
        refs = []
        base, top = self._base, self._base + self.size
        for frame in frames:
            view = memoryview(frame)
            if view.nbytes == 0:
                refs.append((0, 0))
                continue
            if not view.c_contiguous:
                return None
            addr = int(np.frombuffer(view.cast("B"), dtype=np.uint8)
                       .__array_interface__["data"][0])
            if not (base <= addr and addr + view.nbytes <= top):
                return None
            refs.append((addr - base, view.nbytes))
        return refs

    def read(self, offset, nbytes):
        """A private writable copy of pool bytes (consumer side): the
        delivered batch must tolerate in-place trainer mutation without
        corrupting the producer's cache entry."""
        if offset + nbytes > self.size:
            raise ProtocolError(
                f"mapped frame reference ({offset}+{nbytes}) overruns "
                f"the {self.size}-byte pool")
        if nbytes < _BULK_COPY_BYTES:
            return bytearray(self._mv[offset:offset + nbytes])
        out = np.empty(nbytes, np.uint8)
        np.copyto(out, np.frombuffer(self._mm, np.uint8, nbytes, offset))
        return out

    def used_bytes(self):
        with self._lock:
            return self._bump

    def close(self):
        if self._closed:
            return
        with self._lock:
            self._closed = True
        self._mv.release()
        _close_mmap(self._mm, "frame pool")
        _close_fd_quiet(self._fd)
        _deregister("pools")
