"""Transport negotiation: shared memory or TCP, per stream (the port's own
copy of ``petastorm_tpu/service/transport.py``; the negotiation frames are
the JAX package's, so a port worker and a JAX client negotiate with each
other).

The framed TCP tier works everywhere; the shared-memory ring
(:mod:`petastorm_tpu_torch.service.shm_ring`) works only when worker and
client share a host. This module decides, per ``stream`` request, which
one a stream rides, and turns every failure on the shm path into a silent
downgrade to TCP, never a stream error.

Negotiation (every control frame rides the TCP connection):

1. The client's ``stream`` request carries a ``transport`` advertisement,
   ``{"modes": ["shm"], "host": <host token>, "pid": n}``, when its mode
   allows shm. No advertisement (a ``"tcp"`` client): the worker serves
   TCP.
2. The worker compares host tokens (the same boot of the same machine).
   On a match it builds a :class:`~petastorm_tpu_torch.service.shm_ring.
   RingProducer` and replies ``shm_offer`` with the ring's descriptor
   (and the frame pool's, when one is armed). An arena that cannot be set
   up is counted in ``petastorm_transport_downgrades_total{reason=
   "arena_setup"}`` and the stream serves TCP on the same request.
3. The client attaches and replies ``shm_ack`` (``ok`` and whether the
   pool attached); an attach failure nacks (``ok: false``) and the worker
   downgrades (``reason="client_nack"``), again on the same request.
   Control frames the client sent before the ack (credits, dynamic
   ``extend`` edits) are buffered by the worker's ack wait and replayed
   into the stream, so the credit window survives negotiation.
4. From the offer on, batch, end and error frames flow through the ring;
   credits and dynamic queue edits stay on TCP.

Mode resolution, on both sides: an explicit argument, else
``PETASTORM_TRANSPORT``, else ``"auto"``. ``"tcp"`` never negotiates;
``"auto"`` and ``"shm"`` advertise and accept. ``"shm"`` is an intent,
not a requirement: a peer on another host, or a failed setup, still
serves TCP.
"""

from __future__ import annotations

import os
import threading
import time

from petastorm_tpu_torch.reader_impl.framed_socket import (
    ConnectionClosedError,
    send_framed,
    send_framed_frames,
)
from petastorm_tpu_torch.telemetry.log import service_logger
from petastorm_tpu_torch.telemetry.metrics import TRANSPORT_DOWNGRADES

logger = service_logger(__name__)

MODES = ("auto", "tcp", "shm")

#: How long the worker waits for the client's ``shm_ack`` before
#: declaring the connection dead (the client attaches in microseconds;
#: this only expires when the peer vanished mid-negotiation).
ACK_TIMEOUT_S = 10.0


def resolve_mode(value=None):
    """Resolve a transport mode: explicit ``value`` wins, then the
    ``PETASTORM_TRANSPORT`` env var, then ``"auto"``."""
    mode = value if value is not None else os.environ.get(
        "PETASTORM_TRANSPORT") or "auto"
    mode = str(mode).lower()
    if mode not in MODES:
        raise ValueError(
            f"transport must be one of {MODES}, got {value!r}")
    return mode


def host_token():
    """An identity token two processes share iff a memfd mapped by one
    is attachable by the other: the kernel's per-boot id (stable within
    a boot, distinct across hosts AND across reboots — a stale token can
    never alias a different machine). Falls back to the hostname where
    /proc is unreadable."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket as _socket

        return _socket.gethostname()


def advertisement(mode):
    """The client's ``transport`` request field for ``mode`` — ``None``
    when the mode forbids shm (nothing to negotiate)."""
    if mode == "tcp":
        return None
    return {"modes": ["shm"], "host": host_token(), "pid": os.getpid()}


class TcpStreamTx:
    """The TCP tier behind the same send interface the ring producer
    exposes — what every serve path writes to, so the transport choice
    is invisible above the negotiation."""

    transport = "tcp"

    def __init__(self, sock):
        self._sock = sock

    def send(self, header, payload=None):
        send_framed(self._sock, header, payload)

    def send_frames(self, header, fmt, frames):
        send_framed_frames(self._sock, header, fmt, frames)

    def close(self):
        """Nothing to tear down: the socket belongs to the connection
        (which outlives the stream)."""


def negotiate_worker_tx(sock, conn_reader, request, mode, pool=None):
    """Worker side: decide this stream's transport and return
    ``(tx, extra_credits, early_frames)``.

    ``tx`` is a :class:`TcpStreamTx` or a live
    :class:`~petastorm_tpu_torch.service.shm_ring.RingProducer` (the caller
    owns it and must ``close()`` it at stream teardown).
    ``extra_credits`` counts ``credit`` replenishments that raced the
    ack; ``early_frames`` holds any other control frames that did
    (dynamic queue edits) — the caller replays both so negotiation never
    eats a frame.

    Every shm-side failure downgrades to TCP on this same request —
    counted in ``petastorm_transport_downgrades_total`` — EXCEPT an ack
    timeout, which means the peer died mid-negotiation and raises
    :class:`ConnectionClosedError` (the ordinary disconnected outcome).
    """
    advert = request.get("transport")
    if (mode == "tcp" or not advert
            or "shm" not in (advert.get("modes") or ())):
        return TcpStreamTx(sock), 0, []
    if advert.get("host") != host_token():
        # Cross-host peer: shm is impossible, TCP is simply the right
        # tier — not a downgrade, so not counted as one.
        return TcpStreamTx(sock), 0, []
    from petastorm_tpu_torch.service.shm_ring import RingProducer, ShmSetupError

    try:
        producer = RingProducer(sock, pool=pool)
    except ShmSetupError as exc:
        logger.warning(
            "shm arena setup failed — serving this stream over TCP: %s",
            exc)
        TRANSPORT_DOWNGRADES.labels("arena_setup").inc()
        return TcpStreamTx(sock), 0, []
    offer = {"type": "shm_offer", "ring": producer.descriptor()}
    if pool is not None:
        offer["pool"] = pool.descriptor()
    try:
        send_framed(sock, offer)
        ack, extra_credits, early_frames = _await_ack(conn_reader)
    except BaseException:
        producer.close()
        raise
    if not ack.get("ok"):
        producer.close()
        logger.warning(
            "client declined shm attach — serving this stream over "
            "TCP: %s", ack.get("error", "no reason given"))
        TRANSPORT_DOWNGRADES.labels("client_nack").inc()
        return TcpStreamTx(sock), extra_credits, early_frames
    if pool is not None and not ack.get("pool"):
        # Ring acked, pool not: serve every frame inline (copied) —
        # still shm, just never mapped.
        producer.drop_pool()
    return producer, extra_credits, early_frames


def _await_ack(conn_reader):
    """Wait for ``shm_ack`` on the TCP connection, buffering control
    frames that raced ahead of it."""
    extra_credits = 0
    early_frames = []
    deadline = time.monotonic() + ACK_TIMEOUT_S
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise ConnectionClosedError(
                "client never acknowledged the shm offer")
        if not conn_reader.data_pending() \
                and not conn_reader.wait_data(min(remaining, 0.2)):
            continue
        header, _ = conn_reader.recv()
        kind = header.get("type")
        if kind == "shm_ack":
            return header, extra_credits, early_frames
        if kind == "credit":
            extra_credits += int(header.get("n", 1))
        else:
            early_frames.append(header)


class NegotiatedConnection:
    """Client side: a :class:`FramedConnection` that transparently
    switches its receive path to a shm ring when the worker offers one.

    ``send`` always rides TCP (client→worker traffic is control:
    credits, dynamic queue edits, the ack itself) and is serialized by
    an internal lock — the ack is sent from whatever thread is inside
    ``recv`` when the offer lands, racing the stream owner's
    ``add_credit``/``extend`` sends, and two interleaved framed sends
    would tear the wire.

    Attach failures never error the stream: the client nacks (the
    worker downgrades and keeps serving this same request over TCP) and
    ``recv`` keeps reading the socket.
    """

    def __init__(self, conn, mode="auto"):
        self._conn = conn
        self._mode = mode
        self._send_lock = threading.Lock()
        self._ring = None
        self._ring_pool = None

    @property
    def transport(self):
        return "shm" if self._ring is not None else "tcp"

    def advertisement(self):
        return advertisement(self._mode)

    def send(self, header, payload=None):
        with self._send_lock:
            if payload is None:
                self._conn.send(header)
            else:
                self._conn.send(header, payload)

    def recv(self):
        while True:
            if self._ring is not None:
                return self._ring.recv(
                    timeout=self._conn._sock.gettimeout())
            header, payload = self._conn.recv()
            if header.get("type") != "shm_offer":
                return header, payload
            self._attach(header)

    def _attach(self, offer):
        from petastorm_tpu_torch.service.shm_ring import (
            FramePool,
            RingConsumer,
            ShmAttachError,
        )
        from petastorm_tpu_torch.reader_impl.framed_socket import ProtocolError

        try:
            ring = RingConsumer(offer["ring"], self._conn._sock,
                                self._conn._reader)
        except (ShmAttachError, ProtocolError, OSError, KeyError) as exc:
            logger.warning(
                "shm ring attach failed — staying on TCP: %s", exc)
            self.send({"type": "shm_ack", "ok": False,
                       "error": f"{type(exc).__name__}: {exc}"})
            return
        pool = None
        if offer.get("pool"):
            try:
                pool = FramePool.attach(offer["pool"])
                ring.attach_pool(pool)
            except (ShmAttachError, OSError, KeyError) as exc:
                logger.warning(
                    "shm frame pool attach failed — ring serves inline: "
                    "%s", exc)
                pool = None
        try:
            self.send({"type": "shm_ack", "ok": True,
                       "pool": pool is not None})
        except BaseException:
            ring.close()
            if pool is not None:
                pool.close()
            raise
        self._ring = ring
        self._ring_pool = pool

    def close(self):
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        if self._ring_pool is not None:
            self._ring_pool.close()
            self._ring_pool = None
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
