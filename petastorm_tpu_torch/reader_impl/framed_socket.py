"""The framed payload codec: a batch as a format tag and a list of frames.

The port's own copy of the payload half of
``petastorm_tpu/reader_impl/framed_socket.py`` (the formats and
``encode_payload`` / ``decode_payload``); the socket transport is not
ported. The decoded-batch cache (:mod:`petastorm_tpu_torch.cache_impl`)
stores every batch as these frames, and they equal the JAX package's frames
byte for byte for the same batch, so a disk tier written by either
package's cache is served by the other's.

Formats:

- ``PAYLOAD_COLUMNAR``: a ``{field: ndarray}`` batch of plain dtypes is one
  JSON meta frame (names, dtypes, shapes), then each column's C-contiguous
  bytes as a frame. Decoding is ``np.frombuffer`` views over the frames,
  which inherit the frames' writability: a cache entry's immutable
  ``bytes`` come back as read-only arrays, so a consumer can never write
  into the cache through a served batch.
- ``PAYLOAD_PICKLE``: anything else (object columns, extension dtypes):
  a protocol-5 pickle head with the arrays' buffers out of band as frames.
- ``PAYLOAD_ARROW``: a ``pa.Table`` as one Arrow IPC stream frame.
"""

from __future__ import annotations

import json
import pickle
import sys

PAYLOAD_NONE = 0
PAYLOAD_PICKLE = 1
PAYLOAD_ARROW = 2
PAYLOAD_COLUMNAR = 3

__all__ = ["PAYLOAD_NONE", "PAYLOAD_PICKLE", "PAYLOAD_ARROW", "PAYLOAD_COLUMNAR",
           "encode_payload", "decode_payload"]


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
