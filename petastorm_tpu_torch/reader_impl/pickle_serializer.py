"""Pickle payload serializer of the process pool (the port's own copy of
``petastorm_tpu/reader_impl/pickle_serializer.py``).

``serialize`` / ``deserialize`` move one pickle per payload. The frames
surface behind ``zmq_copy_buffers=True`` uses pickle protocol 5 with the
large contiguous buffers (numpy arrays) out of band: the worker sends the
arrays' memory as frames of their own, and the consumer rebuilds the
payload over the received frames without an intermediate pickle copy.
The row and columnar workers publish ``(item_key, payload)`` pairs, which
travel through either form unchanged.
"""

from __future__ import annotations

import pickle


class PickleSerializer:
    def serialize(self, rows):
        return pickle.dumps(rows, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, serialized_rows):
        return pickle.loads(serialized_rows)  # noqa: S301 - our own workers, host-local

    def serialize_to_frames(self, rows):
        """``[head, buffer, ...]``: the protocol-5 pickle with out-of-band
        markers, then the buffers as zero-copy views of the arrays' memory
        (keep the payload alive until the frames are sent)."""
        buffers = []
        head = pickle.dumps(rows, protocol=5, buffer_callback=buffers.append)
        return [head] + [b.raw() for b in buffers]

    def deserialize_from_frames(self, frames):
        """Inverse of :meth:`serialize_to_frames`; ``frames`` may be bytes,
        memoryviews or zmq frame buffers."""
        head, buffers = frames[0], frames[1:]
        if not isinstance(head, (bytes, bytearray, memoryview)):
            head = memoryview(head)
        return pickle.loads(head, buffers=buffers)  # noqa: S301
