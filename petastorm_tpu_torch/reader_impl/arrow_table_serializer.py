"""Arrow IPC payload serializer of the process pool for ``pa.Table``
payloads (the port's own copy of
``petastorm_tpu/reader_impl/arrow_table_serializer.py``).

A table travels as one Arrow IPC stream: column buffers, no per-cell
pickling, read back without copies where Arrow can. The stream carries the
schema's metadata, so the work-item tag the batch worker puts there
(:func:`~petastorm_tpu_torch.reader_impl.delivery_tracker.tag_table`)
reaches the consumer's delivery tracker.
"""

from __future__ import annotations

import pyarrow as pa


def _ipc_stream(table):
    if not isinstance(table, pa.Table):
        raise ValueError(f"ArrowTableSerializer serializes pa.Table, got {type(table)}")
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue()


class ArrowTableSerializer:
    def serialize(self, table):
        return _ipc_stream(table).to_pybytes()

    def deserialize(self, serialized_rows):
        with pa.ipc.open_stream(pa.BufferReader(serialized_rows)) as reader:
            return reader.read_all()

    def serialize_to_frames(self, table):
        """One frame: the IPC stream as a ``pa.Buffer`` (it exports the
        buffer protocol, so zmq sends it without a copy)."""
        return [_ipc_stream(table)]

    def deserialize_from_frames(self, frames):
        """The table over the received frame's memory (zero-copy columns)."""
        buf = frames[0] if len(frames) == 1 else b"".join(bytes(f) for f in frames)
        with pa.ipc.open_stream(pa.BufferReader(pa.py_buffer(buf))) as reader:
            return reader.read_all()
