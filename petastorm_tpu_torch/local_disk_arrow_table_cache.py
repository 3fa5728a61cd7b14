"""Local-disk cache of ``pa.Table`` payloads for the batch reader (the
port's own copy of ``petastorm_tpu/local_disk_arrow_table_cache.py``):
entries are Arrow IPC streams rather than pickles."""

from __future__ import annotations

import pyarrow as pa

from petastorm_tpu_torch.local_disk_cache import LocalDiskCache


class LocalDiskArrowTableCache(LocalDiskCache):
    def _serialize(self, value):
        if not isinstance(value, pa.Table):
            raise ValueError(f"LocalDiskArrowTableCache stores pa.Table, got {type(value)}")
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, value.schema) as writer:
            writer.write_table(value)
        return sink.getvalue().to_pybytes()

    def _deserialize(self, payload):
        with pa.ipc.open_stream(pa.BufferReader(payload)) as reader:
            return reader.read_all()
