"""Delivery tracking for resumable reader iteration (the port's own copy of
``petastorm_tpu/reader_impl/delivery_tracker.py``).

- Workers tag what they publish with the identity of the ventilated work
  item that produced it (``item_key(piece_index, drop_partition)``: one row
  group; the port has no drop partitions, so the second part is 0). The
  arrow worker tags the table's schema metadata (:func:`tag_table`); the
  row and columnar workers publish ``(item_key, payload)`` pairs.
- The consumer-side results-queue readers record the tag **when the
  payload is handed to the consumer**, not when the worker finishes: a
  payload still in a queue at checkpoint time is re-read on resume.
- :class:`DeliveryTracker` keeps ``{item_key: times_delivered}``; a resumed
  reader ventilates each item ``num_epochs - times_delivered`` more times.

Stage fusion (a graph rewrite of the data service) has a pool task
collate, transform and serialize a whole piece: the row worker's
``(item_key, rows)`` pair becomes ``(item_key, FusedPiecePayload)``, a list
of :class:`FusedBatch`, through the pools' publish hook
(:func:`apply_publish_transform`). The JAX package wraps payloads in a
``PiecePayload``; the port keeps the pair and carries the fused frames in
its second half.

Semantics: **at-least-once at row-group granularity.** Rows of a row group
that was partly consumed (or decoded and not yet consumed) at checkpoint
time are seen again after resume; fully delivered row groups are never
re-read. The keys and the counts are the JAX package's, so a state written
by either package resumes the other.
"""

from __future__ import annotations

import threading


def item_key(piece_index, drop_partition):
    """Stable JSON-friendly identity of one ventilated work item."""
    return f"{piece_index}:{drop_partition}"


class FusedBatch:
    """One wire-ready batch a fused pool task produced: its serialized
    frames and, when the cache placement wants pre-transform bytes, the
    pre-transform serialization of the same rows."""

    __slots__ = ("rows", "fmt", "frames", "pre_fmt", "pre_frames")

    def __init__(self, rows, fmt, frames, pre_fmt=None, pre_frames=None):
        self.rows = rows
        self.fmt = fmt
        self.frames = frames
        self.pre_fmt = pre_fmt
        self.pre_frames = pre_frames


class FusedPiecePayload(list):
    """A whole piece's :class:`FusedBatch` list, collated, transformed and
    serialized inside the pool task: the second half of a fused
    ``(item_key, payload)`` pair. The results-queue reader hands it through
    whole instead of splitting it into rows."""

    __slots__ = ()

    @property
    def rows(self):
        return sum(batch.rows for batch in self)


def apply_publish_transform(transform, item):
    """The pools' publish hook: ``transform`` applies to a worker's
    ``(item_key, payload)`` pair; tables and anything else pass through.
    One helper, so the thread and dummy pools cannot diverge."""
    if transform is not None and isinstance(item, tuple) and len(item) == 2 \
            and isinstance(item[0], str):
        return transform(item)
    return item


#: Schema-metadata key carrying the work-item tag on ``pa.Table`` payloads.
TABLE_ITEM_KEY = b"petastorm_tpu.delivery_item.v1"


def tag_table(table, key):
    """``table`` with the work-item tag merged into its schema metadata."""
    metadata = dict(table.schema.metadata or {})
    metadata[TABLE_ITEM_KEY] = key.encode("utf-8")
    return table.replace_schema_metadata(metadata)


def read_table_tag(table):
    """The work-item tag of a table (None when untagged)."""
    raw = (table.schema.metadata or {}).get(TABLE_ITEM_KEY)
    return raw.decode("utf-8") if raw is not None else None


class DeliveryTracker:
    """Thread-safe ``{item_key: times_delivered}`` counter with a rollback log.

    ``record`` is called from whatever thread iterates the reader (the
    loader's producer thread); ``counts`` and ``counts_rolled_back_to``
    from the checkpointing thread, hence the lock.

    The ordered ``(key, num_rows)`` log lets a consumer that buffers rows
    past the reader (``TorchDataLoader``'s re-batching, host queue and
    device prefetch) checkpoint what it has actually yielded:
    ``counts_rolled_back_to(yielded_rows)`` un-counts the newest deliveries
    until only the yielded rows remain. Valid only while rows flow FIFO
    from the reader through the consumer; a row-level shuffle buffer can
    hold an old row while newer deliveries drain, so the loader refuses to
    checkpoint with one.
    """

    #: Rollback log cap: rollback depth is bounded by the loader's buffered
    #: rows, a handful of batches, far fewer deliveries than this.
    MAX_LOG_ENTRIES = 100_000

    def __init__(self, preload=None):
        self._lock = threading.Lock()
        #: Optional ``fn(key, num_rows)`` called after each delivery is
        #: recorded, on the thread that consumed it (the service worker
        #: attributes a stream reader's outputs to their pieces with it).
        self.on_record = None
        self._counts = dict(preload or {})
        self._log = []  # ordered (key, num_rows) of this run's deliveries
        self._total_rows = 0

    def record(self, key, num_rows=1):
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._log.append((key, num_rows))
            if len(self._log) > self.MAX_LOG_ENTRIES:
                del self._log[:len(self._log) // 2]
            self._total_rows += num_rows
        hook = self.on_record
        if hook is not None:
            hook(key, num_rows)

    def counts(self):
        with self._lock:
            return dict(self._counts)

    def total_rows_recorded(self):
        """Rows delivered through the reader during this run (preloaded
        counts of an earlier run excluded)."""
        with self._lock:
            return self._total_rows

    def counts_rolled_back_to(self, yielded_rows):
        """Counts as if only the first ``yielded_rows`` delivered rows had
        been delivered: the newest deliveries are un-counted, whole
        deliveries at a time, until the recorded rows are <= ``yielded_rows``
        (a partly consumed delivery rolls back entirely: at-least-once).

        Atomic under the lock: deliveries recorded after the caller read its
        yielded count sit at the log's tail and roll back first, which only
        widens the re-read window. Raises when the log was truncated past
        the point needed, rather than over-report deliveries and skip rows.
        """
        with self._lock:
            counts = dict(self._counts)
            remaining = self._total_rows
            for key, num_rows in reversed(self._log):
                if remaining <= yielded_rows:
                    break
                counts[key] = counts.get(key, 0) - 1
                if counts[key] <= 0:
                    counts.pop(key)
                remaining -= num_rows
            if remaining > yielded_rows:
                raise RuntimeError(
                    "delivery log exhausted while rolling back to "
                    f"{yielded_rows} yielded rows ({remaining} still "
                    "recorded): snapshot taken too long after the rows were "
                    f"buffered (log capped at {self.MAX_LOG_ENTRIES} "
                    "entries); checkpoint earlier or raise MAX_LOG_ENTRIES")
            return counts
