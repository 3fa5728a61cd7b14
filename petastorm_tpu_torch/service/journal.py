"""Append-only JSONL write-ahead log with compacted snapshots (the port's
own copy of ``petastorm_tpu/service/journal.py``: the same files, byte for
byte, so each package loads the other's journal).

The dispatcher's durability layer: every control-plane mutation (worker
registration, client assignment, fcfs split pop, fencing bump) is appended
as one JSON line *after* being applied in memory, and the full state is
periodically compacted into a snapshot so recovery cost stays bounded by
``compact_every`` instead of growing with uptime.

Crash-safety invariants:

- Records are flushed per append (``fsync=True`` additionally makes each
  record durable against OS/power loss; the default survives process
  crashes, which is what the service's failure model targets).
- Snapshots are written atomically (tmp file + ``os.replace``), so a crash
  mid-compaction leaves the previous snapshot intact.
- Every record carries a monotonically increasing ``seq`` and the snapshot
  records the ``seq`` watermark it folded in, so a crash *between* the
  snapshot replace and the WAL truncation replays nothing twice.
- A torn final line (crash mid-append) is detected and truncated off,
  whether it is missing its newline OR newline-terminated but unparseable
  (buffered writes flush at page boundaries, not record boundaries, so a
  crash can persist a mangled record complete with its "\n"); everything
  before it replays normally. Mid-file corruption still refuses recovery —
  that is damage, not a crash signature.

The layout inside ``path`` is two files: ``snapshot.json`` and
``wal.jsonl``. :meth:`load` returns the snapshot state (or ``None``) plus
the post-watermark records, in append order — the dispatcher installs the
state and re-applies the records through the same mutation helpers the
live handlers use.
"""

from __future__ import annotations

import json
import logging
import os

from petastorm_tpu_torch import failpoints

logger = logging.getLogger(__name__)

SNAPSHOT_NAME = "snapshot.json"
WAL_NAME = "wal.jsonl"


class Journal:
    """One dispatcher's WAL + snapshot pair under ``path``.

    :param path: journal directory (created if missing).
    :param compact_every: appended records between automatic compactions
        (checked by :meth:`maybe_compact`).
    :param fsync: fsync the WAL after every append (durable against OS
        crash, not just process crash) and the snapshot before its rename.
    """

    def __init__(self, path, compact_every=256, fsync=False):
        self.path = str(path)
        self._compact_every = int(compact_every)
        self._fsync = fsync
        os.makedirs(self.path, exist_ok=True)
        self._wal_path = os.path.join(self.path, WAL_NAME)
        self._snapshot_path = os.path.join(self.path, SNAPSHOT_NAME)
        self._wal_file = None
        self._closed = False
        self._seq = 0                  # last seq assigned
        self._since_snapshot = 0       # records appended since last snapshot
        self.records_appended = 0      # this process's appends
        self.compactions = 0           # this process's compactions
        self.snapshot_failures = 0     # compactions that failed (OSError)

    # -- recovery ----------------------------------------------------------

    def load(self):
        """Read the journal → ``(snapshot_state_or_None, records)``.

        Restores the internal ``seq`` cursor so appends continue the
        sequence; records at or below the snapshot's watermark (a crash
        landed between snapshot replace and WAL truncation) are skipped,
        and a torn tail line is dropped with a warning.
        """
        state, watermark = None, 0
        try:
            with open(self._snapshot_path, "r", encoding="utf-8") as f:
                snap = json.load(f)
            state = snap["state"]
            watermark = int(snap.get("seq", 0))
        except FileNotFoundError:
            pass
        except (ValueError, KeyError, TypeError) as exc:
            # A torn snapshot cannot happen under the atomic-replace write
            # path; a hand-damaged one must not brick recovery silently.
            logger.warning("journal snapshot %s unreadable (%s) — "
                           "recovering from the WAL alone",
                           self._snapshot_path, exc)
        records = []
        self._seq = watermark
        try:
            with open(self._wal_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            data = b""
        # Every complete record is written as one line ending in "\n"
        # (json.dumps emits no newlines), so bytes past the last newline
        # are a torn append (crash mid-write). They must be TRUNCATED off
        # the file, not just skipped: a later append() reopens in append
        # mode, and concatenating onto the fragment would weld two records
        # into one unparseable MID-file line that bricks the next recovery.
        complete, _, torn = data.rpartition(b"\n")
        if torn:
            logger.warning(
                "journal %s: dropping %d-byte torn final WAL line "
                "(crash mid-append)", self.path, len(torn))
            with open(self._wal_path, "r+b") as f:
                f.truncate(len(data) - len(torn))
        lines = complete.split(b"\n") if complete else []
        parsed = []  # (line_index, record)
        bad_final = None
        for i, line in enumerate(lines):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                record = json.loads(stripped.decode("utf-8"))
                if not isinstance(record, dict):
                    raise ValueError("WAL record is not a JSON object")
            except ValueError:
                if i == len(lines) - 1:
                    # Garbage FINAL line: the other face of a crash
                    # mid-append — the buffered write flushed a partial or
                    # mangled record WITH its trailing newline (page-sized
                    # flush boundaries don't respect record boundaries).
                    # Same remedy as the torn tail: truncate it off and
                    # restore the pre-append state.
                    bad_final = (i, line)
                    break
                raise ValueError(
                    f"journal {self.path}: corrupt WAL record at line "
                    f"{i + 1} (mid-file, not the crash-mid-append case — "
                    f"refusing to recover from ambiguous state)")
            parsed.append((i, record))
        if bad_final is not None:
            i, line = bad_final
            keep = sum(len(ln) + 1 for ln in lines[:i])
            logger.warning(
                "journal %s: dropping unparseable final WAL line %d "
                "(%d bytes — crash mid-append)", self.path, i + 1,
                len(line))
            with open(self._wal_path, "r+b") as f:
                f.truncate(keep)
        for _, record in parsed:
            seq = int(record.get("seq", 0))
            if seq <= watermark:
                continue  # already folded into the snapshot
            records.append(record)
            self._seq = max(self._seq, seq)
        self._since_snapshot = len(records)
        return state, records

    # -- writing -----------------------------------------------------------

    def append(self, record):
        """Append one record (a JSON-serializable dict); assigns ``seq``."""
        if self._closed:
            # The lazy open must NOT resurrect a closed journal: a handler
            # racing shutdown would durably write a record that post-dates
            # the stop and leak the reopened handle.
            raise RuntimeError(f"journal {self.path} is closed")
        fp = failpoints.ACTIVE
        if fp is not None:
            fp.fire("journal.append")  # enospc raises BEFORE the write:
            #   the WAL never holds a half-applied record, and the seq
            #   cursor below stays consistent with what is on disk.
        self._seq += 1
        record = dict(record, seq=self._seq)
        if self._wal_file is None:
            self._wal_file = open(self._wal_path, "a", encoding="utf-8")
        self._wal_file.write(json.dumps(record) + "\n")
        self._wal_file.flush()
        if self._fsync:
            if fp is not None:
                fp.fire("journal.fsync")
            os.fsync(self._wal_file.fileno())
        self.records_appended += 1
        self._since_snapshot += 1
        return record

    def snapshot(self, state):
        """Compact: atomically persist ``state`` with the current ``seq``
        watermark, then truncate the WAL."""
        if self._closed:
            raise RuntimeError(f"journal {self.path} is closed")
        tmp = self._snapshot_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"seq": self._seq, "state": state}, f)
                f.flush()
                if self._fsync:
                    os.fsync(f.fileno())
            fp = failpoints.ACTIVE
            if fp is not None and fp.fire("journal.compact") \
                    == "torn_rename":
                # The crash-between-tmp-write-and-rename signature: the
                # tmp file exists, snapshot.json is still the OLD one, and
                # the WAL was NOT truncated — recovery must replay the
                # pre-compaction WAL byte-identically.
                raise OSError(
                    "failpoint journal.compact: torn snapshot rename")
            os.replace(tmp, self._snapshot_path)
        except OSError:
            # A failed compaction must leave the journal exactly as it
            # was: old snapshot intact, WAL intact, seq/since-snapshot
            # cursors untouched (the truncation below never ran). The
            # orphan tmp is removed so a later compaction cannot be
            # confused by it; recovery ignores it either way.
            self.snapshot_failures += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        # Crash window here is safe: the WAL still holds <= watermark
        # records, which load() skips.
        if self._wal_file is not None:
            self._wal_file.close()
        self._wal_file = open(self._wal_path, "w", encoding="utf-8")
        self._since_snapshot = 0
        self.compactions += 1

    def maybe_compact(self, state_fn):
        """Compact when ``compact_every`` records accumulated since the
        last snapshot; ``state_fn()`` is called only when compacting."""
        if self._since_snapshot >= self._compact_every:
            self.snapshot(state_fn())
            return True
        return False

    def close(self):
        self._closed = True
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None

    @property
    def stats(self):
        return {
            "path": self.path,
            "records_appended": self.records_appended,
            "compactions": self.compactions,
            "snapshot_failures": self.snapshot_failures,
            "records_since_snapshot": self._since_snapshot,
        }
