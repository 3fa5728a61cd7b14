"""The port's journal (``petastorm_tpu_torch/service/journal.py``) against
the JAX package's: the seven journal cases of the JAX recovery tests
(round trip, compaction and the resumed seq, the watermark, fuzzed torn
tails, refusal after close, mid-file corruption) on the port; the same
appends, snapshots and failpoints give byte-equal ``wal.jsonl`` and
``snapshot.json`` in both packages, and each package loads the other's
journal. Exact comparison throughout."""

import json

import pytest

from petastorm_tpu import failpoints as jax_fp
from petastorm_tpu.service.journal import Journal as JaxJournal
from petastorm_tpu_torch import failpoints as port_fp
from petastorm_tpu_torch.service.journal import SNAPSHOT_NAME, WAL_NAME, Journal


@pytest.fixture(autouse=True)
def _port_schedule_leak_guard():
    """Fail a test that leaves the port's schedule armed."""
    yield
    if port_fp.ACTIVE is not None:
        port_fp.disarm()
        pytest.fail("a port FaultSchedule outlived its test: use failpoints.armed(...)")


def test_journal_append_load_roundtrip(tmp_path):
    journal = Journal(tmp_path / "j")
    journal.append({"op": "a", "x": 1})
    journal.append({"op": "b", "y": [1, 2]})
    journal.close()
    state, records = Journal(tmp_path / "j").load()
    assert state is None
    assert [r["op"] for r in records] == ["a", "b"]
    assert [r["seq"] for r in records] == [1, 2]


def test_journal_compaction_truncates_wal_and_resumes_seq(tmp_path):
    journal = Journal(tmp_path / "j", compact_every=3)
    for i in range(3):
        journal.append({"op": "r", "i": i})
        journal.maybe_compact(lambda: {"upto": journal.records_appended})
    journal.append({"op": "after"})
    journal.close()
    assert journal.compactions == 1
    loaded = Journal(tmp_path / "j")
    state, records = loaded.load()
    assert state == {"upto": 3}
    assert [r["op"] for r in records] == ["after"]
    assert loaded.append({"op": "next"})["seq"] == 5
    loaded.close()


def test_journal_watermark_skips_records_already_in_snapshot(tmp_path):
    journal = Journal(tmp_path / "j")
    journal.append({"op": "old"})       # seq 1
    journal.snapshot({"folded": True})  # watermark 1, truncates
    journal.append({"op": "new"})       # seq 2
    journal.close()
    # The crash between the snapshot's replace and the WAL's truncation.
    wal = tmp_path / "j" / WAL_NAME
    wal.write_text(json.dumps({"op": "old", "seq": 1}) + "\n" + wal.read_text())
    state, records = Journal(tmp_path / "j").load()
    assert state == {"folded": True}
    assert [r["op"] for r in records] == ["new"]


def test_journal_drops_and_truncates_torn_tail_line(tmp_path):
    journal = Journal(tmp_path / "j")
    journal.append({"op": "whole"})
    journal.close()
    with open(tmp_path / "j" / WAL_NAME, "a", encoding="utf-8") as f:
        f.write('{"op": "torn", "se')  # a crash mid-append
    recovered = Journal(tmp_path / "j")
    assert [r["op"] for r in recovered.load()[1]] == ["whole"]
    recovered.append({"op": "post-recovery"})
    recovered.close()
    assert [r["op"] for r in Journal(tmp_path / "j").load()[1]] == ["whole",
                                                                   "post-recovery"]


@pytest.mark.parametrize("tail", [
    b'{"op": "torn", "se', b'{"op": "torn", "se\n', b'garbage-not-json\n', b'42\n',
    b'["not", "a", "dict"]\n', b'\x00\xff\xfe partial page \n', b'{"op": "torn"',
], ids=["no-newline", "partial+nl", "garbage+nl", "int+nl", "array+nl", "binary+nl",
        "json-prefix"])
def test_journal_tolerates_fuzzed_torn_tails(tmp_path, tail):
    """Any byte prefix of a record, with or without its newline, is cut off;
    the recovered journal appends cleanly, and the JAX journal reads the
    result the same."""
    journal = Journal(tmp_path / "j")
    journal.append({"op": "keep-a"})
    journal.append({"op": "keep-b"})
    journal.close()
    with open(tmp_path / "j" / WAL_NAME, "ab") as f:
        f.write(tail)
    recovered = Journal(tmp_path / "j")
    assert [r["op"] for r in recovered.load()[1]] == ["keep-a", "keep-b"]
    recovered.append({"op": "post-recovery"})
    recovered.close()
    ops = ["keep-a", "keep-b", "post-recovery"]
    assert [r["op"] for r in Journal(tmp_path / "j").load()[1]] == ops
    assert [r["op"] for r in JaxJournal(tmp_path / "j").load()[1]] == ops


def test_journal_refuses_writes_after_close(tmp_path):
    journal = Journal(tmp_path / "j")
    journal.append({"op": "a"})
    journal.close()
    with pytest.raises(RuntimeError, match="closed"):
        journal.append({"op": "late"})
    with pytest.raises(RuntimeError, match="closed"):
        journal.snapshot({})


def test_journal_rejects_mid_file_corruption(tmp_path):
    journal = Journal(tmp_path / "j")
    journal.append({"op": "first"})
    journal.append({"op": "last"})
    journal.close()
    wal = tmp_path / "j" / WAL_NAME
    lines = wal.read_text().splitlines()
    wal.write_text(lines[0] + "\ngarbage-not-json\n" + lines[1] + "\n")
    for cls in (Journal, JaxJournal):
        with pytest.raises(ValueError, match="corrupt WAL record"):
            cls(tmp_path / "j").load()


# ---------------------------------------------------------------------------
# the files, byte for byte, and across the packages
# ---------------------------------------------------------------------------

SCRIPT = [("append", {"op": "register_worker", "worker_id": "w0", "host": "127.0.0.1",
                      "port": 7, "num_pieces": 12, "re_register": False, "standby": False}),
          ("append", {"op": "client", "client_id": "c0", "epoch": 0, "client_index": 0,
                      "num_clients": 1}),
          ("snapshot", {"mode": "static", "workers": {"w0": {"alive": True}},
                        "unicode": "é — ✓", "nested": [1, 2.5, None, {"k": [True]}]}),
          ("append", {"op": "fencing", "fencing_epoch": 1, "reason": "journal_replay"}),
          ("append", {"op": "quarantine", "piece": 3, "error": "bad \"row\"\n",
                      "epoch": 0}),
          ("compact", None),
          ("append", {"op": "watermarks", "client_id": "c0", "epoch": 0,
                      "watermarks": {"5": 2}})]


def _write(journal_cls, path, compact_every=2, fsync=False):
    journal = journal_cls(path, compact_every=compact_every, fsync=fsync)
    journal.load()
    for kind, record in SCRIPT:
        if kind == "append":
            journal.append(record)
        elif kind == "snapshot":
            journal.snapshot(record)
        else:
            journal.maybe_compact(lambda: {"compacted_at": journal.records_appended})
    stats = journal.stats
    journal.close()
    return {name: (path / name).read_bytes() for name in (WAL_NAME, SNAPSHOT_NAME)}, stats


@pytest.mark.parametrize("fsync", [False, True])
def test_the_files_are_byte_equal_to_jax(tmp_path, fsync):
    port, port_stats = _write(Journal, tmp_path / "port", fsync=fsync)
    jax, jax_stats = _write(JaxJournal, tmp_path / "jax", fsync=fsync)
    assert port == jax
    assert {k: v for k, v in port_stats.items() if k != "path"} == \
        {k: v for k, v in jax_stats.items() if k != "path"}


@pytest.mark.parametrize("writer,reader", [(JaxJournal, Journal), (Journal, JaxJournal)],
                         ids=["jax-written", "port-written"])
def test_each_package_loads_the_others_journal(tmp_path, writer, reader):
    _write(writer, tmp_path / "j")
    state, records = reader(tmp_path / "j").load()
    assert (state, records) == writer(tmp_path / "j").load()
    assert state == {"compacted_at": 4}
    assert records == [dict(SCRIPT[-1][1], seq=5)]
    resumed = reader(tmp_path / "j")
    resumed.load()
    assert resumed.append({"op": "replayed"})["seq"] == 6
    resumed.close()


@pytest.mark.parametrize("point,action", [("journal.append", "enospc"),
                                          ("journal.fsync", "enospc"),
                                          ("journal.compact", "torn_rename")])
def test_failpoints_leave_the_same_files(tmp_path, point, action):
    """An injected fault leaves both packages' journals in the same state:
    ENOSPC before the append (or its fsync), a torn snapshot rename that
    keeps the old snapshot and the whole WAL."""
    out = {}
    for name, cls, fp in (("port", Journal, port_fp), ("jax", JaxJournal, jax_fp)):
        path = tmp_path / name
        journal = cls(path, fsync=True)
        journal.append({"op": "a"})
        journal.snapshot({"v": 1})
        journal.append({"op": "b"})
        schedule = fp.FaultSchedule(0, points=[point], fires={point: {0: action}})
        with fp.armed(schedule):
            with pytest.raises(OSError):
                if point == "journal.compact":
                    journal.snapshot({"v": 2})
                else:
                    journal.append({"op": "c"})
        journal.append({"op": "d"})
        journal.close()
        out[name] = ({n: (path / n).read_bytes() for n in (WAL_NAME, SNAPSHOT_NAME)},
                     sorted(p.name for p in path.iterdir()), journal.stats["snapshot_failures"],
                     schedule.log_snapshot())
    assert out["port"] == out["jax"]
