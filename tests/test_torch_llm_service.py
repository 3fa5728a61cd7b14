"""The data service's LLM stages in the port against the JAX package: the
mirror of ``tests/test_llm_service.py``, each case run through both
packages on the same seeded inputs.

- The mixture sampler's draws, exhaustion policies and states equal the
  JAX sampler's for the same seed, weights and epoch; ``MixtureSpec`` and
  ``validate_weights`` refuse what the JAX ones refuse, with their words.
- ``PackingSpec`` dicts are equal; ``PackedBatchSource`` at trainer
  placement packs, checkpoints and resumes as the JAX one, batch for batch.
- The dispatcher's mixture control plane: ``set_mixture_weights`` /
  ``get_mixture`` replies, the journal replay, the stale-fencing refusal,
  the retry token's idempotence and per-corpus registration equal the JAX
  dispatcher's.
- Packed service streams (static and dynamic sharding, two epochs, worker
  and trainer placement, a resume in the middle of a pack, the cache's
  packed frames) are byte-equal to the JAX fleet's over the same store;
  the refusals (fcfs, a transform, a spec mismatch) carry the JAX words.
- Mixtures of two corpora over one dispatcher: the digests equal the JAX
  mixture's, a journaled weight change applies at the pass boundary, a
  mid-pass resume does not apply a pending entry, a bad log entry does not
  wedge the mix, and a zero-weight corpus is never opened.
- The graph's ``pack`` node and ``packing_placement`` knob.

Stores: the test factories' token store, 40 rows in 4 row groups of 10 and
30 rows (skew 1.5) in 3; ``slots=2``, ``slot_len=64``. The port's mixture
passes are guarded by this file's own fixture (the shared one watches the
JAX package's). The chaos case (a worker killed mid-pass) is ``slow``, as
the JAX one is.

Tolerance: none; everything is compared byte for byte.
"""

import hashlib
import uuid

import numpy as np
import pytest

from petastorm_tpu import service as jax_service
from petastorm_tpu.service import mixture as jax_mixture
from petastorm_tpu_torch import service as port_service
from petastorm_tpu_torch.service import mixture
from petastorm_tpu_torch.service.packing_stage import PACK_SEGMENT_KEY
from petastorm_tpu_torch.service.shm_ring import live_shm_counts

PACKAGES = {"port": port_service, "jax": jax_service}
MIXTURE = {"port": mixture, "jax": jax_mixture}

SPEC = {"slot_len": 64, "slots": 2, "sequence_fields": ["tokens"], "length_field": "length"}
READER_KWARGS = {"reader_pool_type": "thread", "workers_count": 1,
                 "schema_fields": ["tokens", "length"]}


@pytest.fixture(autouse=True)
def _port_guards():
    """Fail a test that leaves a port mixture pass open or a shared-memory
    ring mapped (the shared guards watch the JAX package's only)."""
    passes, rings = mixture.open_mixture_passes(), live_shm_counts()
    yield
    assert mixture.open_mixture_passes() == passes, "a port mixture pass was left open"
    assert live_shm_counts() == rings


@pytest.fixture(scope="module")
def token_dataset(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_token_dataset

    url = f"file://{tmp_path_factory.mktemp('llm')}/tok_a"
    return url, create_test_token_dataset(url, rows_count=40, rows_per_row_group=10)


@pytest.fixture(scope="module")
def token_dataset_b(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_token_dataset

    url = f"file://{tmp_path_factory.mktemp('llm')}/tok_b"
    return url, create_test_token_dataset(url, rows_count=30, rows_per_row_group=10, skew=1.5)


def _digest(batches):
    h = hashlib.blake2b(digest_size=16)
    for batch in batches:
        for key in sorted(batch):
            arr = np.ascontiguousarray(np.asarray(batch[key]))
            h.update(key.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _spec(name, **overrides):
    return PACKAGES[name].PackingSpec(**dict(SPEC, **overrides))


def _token_worker(name, url, disp, corpus="", worker_id=None, **kwargs):
    """A started worker with an id of its own (registry series are per id)."""
    return PACKAGES[name].BatchWorker(
        url, dispatcher_address=disp.address, batch_size=8, reader_factory="row",
        corpus=corpus, worker_id=worker_id or f"llm-{name}-{uuid.uuid4().hex[:8]}",
        reader_kwargs=dict(READER_KWARGS), **kwargs).start()


def _unpacked_multiset(batches):
    """The multiset of original sequences across packed batches."""
    from petastorm_tpu_torch.torch_utils.packing import unpack

    return sorted(tuple(int(x) for x in seq)
                  for batch in batches for seq in unpack(batch, "tokens"))


def _both(run):
    """``run(name)`` for each package; the two results."""
    return run("port"), run("jax")


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), strict=True)


# ---------------------------------------------------------------------------
# mixture sampler / spec units
# ---------------------------------------------------------------------------

def test_mixture_sampler_requires_explicit_seed():
    messages = []
    for name in PACKAGES:
        with pytest.raises(ValueError, match="explicit seed") as err:
            PACKAGES[name].MixtureSampler(None, {"a": 1.0})
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_mixture_sampler_deterministic_and_ratio_shaped():
    port, jax = _both(lambda name: [
        s.draw() for s in [PACKAGES[name].MixtureSampler(5, {"x": 0.75, "y": 0.25})]
        for _ in range(400)])
    assert port == jax
    assert 0.65 < port.count("x") / len(port) < 0.85


def test_mixture_sampler_epoch_changes_sequence():
    def run(name):
        draws = []
        for epoch in (0, 1):
            sampler = PACKAGES[name].MixtureSampler(5, {"x": 0.5, "y": 0.5}, epoch=epoch)
            draws.append([sampler.draw() for _ in range(64)])
        return draws

    port, jax = _both(run)
    assert port == jax
    assert port[0] != port[1]


def test_mixture_sampler_state_dict_resume_replays():
    def run(name):
        a = PACKAGES[name].MixtureSampler(9, {"x": 0.6, "y": 0.4})
        for _ in range(37):
            a.draw()
        state = a.state_dict()
        # Each package's sampler loads the other's state.
        other = PACKAGES["jax" if name == "port" else "port"].MixtureSampler(
            9, {"x": 0.6, "y": 0.4})
        other.load_state_dict(state)
        return state, [a.draw() for _ in range(50)], [other.draw() for _ in range(50)]

    port, jax = _both(run)
    assert port == jax
    assert port[1] == port[2]


def test_mixture_exhaustion_policies():
    def run(name):
        pkg, out = PACKAGES[name], []
        stop = pkg.MixtureSampler(3, {"x": 0.5, "y": 0.5}, exhaustion="stop")
        stop.draw()
        with pytest.raises(MIXTURE[name].MixtureExhausted) as err:
            stop.mark_exhausted("x")
        out.append(str(err.value))
        drain = pkg.MixtureSampler(3, {"x": 0.5, "y": 0.5}, exhaustion="exhaust")
        drain.draw()
        out += [drain.mark_exhausted("x"), drain.live_names()]
        with pytest.raises(MIXTURE[name].MixtureExhausted):
            drain.mark_exhausted("y")
        rew = pkg.MixtureSampler(3, {"x": 0.5, "y": 0.5}, exhaustion="reweight")
        rew.draw()
        out += [rew.mark_exhausted("x"), rew.state_dict()]
        return out

    port, jax = _both(run)
    assert port == jax
    assert port[1:3] == ["y", ["y"]] and port[3] == "y"
    assert port[4]["applied"][-1][1]["x"] == 0.0
    assert "exhausted:x" in port[4]["applied"][-1][2]


def test_mixture_spec_and_weight_validation():
    def run(name):
        pkg, messages = PACKAGES[name], []
        for bad, match in (([("a", None, 1.0), ("a", None, 1.0)], "duplicate"),
                           ([("a", None, 0.0)], "positive")):
            with pytest.raises(ValueError, match=match) as err:
                pkg.MixtureSpec(bad)
            messages.append(str(err.value))
        for weights, names, match in (({"zz": 1.0}, ["a", "b"], "unknown corpora"),
                                      ({"a": -1.0}, None, "negative")):
            with pytest.raises(ValueError, match=match) as err:
                MIXTURE[name].validate_weights(weights, names=names)
            messages.append(str(err.value))
        spec = pkg.MixtureSpec([("a", "file:///x", 2.0), ("b", None, 1.0)])
        return messages, spec.to_dict(), pkg.MixtureSpec.from_dict(spec.to_dict()).names

    port, jax = _both(run)
    assert port == jax
    assert port[2] == ["a", "b"]


# ---------------------------------------------------------------------------
# packing spec / placement units
# ---------------------------------------------------------------------------

def test_packing_spec_validation_and_round_trip():
    def run(name):
        spec_cls, messages = PACKAGES[name].PackingSpec, []
        for args, kwargs, match in (((8, 2, []), {}, "at least one field"),
                                    ((0, 2, ["t"]), {}, "positive"),
                                    ((8, 2, ["t"]), {"length_field": "t"}, "cannot also be")):
            with pytest.raises(ValueError, match=match) as err:
                spec_cls(*args, **kwargs)
            messages.append(str(err.value))
        spec = spec_cls(8, 2, ["t"], length_field="n")
        assert spec_cls.from_dict(spec.to_dict()) == spec
        return messages, spec.to_dict(), spec.key_dict(), repr(spec)

    port, jax = _both(run)
    assert port == jax


class _ListSource:
    """A batch source over canned row batches; a prior state_dict passed
    back as ``resume`` skips the consumed prefix."""

    def __init__(self, batches, resume=None):
        self._batches = batches
        self._skip = int(resume["consumed"]) if resume else 0

    def __call__(self):
        return iter([dict(b) for b in self._batches[self._skip:]])

    def state_dict(self, yielded_batches=None):
        return {"consumed": self._skip + int(yielded_batches or 0)}


def _row_batches(lengths, max_len=32, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for chunk in np.array_split(np.asarray(lengths), 4):
        tokens = np.zeros((len(chunk), max_len), np.int32)
        for i, n in enumerate(chunk):
            tokens[i, :n] = rng.randint(1, 999, size=int(n))
        out.append({"tokens": tokens, "length": np.asarray(chunk, np.int32)})
    return out


def test_packed_source_trainer_placement_and_checkpoint():
    lengths = [5, 30, 11, 7, 22, 3, 18, 9, 27, 4, 15, 8]

    def run(name):
        pkg = PACKAGES[name]
        spec = pkg.PackingSpec(32, 2, ["tokens"], length_field="length")
        full = list(pkg.PackedBatchSource(_ListSource(_row_batches(lengths)), spec,
                                          placement="trainer")())
        assert full and all(b[PACK_SEGMENT_KEY].shape == (2, 32) for b in full)
        states = []
        for cut in range(len(full)):
            wrapper = pkg.PackedBatchSource(_ListSource(_row_batches(lengths)), spec,
                                            placement="trainer")
            it = wrapper()
            got = [next(it) for _ in range(cut)]
            state = wrapper.state_dict(yielded_batches=cut)
            assert state["placement"] == "trainer"
            states.append(state)
            resumed = pkg.PackedBatchSource(
                _ListSource(_row_batches(lengths), resume=state["inner"]), spec,
                placement="trainer", resume_state=state)
            got += list(resumed())
            _assert_batches_equal(got, full)
            it.close()
        return full, states

    port, jax = _both(run)
    _assert_batches_equal(port[0], jax[0])
    assert port[1] == jax[1]  # the snapshots (packer states included) are equal


def test_packed_source_placement_flip_validates():
    def run(name):
        pkg, messages = PACKAGES[name], []
        spec = pkg.PackingSpec(32, 2, ["tokens"], length_field="length")
        wrapper = pkg.PackedBatchSource(_ListSource(_row_batches([4, 5])), spec,
                                        placement="trainer")
        with pytest.raises(ValueError, match="worker' or 'trainer") as err:
            wrapper.set_packing_placement("device")
        messages.append(str(err.value))
        wrapper.set_packing_placement("worker")
        with pytest.raises(ValueError, match="set_packing|forwards") as err:
            wrapper()
        messages.append(str(err.value))
        return messages

    port, jax = _both(run)
    assert port == jax


# ---------------------------------------------------------------------------
# dispatcher: the mixture control plane and per-corpus registration
# ---------------------------------------------------------------------------

def test_set_mixture_weights_journaled_and_replayed(tmp_path):
    """Both packages journal the same ``mixture_weights`` records, byte for
    byte, and each recovers the other's journal to the same log."""
    def run(name):
        pkg, journal = PACKAGES[name], str(tmp_path / name)
        with pkg.Dispatcher(mode="static", num_epochs=1, journal_dir=journal).start() as disp:
            r1 = pkg.set_mixture_weights(disp.address, {"a": 0.7, "b": 0.3},
                                         job_id="default", effective_epoch=2)
            r2 = pkg.set_mixture_weights(disp.address, {"a": 0.2, "b": 0.8},
                                         job_id="default", effective_epoch=5)
            assert (r1["seq"], r2["seq"]) == (1, 2)
            log = pkg.get_mixture_weights(disp.address)
            before = disp.state_snapshot()["mixtures"]
        records = [rec for rec in _wal_records(journal) if rec.get("op") == "mixture_weights"]
        return journal, log, before, records

    port, jax = _both(run)
    assert port[1]["entries"] == jax[1]["entries"] and [e["seq"] for e in port[1]["entries"]] \
        == [1, 2]
    # The tokens are random: the records and states are equal less them.
    for side in (port, jax):
        for entry in side[2].values():
            entry.pop("last_token")
        for record in side[3]:
            record.pop("token")
    assert port[2] == jax[2]
    assert port[3] == jax[3]
    for reader, (writer_journal, log, before, _) in (("jax", port), ("port", jax)):
        with PACKAGES[reader].Dispatcher(mode="static", num_epochs=1,
                                         journal_dir=writer_journal).start() as disp:
            after = disp.state_snapshot()["mixtures"]
            for entry in after.values():
                entry.pop("last_token")
            assert after == before
            assert PACKAGES[reader].get_mixture_weights(disp.address)["entries"] \
                == log["entries"]


def test_replayed_mixture_entries_keep_their_numbers(tmp_path):
    """The journal stamps its own ``seq`` on every record, over the
    ``mixture_weights`` entry's. Where the two differ (a worker registered
    first, two jobs' entries interleaved) a restarted port dispatcher still
    returns the live log; the JAX dispatcher returns the journal's numbers
    instead, a JAX fault the port does not copy. The records stay equal."""
    def run(name):
        pkg, journal = PACKAGES[name], str(tmp_path / name)
        with pkg.Dispatcher(mode="static", num_epochs=1, journal_dir=journal).start() as disp:
            with disp._lock:
                disp._install_worker_locked("w0", ["127.0.0.1", 9], 4)
                disp._journal_locked({"op": "register_worker", "worker_id": "w0",
                                      "host": "127.0.0.1", "port": 9, "num_pieces": 4,
                                      "re_register": False, "standby": False})
            for job, weights in (("x", {"a": 1.0}), ("y", {"a": 0.5, "b": 0.5}),
                                 ("x", {"a": 0.25, "b": 0.75})):
                pkg.set_mixture_weights(disp.address, weights, job_id=job, effective_epoch=1)
            live = {job: pkg.get_mixture_weights(disp.address, job)["entries"]
                    for job in ("x", "y")}
        records = [dict(r, token=None) for r in _wal_records(journal)]
        with pkg.Dispatcher(mode="static", num_epochs=1, journal_dir=journal).start() as disp:
            restored = {job: pkg.get_mixture_weights(disp.address, job)["entries"]
                        for job in ("x", "y")}
        return live, records, restored

    port, jax = _both(run)
    assert port[0] == jax[0] == {
        "x": [{"seq": 1, "weights": {"a": 1.0}, "effective_epoch": 1},
              {"seq": 2, "weights": {"a": 0.25, "b": 0.75}, "effective_epoch": 1}],
        "y": [{"seq": 1, "weights": {"a": 0.5, "b": 0.5}, "effective_epoch": 1}]}
    assert port[1] == jax[1]
    assert port[2] == port[0]
    assert [e["seq"] for e in jax[2]["x"]] == [2, 4]  # the journal's numbers


def _wal_records(journal_dir):
    """Every WAL record of a journal directory, in order."""
    import json
    import os

    out = []
    for name in sorted(os.listdir(journal_dir)):
        if name.startswith("wal"):
            with open(os.path.join(journal_dir, name), encoding="utf-8") as f:
                out.extend(json.loads(line) for line in f if line.strip())
    return out


def test_set_mixture_weights_validates_and_fences():
    def run(name):
        pkg, out = PACKAGES[name], []
        with pkg.Dispatcher(mode="static", num_epochs=1).start() as disp:
            with pytest.raises(Exception, match="positive") as err:
                pkg.set_mixture_weights(disp.address, {"a": 0.0})
            out.append(str(err.value))
            set_reply = pkg.set_mixture_weights(disp.address, {"a": 1.0})
            set_reply.pop("entries")
            out.append(set_reply)
            from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

            with disp._lock:
                disp._bump_fencing_locked("test")
            with FramedConnection.connect(disp.address, timeout=5.0) as conn:
                reply, _ = conn.request({"type": "set_mixture_weights", "job_id": "default",
                                         "weights": {"a": 2.0}, "fencing_epoch": 0})
            out += [reply, pkg.get_mixture_weights(disp.address)["seq"]]
        return out

    port, jax = _both(run)
    assert port == jax
    assert port[2]["type"] == "stale_fencing" and port[3] == 1


def test_mixture_seq_idempotent_under_replayed_record():
    def run(name):
        disp = PACKAGES[name].Dispatcher(mode="static", num_epochs=1)
        with disp._lock:
            first = disp._install_mixture_locked("j", 1, {"a": 1.0}, None)
            again = disp._install_mixture_locked("j", 1, {"a": 9.0}, None)
        return first, again, disp.state_snapshot()["mixtures"]

    port, jax = _both(run)
    assert port == jax
    assert port[:2] == (True, False) and port[2]["j"]["entries"][0]["weights"] == {"a": 1.0}


def test_per_corpus_registration_and_piece_universes(token_dataset, token_dataset_b):
    url_a, _ = token_dataset
    url_b, _ = token_dataset_b

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1).start() as disp:
            wa = _token_worker(name, url_a, disp, corpus="a")
            wb = _token_worker(name, url_b, disp, corpus="b")
            try:
                snap = disp.state_snapshot()
                status = disp._handle({"type": "status"})
                bad = pkg.BatchWorker(url_b, dispatcher_address=disp.address, batch_size=8,
                                      reader_factory="row", corpus="a", register_retries=0,
                                      reader_kwargs=dict(READER_KWARGS),
                                      worker_id=f"llm-bad-{name}")
                with pytest.raises(RuntimeError, match="corpus 'a'") as err:
                    bad.start()
                bad.stop()
                workers = {w["corpus"] for w in snap["workers"].values()}
                return (snap["corpus_pieces"], workers, status["corpora"],
                        str(err.value).replace(f"llm-bad-{name}", "bad"))
            finally:
                wa.stop()
                wb.stop()

    port, jax = _both(run)
    assert port == jax
    assert port[0] == {"a": 4, "b": 3} == port[2]


# ---------------------------------------------------------------------------
# packed service runs (worker placement, end to end)
# ---------------------------------------------------------------------------

def test_packed_service_stream_deterministic_and_piece_aligned(token_dataset):
    url, _ = token_dataset

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1, shuffle_seed=7).start() as disp:
            worker = _token_worker(name, url, disp)
            try:
                runs = [list(pkg.ServiceBatchSource(disp.address, ordered=True,
                                                    packing=_spec(name))())
                        for _ in range(2)]
            finally:
                worker.stop()
        assert _digest(runs[0]) == _digest(runs[1])
        return runs[0]

    port, jax = _both(run)
    _assert_batches_equal(port, jax)
    assert all(b["tokens"].shape == (2, 64) for b in port)
    assert len(_unpacked_multiset(port)) == 40


def test_packed_placement_parity_worker_vs_trainer(token_dataset):
    """Both placements serve the same sequence multiset (worker packing
    flushes at each piece, trainer packing carries rows over); each
    placement's stream equals the JAX one's, batch for batch."""
    url, rows = token_dataset

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1, shuffle_seed=3).start() as disp:
            worker = _token_worker(name, url, disp)
            try:
                return {placement: list(pkg.PackedBatchSource(
                    pkg.ServiceBatchSource(disp.address, ordered=True), _spec(name),
                    placement=placement)()) for placement in ("worker", "trainer")}
            finally:
                worker.stop()

    port, jax = _both(run)
    for placement in ("worker", "trainer"):
        _assert_batches_equal(port[placement], jax[placement])
    documents = sorted(tuple(int(x) for x in row["tokens"][:row["length"]]) for row in rows)
    assert _unpacked_multiset(port["worker"]) == _unpacked_multiset(port["trainer"]) \
        == documents


def test_packed_resume_mid_pack_bit_exact(token_dataset):
    """Consume k packed batches, snapshot, rebuild from the snapshot: the
    concatenation is the uninterrupted run byte for byte; the snapshots
    equal the JAX source's, and each package resumes the other's."""
    url, _ = token_dataset

    def run(name):
        pkg, other = PACKAGES[name], PACKAGES["jax" if name == "port" else "port"]
        with pkg.Dispatcher(mode="static", num_epochs=1, shuffle_seed=11).start() as disp:
            worker = _token_worker(name, url, disp)
            try:
                full = list(pkg.ServiceBatchSource(disp.address, ordered=True,
                                                   packing=_spec(name))())
                states = []
                for cut in (1, 5, len(full) - 1):
                    source = pkg.ServiceBatchSource(disp.address, ordered=True,
                                                    packing=_spec(name))
                    it = source()
                    got = [next(it) for _ in range(cut)]
                    state = source.state_dict(yielded_batches=cut)
                    assert state["packing"] == SPEC
                    it.close()
                    states.append(state)
                    # The other package's client resumes this one's state.
                    resumed = other.ServiceBatchSource(disp.address, ordered=True,
                                                       packing=SPEC, resume_state=state)
                    got += list(resumed())
                    assert _digest(got) == _digest(full), f"cut={cut}"
            finally:
                worker.stop()
        return full, states

    port, jax = _both(run)
    _assert_batches_equal(port[0], jax[0])
    assert port[1] == jax[1]


def test_packed_resume_refuses_spec_mismatch(token_dataset):
    url, _ = token_dataset

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1).start() as disp:
            worker = _token_worker(name, url, disp)
            try:
                source = pkg.ServiceBatchSource(disp.address, ordered=True,
                                                packing=_spec(name))
                it = source()
                next(it)
                state = source.state_dict(yielded_batches=1)
                it.close()
                with pytest.raises(ValueError, match="packing mismatch") as err:
                    pkg.ServiceBatchSource(disp.address, ordered=True,
                                           packing=_spec(name, slot_len=32, slots=4),
                                           resume_state=state)
                with pytest.raises(ValueError, match="packing mismatch") as err_rows:
                    pkg.ServiceBatchSource(disp.address, ordered=True, resume_state=state)
                return str(err.value), str(err_rows.value)
            finally:
                worker.stop()

    port, jax = _both(run)
    assert port == jax


def test_packed_cache_entries_hold_packed_frames(token_dataset):
    """Cache and packing: the second epoch serves every piece warm with the
    entries' batch counts equal to the packed emission, byte for byte; the
    worker's cache keys equal the JAX worker's."""
    url, _ = token_dataset

    def run(name):
        pkg = PACKAGES[name]
        if name == "port":
            from petastorm_tpu_torch.cache_impl import CacheConfig
        else:
            from petastorm_tpu.cache_impl import CacheConfig
        with pkg.Dispatcher(mode="static", num_epochs=2).start() as disp:
            worker = _token_worker(name, url, disp,
                                   batch_cache=CacheConfig(mode="mem", mem_mb=64.0).build())
            try:
                batches = list(pkg.ServiceBatchSource(disp.address, ordered=True,
                                                      packing=_spec(name))())
                by_epoch = worker.cache_stats_by_epoch()
                counts = {key: entry.num_batches
                          for key, entry in worker._batch_cache._entries.items()}
                plain_key = worker._piece_cache_key(0)
            finally:
                worker.stop()
        half = len(batches) // 2
        assert by_epoch[0]["misses"] == 4 and by_epoch[0]["hits"] == 0
        assert by_epoch[1]["hits"] == 4 and by_epoch[1]["misses"] == 0
        assert _digest(batches[:half]) == _digest(batches[half:])
        assert len(counts) == 4 and sum(counts.values()) == half < 40
        assert plain_key not in counts  # a packed entry never serves rows
        return batches, counts

    port, jax = _both(run)
    _assert_batches_equal(port[0], jax[0])
    assert port[1] == jax[1]


def test_packing_rejected_on_fcfs_and_with_transform(token_dataset):
    url, _ = token_dataset

    def run(name):
        pkg, messages = PACKAGES[name], []
        for kwargs in ({"transform": lambda b: b},
                       {"predicate": {"field": "length", "op": "ge", "value": 3}}):
            with pytest.raises(ValueError, match="cannot combine") as err:
                pkg.ServiceBatchSource(("127.0.0.1", 1), packing=_spec(name), **kwargs)
            messages.append(str(err.value))
        with pkg.Dispatcher(mode="fcfs", num_epochs=1).start() as disp:
            worker = _token_worker(name, url, disp)
            try:
                for kwargs in ({"packing": _spec(name)}, {"corpus": "zz"}):
                    with pytest.raises(ValueError, match="fcfs") as err:
                        pkg.ServiceBatchSource(disp.address, **kwargs)()
                    messages.append(str(err.value))
            finally:
                worker.stop()
        return messages

    port, jax = _both(run)
    assert port == jax


def test_worker_refuses_packing_where_it_cannot_pack(token_dataset):
    """A stream asking a worker to pack where it cannot (an untagged
    stream, or a worker with a batch transform armed) is refused with the
    JAX worker's words."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    url, _ = token_dataset

    def run(name):
        pkg, replies = PACKAGES[name], []
        with pkg.Dispatcher(mode="static", num_epochs=1).start() as disp:
            plain = _token_worker(name, url, disp)
            transformed = _token_worker(name, url, disp, batch_transform=lambda b: b)
            try:
                for worker, extra in ((plain, {}), (transformed, {"tagged": True})):
                    with FramedConnection.connect(worker.address, timeout=5) as conn:
                        replies.append(conn.request(dict(
                            {"type": "stream", "pieces": [0], "epoch": 0,
                             "packing": SPEC}, **extra))[0])
            finally:
                plain.stop()
                transformed.stop()
        return replies

    port, jax = _both(run)
    assert port == jax
    assert all(reply["type"] == "error" for reply in port)


# ---------------------------------------------------------------------------
# multi-corpus mixtures through one dispatcher
# ---------------------------------------------------------------------------

def _mixture(name, disp, seed=17, weights=None, exhaustion="stop", packing=True):
    pkg = PACKAGES[name]

    def factory(corpus):
        return lambda: pkg.ServiceBatchSource(disp.address, corpus=corpus, ordered=True,
                                              packing=_spec(name) if packing else None)

    return pkg.MixedBatchSource({"a": factory("a"), "b": factory("b")},
                                weights=dict(weights or {"a": 0.6, "b": 0.4}), seed=seed,
                                exhaustion=exhaustion, dispatcher_address=disp.address,
                                factories=True)


class _CorpusFleet:
    """One dispatcher of a package with a worker for corpus a and one for b."""

    def __init__(self, name, url_a, url_b, **dispatcher_kwargs):
        pkg = PACKAGES[name]
        self.disp = pkg.Dispatcher(mode="static", num_epochs=1, **dispatcher_kwargs).start()
        self.workers = [_token_worker(name, url_a, self.disp, corpus="a"),
                        _token_worker(name, url_b, self.disp, corpus="b")]

    def __enter__(self):
        return self.disp

    def __exit__(self, *exc):
        for worker in self.workers:
            worker.stop()
        self.disp.stop()


def test_mixed_packed_service_digest_pure_function_of_seed_and_log(token_dataset,
                                                                   token_dataset_b):
    def run(name):
        with _CorpusFleet(name, token_dataset[0], token_dataset_b[0], shuffle_seed=23) as disp:
            digests = [_digest(list(_mixture(name, disp)())) for _ in range(2)]
            other = _digest(list(_mixture(name, disp, seed=18)()))
        assert digests[0] == digests[1] != other
        return digests[0], other

    port, jax = _both(run)
    assert port == jax


def test_mixture_weight_reload_applies_at_pass_boundary(token_dataset, token_dataset_b):
    def run(name):
        with _CorpusFleet(name, token_dataset[0], token_dataset_b[0], shuffle_seed=23) as disp:
            mix = _mixture(name, disp, weights={"a": 0.9, "b": 0.1})
            first = list(mix())
            pass1 = dict(mix.diagnostics["mixture"]["draws"])
            reply = PACKAGES[name].set_mixture_weights(disp.address, {"a": 0.1, "b": 0.9},
                                                       effective_epoch=1)
            second = list(mix())
            pass2 = dict(mix.diagnostics["mixture"]["draws"])
            weights = mix.diagnostics["mixture"]["weights"]
        assert reply["seq"] == 1
        assert pass1.get("a", 0) / max(sum(pass1.values()), 1) > 0.6
        assert pass2.get("b", 0) / max(sum(pass2.values()), 1) > 0.6
        assert weights == {"a": 0.1, "b": 0.9}
        return _digest(first), _digest(second), pass1, pass2

    port, jax = _both(run)
    assert port == jax


def test_mixture_reload_reproducible_from_log(token_dataset, token_dataset_b):
    """Same seed and same weight-change log: the same two-pass stream,
    reload included, in both packages."""
    def run(name):
        with _CorpusFleet(name, token_dataset[0], token_dataset_b[0], shuffle_seed=31) as disp:
            PACKAGES[name].set_mixture_weights(disp.address, {"a": 0.2, "b": 0.8},
                                               effective_epoch=1)

            def two_pass_digest():
                mix = _mixture(name, disp, weights={"a": 0.8, "b": 0.2})
                return _digest(list(mix()) + list(mix()))

            digests = [two_pass_digest(), two_pass_digest()]
        assert digests[0] == digests[1]
        return digests[0]

    port, jax = _both(run)
    assert port == jax


@pytest.mark.slow
def test_packed_mixed_shuffled_worker_kill_byte_identical(token_dataset, token_dataset_b):
    """A packed, mixed, shuffled two-pass run with a worker killed mid-pass
    loses and repeats nothing: its digest is the unperturbed run's, and the
    JAX package's."""
    url_a, url_b = token_dataset[0], token_dataset_b[0]

    def run(name, kill):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1, shuffle_seed=41).start() as disp:
            workers = [_token_worker(name, url, disp, corpus=corpus)
                       for url, corpus in ((url_a, "a"), (url_a, "a"), (url_b, "b"),
                                           (url_b, "b"))]
            try:
                batches = []
                mix = _mixture(name, disp, seed=43, weights={"a": 0.5, "b": 0.5})
                for pass_index in range(2):
                    it = iter(mix())
                    first = next(it, None)
                    if first is not None:
                        batches.append(first)
                    if kill and pass_index == 0:
                        workers[0].kill()
                    batches.extend(it)
                return batches
            finally:
                for worker in workers:
                    worker.stop()

    clean = run("port", kill=False)
    chaotic = run("port", kill=True)
    assert len(chaotic) == len(clean)
    assert _digest(chaotic) == _digest(clean) == _digest(run("jax", kill=False))


# ---------------------------------------------------------------------------
# the pipeline graph: the pack stage and its placement knob
# ---------------------------------------------------------------------------

def test_graph_declares_pack_stage_and_placement_knob():
    from petastorm_tpu.jax_utils.loader import JaxDataLoader
    from petastorm_tpu.pipeline.graph import build_loader_graph as jax_graph
    from petastorm_tpu_torch.pipeline.graph import build_loader_graph
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    def graphs(name, packed):
        pkg = PACKAGES[name]
        source = pkg.ServiceBatchSource(("127.0.0.1", 1))
        if packed:
            source = pkg.PackedBatchSource(source, _spec(name), placement="worker")
        if name == "port":
            graph = build_loader_graph(TorchDataLoader(None, batch_source=source,
                                                       device="cpu"))
        else:
            graph = jax_graph(JaxDataLoader(None, 2, batch_source=source,
                                            stage_to_device=False))
        return source, graph

    def view(graph):
        nodes = [(n.name, n.side, n.placement, n.flippable, n.fuse_group)
                 for n in graph.nodes.values() if n.side == "worker"]
        knobs = {k: graph.knobs[k].descriptor() for k in sorted(graph.knobs)
                 if k == "packing_placement"}
        return nodes, sorted(e for e in graph.edges if "pack" in e), knobs

    (source, graph), (jax_source, twin) = graphs("port", True), graphs("jax", True)
    assert view(graph) == view(twin)
    pack = graph.node("pack")
    assert pack.placement == "worker" and ("collate", "pack") in graph.edges \
        and ("pack", "serialize") in graph.edges
    knob = graph.knobs["packing_placement"]
    assert tuple(knob.descriptor()["choices"]) == ("worker", "trainer")
    knob.set("trainer")
    twin.knobs["packing_placement"].set("trainer")
    assert source.packing_placement == jax_source.packing_placement == "trainer"
    assert graph.node("pack").placement == "trainer"
    assert view(graph) == view(twin)
    _, plain = graphs("port", False)
    with pytest.raises(KeyError):
        plain.node("pack")
    assert "packing_placement" not in plain.knobs


def test_packed_dynamic_two_epochs_deterministic(token_dataset):
    """Dynamic sharding and packing: a two-epoch packed run over two
    workers repeats byte for byte, and equals the JAX fleet's stream."""
    url, _ = token_dataset

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="dynamic", num_epochs=2, shuffle_seed=9).start() as disp:
            workers = [_token_worker(name, url, disp, worker_id=f"dyn-{name}-{i}")
                       for i in range(2)]
            try:
                runs = [list(pkg.ServiceBatchSource(disp.address, ordered=True,
                                                    packing=_spec(name),
                                                    dynamic_sync_interval_s=0.1)())
                        for _ in range(2)]
            finally:
                for worker in workers:
                    worker.stop()
        assert _digest(runs[0]) == _digest(runs[1])
        half = len(runs[0]) // 2
        assert _unpacked_multiset(runs[0][:half]) == _unpacked_multiset(runs[0][half:])
        return runs[0]

    port, jax = _both(run)
    _assert_batches_equal(port, jax)


# ---------------------------------------------------------------------------
# corpus-scoped quarantine, the retry token, bad log entries, resumes
# ---------------------------------------------------------------------------

def test_quarantine_is_corpus_scoped():
    """Corpus a's poison piece 3 does not block corpus b's piece 3, which
    stays quarantinable on its own; the snapshots are equal and each
    package loads the other's."""
    def run(name):
        disp = PACKAGES[name].Dispatcher(mode="static", num_epochs=1)
        with disp._lock:
            out = [disp._quarantine_piece_locked(3, {"corpus": "a", "error": "boom"}),
                   disp._grantable_pieces_locked([1, 3], corpus="b"),
                   disp._grantable_pieces_locked([1, 3], corpus="a"),
                   disp._quarantine_piece_locked(3, {"corpus": "b", "error": "boom"}),
                   disp._grantable_pieces_locked([3], corpus="b")]
        return out, disp.state_snapshot()

    port, jax = _both(run)
    assert port == jax
    assert port[0] == [True, [1, 3], [1], True, []]
    assert set(port[1]["quarantined"]) == {"a:3", "b:3"}
    for reader, snap in (("port", jax[1]), ("jax", port[1])):
        disp = PACKAGES[reader].Dispatcher(mode="static", num_epochs=1)
        with disp._lock:
            disp._install_state_locked(snap)
            assert disp._grantable_pieces_locked([3], corpus="a") == []
            assert disp._grantable_pieces_locked([3], corpus="") == [3]
        assert disp.state_snapshot() == snap


def test_set_mixture_weights_retry_token_is_idempotent():
    """A retried request with the same token answers for the journaled
    entry instead of appending a second one."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1).start() as disp:
            replies = []
            for _ in range(2):
                with FramedConnection.connect(disp.address, timeout=5.0) as conn:
                    replies.append(conn.request({"type": "set_mixture_weights",
                                                 "job_id": "default", "weights": {"a": 1.0},
                                                 "token": "tok-1"})[0])
            return replies, pkg.get_mixture_weights(disp.address)

    port, jax = _both(run)
    assert port == jax
    assert [r["seq"] for r in port[0]] == [1, 1] and port[1]["seq"] == 1


class _OneBatch:
    def __call__(self):
        return iter([{"tokens": np.zeros((1, 4), np.int32),
                      "length": np.asarray([2], np.int32)}])


def test_bad_weight_log_entry_does_not_wedge_the_mixture():
    """A journaled entry naming an unknown corpus is dropped; the mix serves
    on and a corrected later entry still applies."""
    def run(name):
        mix = PACKAGES[name].MixedBatchSource({"a": _OneBatch(), "b": _OneBatch()},
                                              {"a": 0.5, "b": 0.5}, seed=3, exhaustion="stop")
        mix._pending_entries = [
            {"seq": 1, "weights": {"typo": 1.0}, "effective_epoch": 0},
            {"seq": 2, "weights": {"a": 0.9, "b": 0.1}, "effective_epoch": 0}]
        batches = list(mix())
        return len(batches), mix._applied_seq, mix.diagnostics["mixture"], mix.state_dict()

    port, jax = _both(run)
    assert port == jax
    assert port[0] and port[1] == 2 and port[2]["weights"] == {"a": 0.9, "b": 0.1}


def test_packed_source_checkpoint_of_a_resume_is_exact():
    """Checkpoint, resume, checkpoint again, resume again: still the
    uninterrupted stream, and every snapshot equals the JAX one."""
    lengths = [5, 30, 11, 7, 22, 3, 18, 9, 27, 4, 15, 8, 21, 6, 13]

    def run(name):
        pkg = PACKAGES[name]
        spec = pkg.PackingSpec(32, 2, ["tokens"], length_field="length")
        full = list(pkg.PackedBatchSource(_ListSource(_row_batches(lengths)), spec,
                                          placement="trainer")())
        snapshots = []
        for cut1 in (1, 2, 3):
            for cut2 in (0, 1, 2):
                if cut1 + cut2 >= len(full):
                    continue
                w1 = pkg.PackedBatchSource(_ListSource(_row_batches(lengths)), spec,
                                           placement="trainer")
                it1 = w1()
                got = [next(it1) for _ in range(cut1)]
                s1 = w1.state_dict(yielded_batches=cut1)
                it1.close()
                w2 = pkg.PackedBatchSource(_ListSource(_row_batches(lengths),
                                                       resume=s1["inner"]),
                                           spec, placement="trainer", resume_state=s1)
                it2 = w2()
                got += [next(it2) for _ in range(cut2)]
                s2 = w2.state_dict(yielded_batches=cut2)
                it2.close()
                w3 = pkg.PackedBatchSource(_ListSource(_row_batches(lengths),
                                                       resume=s2["inner"]),
                                           spec, placement="trainer", resume_state=s2)
                got += list(w3())
                _assert_batches_equal(got, full)
                snapshots.append((s1, s2))
        return full, snapshots

    port, jax = _both(run)
    _assert_batches_equal(port[0], jax[0])
    assert port[1] == jax[1]


def test_mid_pass_mixture_resume_does_not_apply_pending_entries(token_dataset,
                                                                token_dataset_b):
    """A weight entry landing mid-pass applies at the next pass boundary; a
    mid-pass resume stages it instead of applying it, so the resumed stream
    is the uninterrupted one, in both packages."""
    def run(name):
        pkg = PACKAGES[name]
        with _CorpusFleet(name, token_dataset[0], token_dataset_b[0], shuffle_seed=53) as disp:
            def build(resume=None, inner_resumes=None):
                def factory(corpus):
                    def make(_epoch=None):
                        return pkg.ServiceBatchSource(
                            disp.address, corpus=corpus, ordered=True, packing=_spec(name),
                            resume_state=(inner_resumes or {}).get(corpus))
                    return make
                return pkg.MixedBatchSource({"a": factory("a"), "b": factory("b")},
                                            weights={"a": 0.5, "b": 0.5}, seed=61,
                                            exhaustion="stop",
                                            dispatcher_address=disp.address,
                                            factories=True, resume_state=resume)

            clean_it = build()()
            mix = build()
            it = mix()
            got = [next(it) for _ in range(2)]
            pkg.set_mixture_weights(disp.address, {"a": 0.9, "b": 0.1})
            clean = list(clean_it)
            state = mix.state_dict(yielded_batches=2)
            it.close()
            got += list(build(resume=state, inner_resumes=state["inner"])())
        assert _digest(got) == _digest(clean)
        return _digest(clean), {k: v for k, v in state.items() if k != "inner"}

    port, jax = _both(run)
    assert port == jax


def test_reweight_last_corpus_exhaustion_ends_cleanly():
    def run(name):
        sampler = PACKAGES[name].MixtureSampler(3, {"x": 0.5, "y": 0.5}, exhaustion="reweight")
        sampler.draw()
        redraw = sampler.mark_exhausted("x")
        with pytest.raises(MIXTURE[name].MixtureExhausted) as err:
            sampler.mark_exhausted("y")
        return redraw, str(err.value), sampler.state_dict()

    port, jax = _both(run)
    assert port == jax
    assert port[0] == "y"


def test_zero_weight_corpus_sources_not_opened():
    def run(name):
        opened = []

        def factory(corpus):
            def make():
                opened.append(corpus)
                return _ListSource(_row_batches([4, 5]))
            return make

        mix = PACKAGES[name].MixedBatchSource({"a": factory("a"), "b": factory("b")},
                                              {"a": 1.0, "b": 0.0}, seed=5,
                                              exhaustion="stop", factories=True)
        batches = list(mix())
        return batches, opened, mix.state_dict()

    port, jax = _both(run)
    _assert_batches_equal(port[0], jax[0])
    assert port[1:] == jax[1:]
    assert port[0] and port[1] == ["a"] and "b" not in port[2]["inner"]


def test_worker_resume_snapshot_not_misapplied_after_flip(token_dataset):
    """A worker-placement resume snapshot is consumed by the worker pass; a
    later trainer iteration starts clean."""
    url, _ = token_dataset

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1, shuffle_seed=3).start() as disp:
            worker = _token_worker(name, url, disp)
            try:
                wrapped = pkg.PackedBatchSource(
                    pkg.ServiceBatchSource(disp.address, ordered=True, packing=_spec(name)),
                    _spec(name), placement="worker")
                it = wrapped()
                first = next(it)
                state = wrapped.state_dict(yielded_batches=1)
                it.close()
                w2 = pkg.PackedBatchSource(
                    pkg.ServiceBatchSource(disp.address, ordered=True, packing=_spec(name),
                                           resume_state=state["inner"]),
                    _spec(name), resume_state=state)
                rest = list(w2())
                assert w2._resume is None and rest
                w3 = pkg.PackedBatchSource(pkg.ServiceBatchSource(disp.address, ordered=True),
                                           _spec(name), resume_state=state)
                w3.set_packing_placement("trainer")
                flipped = list(w3())
                fresh = list(pkg.PackedBatchSource(
                    pkg.ServiceBatchSource(disp.address, ordered=True), _spec(name),
                    placement="trainer")())
                assert _digest(flipped) == _digest(fresh)
                return [first] + rest, flipped, state
            finally:
                worker.stop()

    port, jax = _both(run)
    _assert_batches_equal(port[0], jax[0])
    _assert_batches_equal(port[1], jax[1])
    assert port[2] == jax[2]


# ---------------------------------------------------------------------------
# the slice as a whole: worker-packed service batches train the LM
# ---------------------------------------------------------------------------

def test_worker_packed_batches_train_the_lm_as_the_capstone(tmp_path):
    """The capstone's corpus served by two workers that pack it (slot_len
    64, 2 slots): the port's stream equals the JAX fleet's byte for byte,
    and three SGD steps of the port's LM on it (flash attention, its plain
    version on the CPU) follow the JAX capstone's steps on carried-over
    weights within 1e-4 of the loss."""
    import jax
    import jax.numpy as jnp
    import torch

    from examples.long_context_lm import train_lm as capstone
    from petastorm_tpu_torch.models.long_context_lm import (
        generate_corpus,
        make_lm_train_step,
        params_from_jax,
    )
    from petastorm_tpu_torch.service.packing_stage import PACK_POSITION_KEY

    url = generate_corpus(f"file://{tmp_path}/corpus", docs=192, max_len=32)
    spec = dict(SPEC, slot_len=64, slots=2)

    def run(name):
        pkg = PACKAGES[name]
        with pkg.Dispatcher(mode="static", num_epochs=1, shuffle_seed=5).start() as disp:
            workers = [PACKAGES[name].BatchWorker(
                url, dispatcher_address=disp.address, batch_size=16, reader_factory="row",
                worker_id=f"lm-{name}-{i}-{uuid.uuid4().hex[:6]}",
                reader_kwargs={"reader_pool_type": "thread", "workers_count": 1}).start()
                for i in range(2)]
            try:
                return list(pkg.ServiceBatchSource(disp.address, ordered=True,
                                                   packing=spec)())
            finally:
                for worker in workers:
                    worker.stop()

    port, jax_batches = _both(run)
    _assert_batches_equal(port, jax_batches)
    params = capstone.init_lm_params(jax.random.PRNGKey(0), d_model=32, num_heads=2,
                                     num_layers=2, slot_len=64)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), 2, device="cpu")
    jax_step = jax.jit(capstone.make_lm_train_step(2))
    port_step = make_lm_train_step(model)
    losses = []
    for batch in port[:3]:
        arrays = (batch["tokens"], batch[PACK_POSITION_KEY], batch[PACK_SEGMENT_KEY])
        params, want = jax_step(params, *map(jnp.asarray, arrays))
        got = float(port_step(*(torch.from_numpy(np.asarray(x)) for x in arrays)))
        assert abs(got - float(want)) <= 1e-4 * abs(float(want))
        losses.append(got)
    assert np.isfinite(losses).all()
