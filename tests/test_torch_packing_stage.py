"""The packing stage (``petastorm_tpu_torch/service/packing_stage.py``) and
its place in the streaming piece engine, against the JAX package.

- ``StreamPacker`` emits what both packages' ``pack_ragged`` emit for the
  same seeded rows (row by row and batch by batch, with a length column),
  and what the JAX ``StreamPacker`` emits, under ``hypothesis`` lengths.
- A packer state serialized by either package loads in the other and
  continues the same packed stream; the two serializations are equal
  JSON. A spec mismatch, an unknown version and a torn state (the
  ``packing.state`` failpoint) are refused with the JAX words.
- ``PackingCollator`` over the engine's piece collator equals the JAX one;
  the engine with a ``packer_factory`` gives the JAX engine's events over
  the token store (ordinals number packed batches), and a warm pass from
  its ``BatchCache`` serves the same packed frames and builds no reader.
- The ``petastorm_packing_*`` series move as the JAX ones do.
- A packed batch through the port's ``flash_attention`` (its plain version
  on the CPU) equals the JAX ``flash_attention`` on the same batch within
  1e-5.

Tolerance: exact (byte for byte) everywhere but the attention outputs.
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from petastorm_tpu import failpoints as jax_fp
from petastorm_tpu.jax_utils.packing import pack_ragged as jax_pack_ragged
from petastorm_tpu.service import packing_stage as jax_stage
from petastorm_tpu_torch import failpoints as port_fp
from petastorm_tpu_torch.service import packing_stage as stage
from petastorm_tpu_torch.torch_utils.packing import pack_ragged

STAGES = {"port": stage, "jax": jax_stage}
FAILPOINTS = {"port": port_fp, "jax": jax_fp}


@pytest.fixture(autouse=True)
def _port_schedule_guard():
    """Fail a test that leaves a port schedule armed (the shared guard
    watches the JAX package's)."""
    yield
    armed = port_fp.ACTIVE is not None
    if armed:
        port_fp.disarm()
    assert not armed, "a port FaultSchedule outlived its test"


def _token_rows(lengths, seed=3, extra=False):
    rng = np.random.RandomState(seed)
    rows = []
    for n in lengths:
        row = {"tokens": rng.randint(1, 1000, size=int(n)).astype(np.int32)}
        if extra:
            row["emb"] = rng.rand(int(n), 3).astype(np.float32)
        rows.append(row)
    return rows


def _spec(name, slot_len=16, slots=2, fields=("tokens",), length_field=None):
    return STAGES[name].PackingSpec(slot_len=slot_len, slots=slots,
                                    sequence_fields=list(fields), length_field=length_field)


def _feed_rows(packer, rows):
    out = []
    for row in rows:
        out.extend(packer.add_row(row))
    tail = packer.flush()
    return out + ([tail] if tail is not None else [])


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), strict=True)


@pytest.mark.parametrize("seed", [0, 1, 11])
def test_stream_packer_matches_pack_ragged(seed):
    """One first-fit semantics: both packers and both whole-stream
    generators emit the same batches."""
    rng = np.random.RandomState(seed)
    rows = _token_rows(list(rng.randint(0, 17, size=60)), seed=seed, extra=True)
    fields = ("tokens", "emb")
    port = _feed_rows(stage.StreamPacker(_spec("port", fields=fields)), rows)
    jax = _feed_rows(jax_stage.StreamPacker(_spec("jax", fields=fields)), rows)
    _assert_batches_equal(port, jax)
    _assert_batches_equal(port, list(pack_ragged(iter(rows), 16, 2, keys=list(fields))))
    _assert_batches_equal(port, list(jax_pack_ragged(iter(rows), 16, 2, keys=list(fields))))


@settings(max_examples=40, deadline=None)
@given(lengths=st.lists(st.integers(0, 24), min_size=1, max_size=40),
       slots=st.integers(1, 4), slot_len=st.sampled_from([24, 32, 40]))
def test_stream_packer_equals_jax_under_hypothesis(lengths, slots, slot_len):
    rows = _token_rows(lengths, seed=len(lengths))
    port = _feed_rows(stage.StreamPacker(_spec("port", slot_len, slots)), rows)
    jax = _feed_rows(jax_stage.StreamPacker(_spec("jax", slot_len, slots)), rows)
    _assert_batches_equal(port, jax)
    assert [stage.packed_token_count(b) for b in port] == \
        [jax_stage.packed_token_count(b) for b in jax]


def test_add_batch_with_a_length_column_equals_jax():
    """Collated row batches with a length column (the ragged-in-Parquet
    layout) and a field the spec drops: the packed batches and the
    counters equal the JAX packer's, and a missing length column is
    refused with the JAX words."""
    rng = np.random.RandomState(5)
    lengths = rng.randint(1, 30, size=24)
    tokens = np.zeros((24, 32), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(1, 999, size=n)
    batches = [{"tokens": tokens[i:i + 8], "length": lengths[i:i + 8].astype(np.int32),
                "id": np.arange(i, i + 8)} for i in range(0, 24, 8)]

    def run(name):
        packer = STAGES[name].StreamPacker(_spec(name, 32, 3, length_field="length"))
        out = []
        for batch in batches:
            out.extend(packer.add_batch(batch))
        out.append(packer.flush())
        return out, packer.stats()

    port, jax = run("port"), run("jax")
    _assert_batches_equal(port[0], jax[0])
    assert port[1] == jax[1]
    with pytest.raises(ValueError, match="length_field") as err:
        stage.StreamPacker(_spec("port", length_field="n")).add_batch({"tokens": tokens})
    with pytest.raises(ValueError, match="length_field") as jax_err:
        jax_stage.StreamPacker(_spec("jax", length_field="n")).add_batch({"tokens": tokens})
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("cut", [0, 7, 25, 39])
def test_packer_states_cross_the_packages(cut):
    """A snapshot taken mid-pack by either package is the same JSON, and
    each package's packer continues the other's stream bit for bit."""
    rng = np.random.RandomState(7)
    rows = _token_rows(list(rng.randint(1, 16, size=40)), seed=7)
    fulls, states = {}, {}
    for name in STAGES:
        packer = STAGES[name].StreamPacker(_spec(name))
        head = []
        for row in rows[:cut]:
            head.extend(packer.add_row(row))
        states[name] = json.loads(json.dumps(packer.state_dict()))
        fulls[name] = head + _feed_rows(packer, rows[cut:])
    assert states["port"] == states["jax"]
    _assert_batches_equal(fulls["port"], fulls["jax"])
    for reader, writer in (("port", "jax"), ("jax", "port")):
        packer = STAGES[reader].StreamPacker(_spec(reader))
        packer.load_state_dict(states[writer])
        rest = _feed_rows(packer, rows[cut:])
        _assert_batches_equal(fulls[writer][len(fulls[writer]) - len(rest):], rest)


def test_packer_refusals_equal_jax():
    """A spec mismatch, an unknown version and a torn snapshot are refused
    with the JAX words; the intact snapshot still restores."""
    def run(name):
        mod, fp, messages = STAGES[name], FAILPOINTS[name], []
        packer = mod.StreamPacker(_spec(name))
        packer.add_row({"tokens": np.arange(5, dtype=np.int32)})
        for target, state in ((mod.StreamPacker(_spec(name, slot_len=32)), packer.state_dict()),
                              (mod.StreamPacker(_spec(name)), {"version": 9})):
            with pytest.raises(mod.PackingStateError) as err:
                target.load_state_dict(state)
            messages.append(str(err.value))
        schedule = fp.FaultSchedule(seed=0, points=("packing.state",),
                                    fires={"packing.state": {0: "torn"}})
        with fp.armed(schedule):
            torn = packer.state_dict()
        assert schedule.log == [("packing.state", 0, "torn")]
        fresh = mod.StreamPacker(_spec(name))
        with pytest.raises(mod.PackingStateError, match="crc|torn") as err:
            fresh.load_state_dict(torn)
        messages.append(str(err.value))
        fresh.load_state_dict(packer.state_dict())
        assert fresh.open_sequences == packer.open_sequences == 1
        return messages, torn

    port, jax = run("port"), run("jax")
    assert port == jax


def test_packing_collator_equals_jax():
    """The worker-side adapter over the engine's piece collator: the same
    complete batches from ``add`` and the same piece-boundary drain."""
    from petastorm_tpu.service.piece_engine import _PieceCollator as JaxCollator
    from petastorm_tpu_torch.service.piece_engine import _PieceCollator

    rng = np.random.RandomState(2)
    outputs = []
    for i in range(23):
        n = int(rng.randint(1, 20))
        tokens = np.zeros(24, np.int32)
        tokens[:n] = rng.randint(1, 999, size=n)
        outputs.append({"tokens": tokens, "length": np.int32(n)})

    def run(name, collator_cls):
        collator = STAGES[name].PackingCollator(
            collator_cls(5, False, None),
            STAGES[name].StreamPacker(_spec(name, 24, 2, length_field="length"),
                                      placement="worker"))
        out = []
        for output in outputs:
            out.extend(collator.add(output))
        return out + collator.flush_all()

    _assert_batches_equal(run("port", _PieceCollator), run("jax", JaxCollator))


@pytest.fixture(scope="module")
def token_store(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_token_dataset

    url = f"file://{tmp_path_factory.mktemp('packing_stage')}/tok"
    create_test_token_dataset(url, rows_count=40, rows_per_row_group=10)
    return url


def _engine_events(name, url, cache=None, permute=None):
    if name == "port":
        from petastorm_tpu_torch.reader.reader import make_reader
        from petastorm_tpu_torch.reader_impl.framed_socket import decode_payload
        from petastorm_tpu_torch.service.piece_engine import StreamingPieceEngine
    else:
        from petastorm_tpu.reader.reader import make_reader
        from petastorm_tpu.reader_impl.framed_socket import decode_payload
        from petastorm_tpu.service.piece_engine import StreamingPieceEngine
    built = []

    def build():
        built.append(1)
        return make_reader(url, dynamic_ventilation=True, num_epochs=1,
                           shuffle_row_groups=False, cur_shard=0, shard_count=1,
                           reader_pool_type="thread", workers_count=1,
                           schema_fields=["tokens", "length"])

    spec = _spec(name, 64, 2, length_field="length")
    engine = StreamingPieceEngine(
        build, 8, cache=cache, cache_key_fn=(lambda piece: f"tok-{piece}") if cache else None,
        permute_fn=permute,
        packer_factory=lambda: STAGES[name].StreamPacker(spec, placement="worker"))
    for piece, start in ((2, 0), (0, 1), (3, 0), (1, 0)):
        engine.enqueue(piece, 4, start=start)
    engine.finish()
    events = []
    try:
        while not engine.finished:
            event = engine.next_event(timeout=0.2)
            if event is None:
                continue
            if event[0] == "batch":
                _, piece, gen, ordinal, rows, fmt, frames, _ = event
                events.append(("batch", piece, gen, ordinal, rows,
                               decode_payload(fmt, [bytes(f) for f in frames])))
            else:
                events.append(tuple(event))
    finally:
        engine.stop()
        engine.join()
    return events, len(built)


def test_packed_engine_events_equal_jax(token_store):
    """Worker-placed packing in the engine: the events (piece, generation,
    packed ordinal, slots) and the packed arrays equal the JAX engine's,
    from a start watermark on and under a serve-time permutation; a warm
    pass from each package's cache serves the same frames and builds no
    reader."""
    from petastorm_tpu.cache_impl import BatchCache as JaxBatchCache
    from petastorm_tpu_torch.cache_impl import BatchCache

    def permute(piece, n):
        return list(reversed(range(n)))

    for permute_fn in (None, permute):
        port, jax = _engine_events("port", token_store, permute=permute_fn), \
            _engine_events("jax", token_store, permute=permute_fn)
        assert [e[:5] for e in port[0]] == [e[:5] for e in jax[0]]
        _assert_batches_equal([e[5] for e in port[0] if e[0] == "batch"],
                              [e[5] for e in jax[0] if e[0] == "batch"])
    batches = [e for e in port[0] if e[0] == "batch"]
    assert all(e[4] == 2 for e in batches)  # the slots of a packed batch
    assert min(e[3] for e in batches if e[1] == 0) == 1  # piece 0 from its watermark
    caches = {"port": BatchCache(mem_budget_bytes=16 << 20),
              "jax": JaxBatchCache(mem_budget_bytes=16 << 20)}
    try:
        cold = {name: _engine_events(name, token_store, cache=caches[name]) for name in caches}
        warm = {name: _engine_events(name, token_store, cache=caches[name]) for name in caches}
    finally:
        for cache in caches.values():
            cache.cleanup()
    assert warm["port"][1] == warm["jax"][1] == 0  # no reader on a warm pass
    for name in caches:
        assert [e[:5] for e in warm[name][0]] == [e[:5] for e in cold[name][0]]
    _assert_batches_equal([e[5] for e in warm["port"][0] if e[0] == "batch"],
                          [e[5] for e in cold["jax"][0] if e[0] == "batch"])


def test_packing_series_move_as_jax():
    """The same rows through a trainer-placed packer of each package move
    the ``petastorm_packing_*`` batches, sequences and tokens series by the
    same amounts, and leave the same fill ratio."""
    from petastorm_tpu.telemetry import metrics as jax_metrics
    from petastorm_tpu_torch.telemetry import metrics as port_metrics

    rows = _token_rows(list(np.random.RandomState(9).randint(1, 17, size=50)), seed=9)

    def run(name, metrics):
        families = (metrics.PACKING_BATCHES, metrics.PACKING_SEQUENCES, metrics.PACKING_TOKENS)
        before = [f.labels("trainer").value for f in families]
        count = metrics.PACKING_SECONDS.labels("trainer").count
        _feed_rows(STAGES[name].StreamPacker(_spec(name), placement="trainer"), rows)
        return ([f.labels("trainer").value - b for f, b in zip(families, before)],
                metrics.PACKING_SECONDS.labels("trainer").count - count,
                metrics.PACKING_FILL_RATIO.labels("trainer").value)

    port, jax = run("port", port_metrics), run("jax", jax_metrics)
    assert port == jax
    assert port[0][1] == 50 and port[1] == 50


def test_packed_batch_through_flash_equals_jax():
    """The stage's layout through the attention kernel: a packed batch of
    the port's ``StreamPacker`` through the port's ``flash_attention`` with
    ``segment_ids`` (its plain version on the CPU) equals the JAX
    ``flash_attention`` on the JAX packer's batch, within 1e-5."""
    import jax.numpy as jnp
    import torch

    from petastorm_tpu.ops import flash_attention as jax_flash
    from petastorm_tpu_torch.ops.flash_attention import flash_attention

    h, d = 2, 8
    rng = np.random.RandomState(4)
    rows = [{"qkv": rng.randn(n, 3 * h * d).astype(np.float32)} for n in (11, 5, 16, 9, 7)]
    batches = {}
    for name in STAGES:
        packer = STAGES[name].StreamPacker(_spec(name, 16, 3, fields=("qkv",)))
        (batches[name],) = _feed_rows(packer, rows)
    _assert_batches_equal([batches["port"]], [batches["jax"]])
    seg = batches["port"][stage.PACK_SEGMENT_KEY]
    qkv = batches["port"]["qkv"].reshape(3, 16, 3, h, d)
    q, k, v = (qkv[:, :, i] for i in range(3))
    got = flash_attention(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)),
                          segment_ids=torch.from_numpy(seg), device="cpu")
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), block_q=8, block_k=16,
                     segment_ids=jnp.asarray(seg))
    valid = seg >= 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=1e-5,
                               atol=1e-5)
