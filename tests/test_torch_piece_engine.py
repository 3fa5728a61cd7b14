"""The streaming piece engine and the reader's dynamic feed against the JAX
package (``petastorm_tpu_torch/service/piece_engine.py``,
``Reader(dynamic_ventilation=True)``, the pools' item-done hook and
``DynamicVentilator``).

The same numpy-seeded stores of 12 pieces go through the JAX engine and the
port's with the same enqueue / revoke / finish script. Tolerance: the events
(kind, piece, generation, ordinal, rows; the error text of a
``piece_failed``) are equal and every batch decodes to bit-equal arrays.
Covered: the three reader families, serve-time permutation, ``start``
watermarks, revokes and re-grants, ``transform_fn``, ``columnar_collate``
over a nullable column, a warm pass from each package's ``BatchCache`` that
builds no reader, and a poison piece under ``on_piece_error="quarantine"``.
The reader feed's ``read_next_tagged`` gives the JAX reader's ``(output,
piece)`` pairs, and the item-done hook fires after every output of its
item, as in the JAX pools.
"""

import time

import numpy as np
import pytest

from petastorm_tpu import failpoints as jax_fp
from petastorm_tpu_torch import failpoints as port_fp

PIECES, GROUP = 12, 5


def _write_petastorm_store(url):
    """idx, a nullable int and a float vector; 12 row groups of 5."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("EngineSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("maybe", np.int32, (), ScalarCodec(), True),
        UnischemaField("vec", np.float32, (3,), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(17)
    materialize_rows(url, schema, ({
        "id": i, "maybe": None if i % 7 == 3 else int(rng.randint(0, 9)),
        "vec": rng.rand(3).astype(np.float32)} for i in range(PIECES * GROUP)),
        rows_per_row_group=GROUP)
    return url


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    from petastorm_tpu_torch.test_util.dataset_factory import create_test_scalar_dataset

    root = tmp_path_factory.mktemp("engine")
    plain = f"file://{root}/plain"
    create_test_scalar_dataset(plain, rows_count=PIECES * GROUP, rows_per_row_group=GROUP)
    return {"batch": plain, "petastorm": _write_petastorm_store(f"file://{root}/petastorm")}


def _package(name):
    if name == "jax":
        from petastorm_tpu.cache_impl import BatchCache
        from petastorm_tpu.reader import reader as reader_mod
        from petastorm_tpu.reader_impl.framed_socket import decode_payload
        from petastorm_tpu.service import piece_engine, seedtree
        from petastorm_tpu.workers_pool import ventilator
        return reader_mod, piece_engine, seedtree, decode_payload, BatchCache, ventilator, jax_fp
    from petastorm_tpu_torch.cache_impl import BatchCache
    from petastorm_tpu_torch.reader import reader as reader_mod
    from petastorm_tpu_torch.reader_impl.framed_socket import decode_payload
    from petastorm_tpu_torch.service import piece_engine, seedtree
    from petastorm_tpu_torch.workers_pool import ventilator
    return reader_mod, piece_engine, seedtree, decode_payload, BatchCache, ventilator, port_fp


FACTORIES = {"row": "make_reader", "columnar": "make_columnar_reader",
             "batch": "make_batch_reader"}


def _factory(package, family, stores, pool="dummy", workers=2):
    reader_mod = _package(package)[0]
    make = getattr(reader_mod, FACTORIES[family])
    url = stores["batch" if family == "batch" else "petastorm"]

    def build():
        return make(url, dynamic_ventilation=True, num_epochs=1, shuffle_row_groups=False,
                    cur_shard=0, shard_count=1, reader_pool_type=pool, workers_count=workers)
    return build


def _drain(engine, timeout_s=30.0):
    events = []
    deadline = time.monotonic() + timeout_s
    while not engine.finished:
        assert time.monotonic() < deadline, "engine did not drain"
        event = engine.next_event(timeout=0.2)
        if event is not None:
            events.append(event)
    return events


def _normalize(events, decode_payload):
    """Events as comparable tuples: batches decoded to their arrays."""
    out = []
    for event in events:
        if event[0] == "batch":
            _, piece, gen, ordinal, rows, fmt, frames, _decode_s = event
            payload = decode_payload(fmt, [bytes(f) for f in frames])
            out.append(("batch", piece, gen, ordinal, rows,
                        {k: np.asarray(v) for k, v in payload.items()}))
        else:
            out.append(tuple(event))
    return out


def _assert_events_equal(port, jax):
    assert [e[:5] if e[0] == "batch" else e for e in port] == \
        [e[:5] if e[0] == "batch" else e for e in jax]
    for p, j in zip(port, jax):
        if p[0] != "batch":
            continue
        assert sorted(p[5]) == sorted(j[5])
        for name, want in j[5].items():
            got = p[5][name]
            assert got.dtype == want.dtype, name
            if want.dtype == object:
                assert [repr(v) for v in got] == [repr(v) for v in want], name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def _script(engine):
    """Grants, a start watermark, a revoke, a re-grant under a new
    generation, then finish."""
    for piece in (3, 1, 7, 0, 11, 9, 4):
        engine.enqueue(piece, 5, start=1 if piece == 7 else 0)
    assert sorted(engine.revoke([0, 9, 6])) == [0, 9]  # 6 was never granted
    assert engine.enqueue(9, 6)
    engine.finish()


def _run(package, family, stores, permute=False, transform=None, columnar_collate=False,
         pool="dummy", workers=2):
    _, piece_engine, seedtree, decode_payload, *_ = _package(package)
    permute_fn = ((lambda p, n: seedtree.batch_permutation(7, 2, p, n)) if permute else None)
    engine = piece_engine.StreamingPieceEngine(
        _factory(package, family, stores, pool=pool, workers=workers), 2, permute_fn=permute_fn,
        transform_fn=transform, columnar_collate=columnar_collate)
    try:
        _script(engine)
        events = _drain(engine)
        diagnostics = engine.diagnostics
    finally:
        engine.close()
    return _normalize(events, decode_payload), diagnostics


@pytest.mark.parametrize("permute", [False, True], ids=["canonical", "permuted"])
@pytest.mark.parametrize("family", sorted(FACTORIES))
def test_engine_events_and_batches_equal_jax(stores, family, permute):
    port, port_diag = _run("port", family, stores, permute=permute)
    jax, jax_diag = _run("jax", family, stores, permute=permute)
    _assert_events_equal(port, jax)
    done = [e[1] for e in port if e[0] == "piece_done"]
    assert done == [3, 1, 7, 11, 4, 9]  # in grant order, one reader
    engine_keys = {k: v for k, v in port_diag.items() if k.startswith("engine_")}
    assert engine_keys == {k: v for k, v in jax_diag.items() if k.startswith("engine_")}
    assert engine_keys["engine_pieces_revoked"] == 2
    assert engine_keys["engine_pieces_served"] == 6


def test_engine_thread_pool_serves_the_same_batches(stores):
    """Through a thread pool (the worker's default; one decode thread, so
    the order is deterministic): the same events as the JAX engine's."""
    port, _ = _run("port", "batch", stores, pool="thread", workers=1)
    jax, _ = _run("jax", "batch", stores, pool="thread", workers=1)
    _assert_events_equal(port, jax)


def test_transform_and_columnar_collate_equal_jax(stores):
    """``transform_fn`` runs on each cold batch before serialization;
    ``columnar_collate`` re-applies the row family's dense rule to a batch
    cut from a nullable (object) column."""
    def transform(batch):
        return dict(batch, id2=np.asarray(batch["id"]) * 2)

    port, _ = _run("port", "columnar", stores, transform=transform, columnar_collate=True)
    jax, _ = _run("jax", "columnar", stores, transform=transform, columnar_collate=True)
    _assert_events_equal(port, jax)
    dtypes = {str(e[5]["maybe"].dtype) for e in port if e[0] == "batch"}
    assert dtypes == {"object", "int32"}  # dense where the batch has no null
    assert all(np.array_equal(e[5]["id2"], e[5]["id"] * 2) for e in port if e[0] == "batch")


@pytest.mark.parametrize("permute", [False, True], ids=["canonical", "permuted"])
def test_warm_pass_from_each_cache_builds_no_reader(stores, permute):
    """A cold pass fills each package's BatchCache; the warm pass serves
    from it with a reader factory that must never be called, and both
    passes equal the JAX engine's."""
    out = {}
    for package in ("port", "jax"):
        _, piece_engine, seedtree, decode_payload, BatchCache, *_ = _package(package)
        cache = BatchCache(mem_budget_bytes=32 << 20)
        permute_fn = (lambda p, n: seedtree.batch_permutation(3, 1, p, n)) if permute else None
        passes = []
        try:
            for warm in (False, True):
                def refuse():
                    raise AssertionError("a warm pass built a reader")
                engine = piece_engine.StreamingPieceEngine(
                    refuse if warm else _factory(package, "batch", stores), 2, cache=cache,
                    cache_key_fn=lambda piece: f"piece-{piece}", permute_fn=permute_fn)
                try:
                    _script(engine)
                    passes.append(_normalize(_drain(engine), decode_payload))
                    if warm:
                        assert engine.reader is None
                finally:
                    engine.close()
            out[package] = (passes, cache.stats())
        finally:
            cache.cleanup()
    (port_cold, port_warm), port_stats = out["port"]
    (jax_cold, jax_warm), jax_stats = out["jax"]
    _assert_events_equal(port_cold, jax_cold)
    _assert_events_equal(port_warm, jax_warm)
    # The warm pass re-serves exactly what the cold pass sent.
    _assert_events_equal(port_warm, port_cold)
    assert port_stats["hits"] == jax_stats["hits"] == 6
    assert port_stats["misses"] == jax_stats["misses"] == 6


def test_poison_piece_is_quarantined_as_in_jax(stores):
    """``FaultSchedule(poison_pieces={5})``: piece 5 becomes one
    ``piece_failed`` event, every other piece serves; under "fail" the
    engine raises."""
    out = {}
    for package in ("port", "jax"):
        _, piece_engine, _, decode_payload, _, _, fp = _package(package)
        with fp.armed(fp.FaultSchedule(0, poison_pieces={5})):
            engine = piece_engine.StreamingPieceEngine(
                _factory(package, "row", stores), 2, on_piece_error="quarantine")
            try:
                for piece in (4, 5, 6):
                    engine.enqueue(piece, 2)
                engine.finish()
                out[package] = (_normalize(_drain(engine), decode_payload),
                                engine.diagnostics["engine_pieces_quarantined"])
            finally:
                engine.close()
            strict = piece_engine.StreamingPieceEngine(_factory(package, "row", stores), 2)
            try:
                strict.enqueue(5)
                with pytest.raises(RuntimeError, match="poisoned"):
                    strict.next_event(timeout=1.0)
            finally:
                strict.close()
    _assert_events_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1] == 1
    failed = [e for e in out["port"][0] if e[0] == "piece_failed"]
    assert failed == [("piece_failed", 5, 2, "failpoint piece.decode: poisoned piece")]
    assert [e[1] for e in out["port"][0] if e[0] == "piece_done"] == [4, 6]


def test_refusals_name_their_slice():
    """No argument is refused by slice any more: ``packer_factory``, fusion,
    the post-decode cache stage and the hand-off hook are taken as the JAX
    engine takes them, and packing with a transform is refused with the
    JAX engine's words."""
    from petastorm_tpu.service.piece_engine import StreamingPieceEngine as JaxEngine
    from petastorm_tpu_torch.service.piece_engine import StreamingPieceEngine

    for kwargs in ({"fused": True}, {"cache_stage": "post-decode"},
                   {"handoff_note_fn": print}, {"packer_factory": object},
                   {"packer_factory": object, "fused": True}):
        port, jax = StreamingPieceEngine(lambda: None, 2, **kwargs), JaxEngine(lambda: None, 2,
                                                                              **kwargs)
        assert (port.fused, port._cache_stage, port._handoff, port._packer_factory) == \
            (jax.fused, jax._cache_stage, jax._handoff, jax._packer_factory)
    messages = []
    for engine in (StreamingPieceEngine, JaxEngine):
        with pytest.raises(ValueError, match="cannot combine") as err:
            engine(lambda: None, 2, packer_factory=object, transform_fn=print)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="cache_stage"):
        StreamingPieceEngine(lambda: None, 2, cache_stage="pre-decode")
    with pytest.raises(ValueError, match="on_piece_error"):
        StreamingPieceEngine(lambda: None, 2, on_piece_error="skip")


def test_a_reader_instance_cannot_quarantine(stores):
    out = {}
    for package in ("port", "jax"):
        piece_engine = _package(package)[1]
        reader = _factory(package, "batch", stores)()
        try:
            with pytest.raises(ValueError, match="FACTORY") as info:
                piece_engine.StreamingPieceEngine(reader, 2, on_piece_error="quarantine")
            out[package] = str(info.value)
            engine = piece_engine.StreamingPieceEngine(reader, 2)
            engine.enqueue(2)
            engine.finish()
            assert [e[0] for e in _drain(engine)] == ["batch"] * 3 + ["piece_done"]
        finally:
            reader.stop()
            reader.join()
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the reader's dynamic feed, the pools' hook and the ventilator
# ---------------------------------------------------------------------------

def _feed(package, family, stores, pool, workers=1):
    """A dynamic reader's outputs and item-done hook calls, interleaved in
    the order the consumer sees them."""
    reader = _factory(package, family, stores, pool=pool, workers=workers)()
    seen = []
    reader.set_item_done_hook(lambda item: seen.append(("done", item["piece_index"])))
    for piece in (8, 2, 10):
        reader.submit_piece(piece)
    reader.finish_pieces()
    with reader:
        while True:
            try:
                output, piece = reader.read_next_tagged(timeout=30)
            except Exception as exc:  # the package's EmptyResultError
                assert type(exc).__name__ == "EmptyResultError", exc
                break
            row = output._asdict()
            seen.append(("out", piece, {k: np.asarray(v) for k, v in row.items()}))
    return seen


@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("family", sorted(FACTORIES))
def test_read_next_tagged_pairs_and_hook_order_equal_jax(stores, family, pool):
    port = _feed("port", family, stores, pool)
    jax = _feed("jax", family, stores, pool)
    assert [e[:2] for e in port] == [e[:2] for e in jax]
    for p, j in zip(port, jax):
        if p[0] == "out":
            for name in j[2]:
                np.testing.assert_array_equal(p[2][name], j[2][name], err_msg=name)
    # The hook fires after every output of its piece.
    for index, event in enumerate(port):
        if event[0] == "done":
            assert all(e[1] != event[1] for e in port[index + 1:] if e[0] == "out")
    assert [e[1] for e in port if e[0] == "done"] == [8, 2, 10]


def test_dynamic_reader_refusals_equal_jax(stores):
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    for kwargs in ({"shuffle_row_groups": True}, {"shuffle_row_drop_partitions": 2},
                   {"resume_state": {"version": 1}}):
        with pytest.raises(ValueError, match="dynamic_ventilation"):
            make_batch_reader(stores["batch"], dynamic_ventilation=True,
                              **dict({"shuffle_row_groups": False}, **kwargs))
    with make_batch_reader(stores["batch"], reader_pool_type="dummy",
                           shuffle_row_groups=False) as planned:
        assert not planned.dynamic
        with pytest.raises(RuntimeError, match="dynamic_ventilation=True"):
            planned.submit_piece(0)
    reader = _factory("port", "batch", stores)()
    try:
        with pytest.raises(ValueError, match="out of range"):
            reader.submit_piece(PIECES)
        # The pool's publish hook is installed, as on a JAX dynamic reader.
        assert reader.set_publish_transform(lambda pair: pair) is True
    finally:
        reader.stop()
        reader.join()
    process = _factory("port", "batch", stores, pool="process")()
    try:
        with pytest.raises(ValueError, match="reader_pool_type='thread'"):
            process.set_item_done_hook(lambda item: None)
        assert process.set_publish_transform(lambda pair: pair) is False
    finally:
        process.stop()
        process.join()


def test_dynamic_ventilator_equals_jax():
    from petastorm_tpu.workers_pool.ventilator import DynamicVentilator as JaxVentilator
    from petastorm_tpu_torch.workers_pool.ventilator import DynamicVentilator

    out = {}
    for name, cls in (("port", DynamicVentilator), ("jax", JaxVentilator)):
        fed = []
        ventilator = cls(lambda **item: fed.append(item["piece_index"]))
        ventilator.start()
        snapshots = [ventilator.diagnostics]
        for piece in (4, 1, 9):
            ventilator.submit({"piece_index": piece})
        snapshots.append(ventilator.diagnostics)
        ventilator.processed_item()
        ventilator.finish()
        snapshots.append(ventilator.diagnostics)
        with pytest.raises(RuntimeError, match="after finish"):
            ventilator.submit({"piece_index": 0})
        out[name] = (fed, snapshots, ventilator.completed(), ventilator.error)
    assert out["port"] == out["jax"]
    assert out["port"][1][-1] == {"items_ventilated": 3, "items_in_flight": 2,
                                  "ventilation_completed": True}
