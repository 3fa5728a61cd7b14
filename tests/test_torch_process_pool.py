"""The port's process pool (``workers_pool/process_pool.py``), beside its
thread and dummy pools, and the three reader factories on it.

- The JAX package's pool cases (``tests/test_workers_pool.py``) over the
  port's three pool kinds: round trip, ventilator epochs, several
  publishes per item, exception propagation (with a flight-recorder
  event), the ventilation window after an exception; and for the process
  pool alone: no orphans, shutdown under a full high-water mark, a large
  ndarray in both copy modes, Arrow zero-copy frames, the startup report,
  the diagnostics keys of the JAX pool.
- A spawned worker imports no torch (and no JAX) and sees
  ``CUDA_VISIBLE_DEVICES=""``, after loading the whole reader stack.
- Reader parity: the same seeded store through the JAX and the port
  ``make_reader``, ``make_columnar_reader`` and ``make_batch_reader`` with
  ``reader_pool_type="process"``: the same rows in the same order at one
  worker, the same multiset at two (against the JAX dummy pool), and a
  resume from a mid-pass ``state_dict()`` that delivers exactly the rest,
  as ``tests/test_resume.py`` checks the JAX process pool.

The worker classes of this module travel to the workers by value
(``cloudpickle.register_pickle_by_value``): the workers never import this
module, which imports JAX. Tolerance: none; everything is compared exactly.
"""

import os
import sys
import time

import cloudpickle
import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.telemetry.flight import RECORDER
from petastorm_tpu_torch.workers_pool import (
    EmptyResultError,
    WorkerException,
)
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.exec_in_new_process import (
    CHILD_MODULE,
    exec_in_new_process,
)
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase

cloudpickle.register_pickle_by_value(sys.modules[__name__])

POOL_KINDS = ["thread", "dummy", "process"]
FACTORIES = ["make_reader", "make_columnar_reader", "make_batch_reader"]
ROWS, GROUP = 96, 16  # 6 row groups


class SquareWorker(WorkerBase):
    def process(self, value):
        self.publish_func(value * value)


class MultiPublishWorker(WorkerBase):
    def process(self, value):
        for i in range(3):
            self.publish_func((value, i))


class FailingWorker(WorkerBase):
    def process(self, value):
        if value == 13:
            raise ValueError("unlucky value")
        self.publish_func(value)


class ArrowWorker(WorkerBase):
    def process(self, n):
        self.publish_func(pa.table({"x": list(range(n))}))


class BigArrayWorker(WorkerBase):
    def process(self, seed):
        rng = np.random.RandomState(seed)
        self.publish_func({"seed": seed, "data": rng.rand(256, 257).astype(np.float32)})


class BrokenWorker(WorkerBase):
    def __init__(self, worker_id, publish_func, args):
        raise RuntimeError("this worker cannot start")


class ProbeWorker(WorkerBase):
    """Reads a store through the port's whole reader stack inside the
    worker, then reports which heavy packages the worker has loaded and
    what card it may see."""

    def process(self, url):
        from petastorm_tpu_torch.reader.reader import make_reader

        with make_reader(url, reader_pool_type="dummy") as reader:
            rows = sum(1 for _ in reader)
        heavy = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("torch", "jax", "jaxlib", "petastorm_tpu"))
        self.publish_func({"rows": rows, "heavy": heavy, "pid": os.getpid(),
                           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")})


def _drain(pool):
    results = []
    while True:
        try:
            results.append(pool.get_results(timeout=20))
        except EmptyResultError:
            return results


def _make_pool(kind, workers=2, **kwargs):
    if kind == "thread":
        return ThreadPool(workers, **kwargs)
    if kind == "process":
        return ProcessPool(workers, **kwargs)
    return DummyPool()


@pytest.mark.parametrize("pool_kind", POOL_KINDS)
def test_pool_roundtrip(pool_kind):
    pool = _make_pool(pool_kind)
    pool.start(SquareWorker)
    for v in range(10):
        pool.ventilate(v)
    # Without a ventilator the pool cannot know ventilation is over:
    # collect exactly the expected count.
    results = [pool.get_results(timeout=20) for _ in range(10)]
    assert sorted(results) == [v * v for v in range(10)]
    pool.stop()
    pool.join()


@pytest.mark.parametrize("pool_kind", POOL_KINDS)
def test_pool_with_ventilator_epochs(pool_kind):
    pool = _make_pool(pool_kind)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"value": v} for v in range(5)],
                                      iterations=3)
    pool.start(SquareWorker, ventilator=ventilator)
    assert sorted(_drain(pool)) == sorted([v * v for v in range(5)] * 3)
    assert pool.diagnostics["items_processed"] == 15
    pool.stop()
    pool.join()


@pytest.mark.parametrize("pool_kind", POOL_KINDS)
def test_pool_multiple_publishes_per_item(pool_kind):
    pool = _make_pool(pool_kind)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"value": v} for v in range(4)],
                                      iterations=1)
    pool.start(MultiPublishWorker, ventilator=ventilator)
    assert sorted(_drain(pool)) == [(v, i) for v in range(4) for i in range(3)]
    pool.stop()
    pool.join()


@pytest.mark.parametrize("pool_kind", POOL_KINDS)
def test_worker_exception_propagates(pool_kind):
    pool = _make_pool(pool_kind)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"value": v} for v in [1, 13, 2]],
                                      iterations=1)
    pool.start(FailingWorker, ventilator=ventilator)
    noted = len(RECORDER.snapshot())
    with pytest.raises(WorkerException, match="unlucky") as info:
        for _ in range(10):
            pool.get_results(timeout=20)
    # The worker's traceback travels with it, and the flight ring holds it.
    assert "ValueError: unlucky value" in info.value.formatted_traceback
    events = RECORDER.snapshot()[noted:]
    assert any(e["event"] == "pool.worker_exception" and e["pool"] == pool_kind
               and "unlucky" in e["error"] for e in events)
    pool.stop()
    pool.join()


@pytest.mark.parametrize("pool_kind", POOL_KINDS)
def test_worker_exception_does_not_stall_ventilation_window(pool_kind):
    """A failing item still advances the in-flight window."""
    pool = _make_pool(pool_kind)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"value": v} for v in [1, 13, 2, 3]],
                                      iterations=1, max_ventilation_queue_size=1)
    pool.start(FailingWorker, ventilator=ventilator)
    results, exceptions = [], 0
    while True:
        try:
            results.append(pool.get_results(timeout=20))
        except WorkerException:
            exceptions += 1
        except EmptyResultError:
            break
    assert exceptions == 1
    assert sorted(results) == [1, 2, 3]
    # Failed items count as processed.
    assert pool.diagnostics["items_processed"] == 4
    pool.stop()
    pool.join()


def _pool_children():
    """pids of live ``python ... exec_in_new_process`` children of this
    process: a pool that another test process (an xdist worker) runs at the
    same time is not this test's to count."""
    pids = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and len(argv) > 2 and b"python" in argv[0] \
                and argv[2] == CHILD_MODULE.encode():
            pids.add(int(entry))
    return pids


def test_process_pool_no_orphans_and_jax_diagnostics_keys():
    from petastorm_tpu.workers_pool.process_pool import ProcessPool as JaxProcessPool

    before = _pool_children()
    pool = ProcessPool(2)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"value": 1}], iterations=1)
    pool.start(SquareWorker, ventilator=ventilator)
    assert _drain(pool) == [1]
    pids = {p.pid for p in pool._processes}
    assert pids <= _pool_children()
    assert set(pool.diagnostics) == set(JaxProcessPool(2).diagnostics)
    ipc_dir = pool._ipc_dir
    pool.stop()
    pool.join()
    assert not pids & _pool_children() and _pool_children() <= before
    assert not os.path.exists(ipc_dir)
    assert pool.results_qsize() == 0


def test_process_pool_backpressure_shutdown_and_bounded_drain():
    """Workers blocked publishing into a tiny high-water mark still exit on
    stop, and results_qsize drains at most results_queue_size locally."""
    pool = ProcessPool(2, results_queue_size=1)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"value": v} for v in range(50)],
                                      iterations=1)
    pool.start(MultiPublishWorker, ventilator=ventilator)
    pool.get_results(timeout=20)
    pool.get_results(timeout=20)
    deadline = time.monotonic() + 5
    while pool.results_qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert 1 <= pool.results_qsize() <= 1
    assert len(pool._pending_frames) <= 1
    pool.stop()
    pool.join()
    assert all(p.poll() is not None for p in pool._processes)


@pytest.mark.parametrize("zero_copy", [True, False])
def test_process_pool_large_ndarray_both_modes(zero_copy):
    pool = ProcessPool(2, serializer=PickleSerializer(), zmq_copy_buffers=zero_copy)
    pool.start(BigArrayWorker)
    for seed in range(4):
        pool.ventilate(seed)
    got = {}
    while len(got) < 4:
        r = pool.get_results(timeout=30)
        got[r["seed"]] = r["data"]
    pool.stop()
    pool.join()
    for seed in range(4):
        want = np.random.RandomState(seed).rand(256, 257).astype(np.float32)
        np.testing.assert_array_equal(got[seed], want)


@pytest.mark.parametrize("zero_copy", [True, False])
def test_process_pool_arrow_frames(zero_copy):
    pool = ProcessPool(2, serializer=ArrowTableSerializer(), zmq_copy_buffers=zero_copy)
    ventilator = ConcurrentVentilator(pool.ventilate, [{"n": 4}, {"n": 1000}], iterations=1)
    pool.start(ArrowWorker, ventilator=ventilator)
    tables = sorted(_drain(pool), key=lambda t: t.num_rows)
    pool.stop()
    pool.join()
    assert [t.column("x").to_pylist() for t in tables] == [list(range(4)), list(range(1000))]


def test_process_pool_startup_failure_reports_exit_codes():
    pool = ProcessPool(2)
    with pytest.raises(RuntimeError, match=r"0/2 pool workers came up \(exit codes"):
        pool.start(BrokenWorker)
    assert pool._ipc_dir is None
    for process in pool._processes:
        process.wait(timeout=10)


def test_worker_imports_no_torch_and_sees_no_card(tmp_path):
    url = _write_store(f"file://{tmp_path}/probe")
    pool = ProcessPool(1)
    pool.start(ProbeWorker)
    pool.ventilate(url)
    probe = pool.get_results(timeout=60)
    pool.stop()
    pool.join()
    assert probe["rows"] == ROWS
    assert probe["pid"] != os.getpid()
    assert probe["heavy"] == []
    assert probe["cuda_visible_devices"] == ""


def test_exec_in_new_process_runs_function(tmp_path):
    marker = tmp_path / "touched.txt"
    process = exec_in_new_process(_touch_file, str(marker), text="hello")
    process.wait(timeout=30)
    assert process.returncode == 0
    assert marker.read_text() == "hello"


def _touch_file(path, text=""):
    with open(path, "w") as f:
        f.write(text)


def test_resize_workers_names_the_process_pool(store):
    reader = port_reader_mod.make_reader(store, reader_pool_type="process", workers_count=1)
    with reader:
        with pytest.raises(NotImplementedError, match="ProcessPool cannot resize"):
            reader.resize_workers(2)
        assert sum(1 for _ in reader) == ROWS


# -- the reader factories on the process pool --------------------------------

def _write_store(url):
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import (
        CompressedImageCodec,
        NdarrayCodec,
        ScalarCodec,
    )
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("Probe", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, (8, 8, 3), CompressedImageCodec("png"), False),
        UnischemaField("vec", np.float32, (3,), NdarrayCodec(), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(0)
    materialize_rows(url, schema, ({
        "idx": np.int64(i), "image": rng.randint(0, 256, (8, 8, 3), dtype=np.uint8),
        "vec": rng.rand(3).astype(np.float32), "label": np.int32(i % 5)}
        for i in range(ROWS)), rows_per_row_group=GROUP)
    return url


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return _write_store(f"file://{tmp_path_factory.mktemp('pool')}/store")


def _rows(reader, limit=None):
    """The reader's rows as dicts of numpy values, in delivery order; with
    ``limit``, stop after that many payloads and return the reader's
    ``state_dict()`` too."""
    out, payloads, state = [], 0, None
    with reader:
        for item in reader:
            d = item._asdict()
            if reader.batched_output:
                n = len(next(iter(d.values())))
                out.extend({k: v[i] for k, v in d.items()} for i in range(n))
            else:
                out.append(d)
            payloads += 1 if reader.batched_output else 0
            if limit is not None and (payloads == limit if reader.batched_output
                                      else len(out) == limit * GROUP):
                state = reader.state_dict()
                break
    return out if limit is None else (out, state)


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def _by_idx(rows):
    return sorted(rows, key=lambda r: int(r["idx"]))


@pytest.mark.parametrize("factory", FACTORIES)
def test_one_worker_delivers_the_jax_rows_in_order(store, factory):
    kwargs = dict(reader_pool_type="process", workers_count=1, num_epochs=2,
                  shuffle_row_groups=True, shard_seed=4)
    port = _rows(getattr(port_reader_mod, factory)(store, **kwargs))
    jax = _rows(getattr(jax_reader_mod, factory)(store, **kwargs))
    assert len(port) == 2 * ROWS
    _same_rows(port, jax)


@pytest.mark.parametrize("factory", FACTORIES)
def test_two_workers_deliver_the_jax_multiset(store, factory):
    port = _rows(getattr(port_reader_mod, factory)(
        store, reader_pool_type="process", workers_count=2, zmq_copy_buffers=False))
    jax = _rows(getattr(jax_reader_mod, factory)(store, reader_pool_type="dummy"))
    assert sorted(int(r["idx"]) for r in port) == list(range(ROWS))
    _same_rows(_by_idx(port), _by_idx(jax))


@pytest.mark.parametrize("factory", FACTORIES)
def test_resume_from_a_mid_pass_state(store, factory):
    """The first payload consumed, a state taken, a fresh process-pool
    reader resumed from it: the two runs' rows are the epoch's, each once
    (the tags crossed the process boundary in both serializers)."""
    kwargs = dict(reader_pool_type="process", workers_count=2, num_epochs=1)
    first, state = _rows(getattr(port_reader_mod, factory)(store, **kwargs), limit=1)
    assert sum(state["delivered"].values()) == 1
    rest = _rows(getattr(port_reader_mod, factory)(store, resume_state=state, **kwargs))
    ids = [int(r["idx"]) for r in first + rest]
    assert sorted(ids) == list(range(ROWS))
