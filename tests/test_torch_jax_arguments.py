"""The JAX package's remaining arguments and public names in the port, each
held against the JAX package on the same inputs.

- A retryable dispatcher error raises ``DegradedDispatcherError`` (an
  ``OSError``) in both clients after the same attempts, and the client's
  retry rides it to the healed dispatcher's reply; ``retry_with_backoff``
  treats it as an ``OSError`` in both.
- ``ThreadPool.results_qsize`` / ``DummyPool.results_qsize`` count result
  payloads (not completion markers) as the JAX pools do;
  ``profiling_enabled``, ``DummyPool(workers_count, results_queue_size)``.
- The ``Ventilator`` ABC and ``ventilation_interval``;
  ``ShufflingBufferBase``; ``Reader.next``; the errors' classes.
- ``flash_attention`` / ``flash_attention_with_lse`` take the JAX defaults
  of ``block_q``, ``block_k``, ``interpret`` and ``bwd_impl`` and refuse any
  other value by name.
- ``run_status(watch=False)`` renders once.
- ``load_row_groups(metadata=)``, and ``build_rowgroup_index`` /
  ``global_step_count`` over a ``memory://`` store through
  ``storage_options`` and ``filesystem``.

Tolerance: none, except the CPU flash path, which is compared bit for bit
with itself.
"""

import io
import random
import threading
import time
import uuid

import numpy as np
import pytest

from petastorm_tpu import utils as jax_utils
from petastorm_tpu.service import client as jax_client
from petastorm_tpu_torch import utils as port_utils
from petastorm_tpu_torch.reader_impl import framed_socket as port_framed
from petastorm_tpu_torch.service import client as port_client

CLIENTS = {"port": (port_client, port_utils), "jax": (jax_client, jax_utils)}


# ---------------------------------------------------------------------------
# DegradedDispatcherError (fault 10)
# ---------------------------------------------------------------------------

class _DegradedDispatcher:
    """Replies to every request with the dispatcher's retryable read-only
    error ``degraded_for`` times, then ``ok``; counts the requests."""

    def __init__(self, degraded_for):
        self.degraded_for, self.requests = degraded_for, []
        self.server = port_framed.FramedServer(self._serve, name="degraded-dispatcher")

    def _serve(self, sock):
        while True:
            header, _ = port_framed.recv_framed(sock)
            self.requests.append(header["type"])
            if len(self.requests) <= self.degraded_for:
                reply = {"type": "error", "retryable": True,
                         "error": "dispatcher is read-only: journal write failed"}
            else:
                reply = {"type": "ok"}
            port_framed.send_framed(sock, reply)

    def __enter__(self):
        self.server.start()
        return self

    def __exit__(self, *exc):
        self.server.stop()
        self.server.join()


def _request(package, address, retries):
    client = CLIENTS[package][0]
    source = client.ServiceBatchSource(address, max_retries=retries, backoff_base=0.001,
                                       backoff_max=0.002, connect_timeout=5)
    return source._dispatcher_request({"type": "status"})


@pytest.mark.parametrize("package", list(CLIENTS))
def test_a_degraded_dispatcher_raises_degraded_dispatcher_error(package):
    client = CLIENTS[package][0]
    with _DegradedDispatcher(degraded_for=10) as dispatcher:
        with pytest.raises(client.DegradedDispatcherError, match="read-only") as info:
            _request(package, dispatcher.server.address, retries=2)
        assert isinstance(info.value, OSError)
        assert dispatcher.requests == ["status"] * 3
    assert port_client.DegradedDispatcherError.__mro__[1:] == \
        jax_client.DegradedDispatcherError.__mro__[1:]


@pytest.mark.parametrize("package", list(CLIENTS))
def test_the_retry_rides_a_degraded_dispatcher_to_its_healed_reply(package):
    with _DegradedDispatcher(degraded_for=2) as dispatcher:
        assert _request(package, dispatcher.server.address, retries=3)["type"] == "ok"
        assert dispatcher.requests == ["status"] * 3


def test_retry_with_backoff_treats_it_as_an_os_error_in_both():
    outcomes = {}
    for package, (client, utils) in CLIENTS.items():
        calls = []

        def flaky():
            calls.append(len(calls))
            if len(calls) < 3:
                raise client.DegradedDispatcherError("degraded")
            return "healed"

        delays = []
        result = utils.retry_with_backoff(flaky, retries=3, base_delay=0.01,
                                          retry_on=(OSError,), no_retry_on=(client.ServiceError,),
                                          sleep=delays.append, rng=random.Random(0))
        outcomes[package] = (result, calls, delays)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == "healed" and len(outcomes["port"][2]) == 2


# ---------------------------------------------------------------------------
# the pools' results_qsize
# ---------------------------------------------------------------------------

def _pools():
    from petastorm_tpu.workers_pool.dummy_pool import DummyPool as JaxDummy
    from petastorm_tpu.workers_pool.thread_pool import ThreadPool as JaxThread
    from petastorm_tpu.workers_pool.worker_base import WorkerBase as JaxBase
    from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
    from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
    from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase

    return {"port": (ThreadPool, DummyPool, WorkerBase), "jax": (JaxThread, JaxDummy, JaxBase)}


def _worker_class(base):
    class Repeat(base):
        """Publishes ``value`` results for an item."""

        def process(self, value):
            for i in range(value):
                self.publish_func((value, i))

    return Repeat


ITEMS = [2, 0, 3, 1]


@pytest.mark.parametrize("kind", ["thread", "dummy"])
def test_results_qsize_counts_payloads_as_the_jax_pools_do(kind):
    counts = {}
    for package, (thread_pool, dummy_pool, base) in _pools().items():
        pool = (thread_pool(2, results_queue_size=20, profiling_enabled=True)
                if kind == "thread" else dummy_pool(workers_count=3, results_queue_size=7))
        pool.start(_worker_class(base))
        seen = []
        try:
            for value in ITEMS:
                pool.ventilate(value=value)
                if kind == "dummy":
                    seen.append(pool.results_qsize())
            deadline = time.monotonic() + 30
            while pool.results_qsize() < sum(ITEMS):  # the thread pool's decode
                assert time.monotonic() < deadline
                time.sleep(0.005)
            seen.append(pool.results_qsize())
            results = []
            for _ in range(sum(ITEMS)):
                results.append(pool.get_results(timeout=30))
                seen.append(pool.results_qsize())
            seen.append(pool.diagnostics["workers_count"])
        finally:
            pool.stop()
            pool.join()
        counts[package] = (seen, sorted(results))
    assert counts["port"] == counts["jax"]
    seen = counts["port"][0]
    assert seen[-sum(ITEMS) - 2:-1] == list(range(sum(ITEMS), -1, -1))


# ---------------------------------------------------------------------------
# the ventilator, the shuffling buffers, Reader.next, the errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["port", "jax"])
def test_ventilators_subclass_the_abc_and_wait_the_interval(package):
    if package == "port":
        from petastorm_tpu_torch.workers_pool import ventilator as module
    else:
        from petastorm_tpu.workers_pool import ventilator as module
    assert issubclass(module.ConcurrentVentilator, module.Ventilator)
    assert issubclass(module.DynamicVentilator, module.Ventilator)
    with pytest.raises(TypeError):
        module.Ventilator(lambda **kw: None)
    delivered = []
    vent = module.ConcurrentVentilator(lambda value: delivered.append(value),
                                       [{"value": v} for v in range(3)],
                                       max_ventilation_queue_size=1, ventilation_interval=0.02)
    waits, wait = [], vent._space_available.wait
    vent._space_available.wait = lambda timeout=None: (waits.append(timeout), wait(timeout))[1]
    vent.start()
    deadline = time.monotonic() + 10
    while not vent.completed():
        assert time.monotonic() < deadline
        time.sleep(0.03)
        vent.processed_item()
    vent.stop()
    assert delivered == [0, 1, 2] and waits and set(waits) == {0.02}


def test_shuffling_buffers_subclass_the_base_in_both():
    from petastorm_tpu.reader_impl import shuffling_buffer as jax_buffers
    from petastorm_tpu_torch.reader_impl import shuffling_buffer as port_buffers

    for module in (port_buffers, jax_buffers):
        assert issubclass(module.NoopShufflingBuffer, module.ShufflingBufferBase)
        assert issubclass(module.RandomShufflingBuffer, module.ShufflingBufferBase)
        with pytest.raises(TypeError):
            module.ShufflingBufferBase()
    assert sorted(port_buffers.ShufflingBufferBase.__abstractmethods__) == \
        sorted(jax_buffers.ShufflingBufferBase.__abstractmethods__)


def test_errors_have_the_jax_classes():
    from petastorm_tpu import errors as jax_errors
    from petastorm_tpu_torch import errors as port_errors

    for name in ("NoDataAvailableError", "PetastormMetadataError",
                 "PetastormMetadataGenerationError"):
        port, jax = getattr(port_errors, name), getattr(jax_errors, name)
        assert [c.__name__ for c in port.__mro__] == [c.__name__ for c in jax.__mro__]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    path = tmp_path_factory.mktemp("args") / "store"
    schema = Unischema("ArgSchema", [UnischemaField("idx", np.int64, (), ScalarCodec(), False),
                                     UnischemaField("part", np.int64, (), ScalarCodec(), False)])
    rows = [{"idx": i, "part": i // 10} for i in range(50)]
    materialize_rows(f"file://{path}", schema, rows, rows_per_row_group=10)
    return {"url": f"file://{path}", "path": str(path), "schema": schema, "rows": rows}


def test_reader_next_gives_the_jax_rows(store):
    import petastorm_tpu.reader.reader as jax_reader
    import petastorm_tpu_torch.reader.reader as port_reader

    out = {}
    for package, module in (("port", port_reader), ("jax", jax_reader)):
        with module.make_reader(store["url"], reader_pool_type="dummy",
                                shuffle_row_groups=False) as reader:
            out[package] = [int(reader.next().idx) for _ in range(12)]
    assert out["port"] == out["jax"] == list(range(12))


def test_load_row_groups_takes_the_read_metadata(store):
    import pyarrow.fs as pafs

    from petastorm_tpu.etl import metadata as jax_metadata
    from petastorm_tpu_torch.etl import metadata as port_metadata

    fs = pafs.LocalFileSystem()
    out = {}
    for package, module in (("port", port_metadata), ("jax", jax_metadata)):
        given = module.read_dataset_metadata(fs, store["path"])
        pieces = module.load_row_groups(fs, store["path"], metadata=given)
        assert pieces == module.load_row_groups(fs, store["path"])
        out[package] = [(p.path, p.row_group, p.num_rows) for p in pieces]
        assert module.load_row_groups(fs, store["path"], metadata={})[0].num_rows == 10
    assert out["port"] == out["jax"] and len(out["port"]) == 5


@pytest.mark.parametrize("how", ["storage_options", "filesystem"])
def test_index_and_step_count_over_a_memory_store_equal_jax(store, how):
    import fsspec

    from petastorm_tpu.etl import metadata as jax_metadata
    from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
    from petastorm_tpu.etl.rowgroup_indexers import SingleFieldIndexer as JaxIndexer
    from petastorm_tpu.jax_utils.sharding import global_step_count as jax_steps
    from petastorm_tpu_torch.etl import metadata as port_metadata
    from petastorm_tpu_torch.etl import rowgroup_indexing
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.torch_utils.sharding import global_step_count

    memory = fsspec.filesystem("memory")
    base = f"/jax-args-{uuid.uuid4().hex[:8]}"
    kwargs = ({"storage_options": {"skip_instance_cache": False}} if how == "storage_options"
              else {"filesystem": memory})
    try:
        out = {}
        for package, metadata, indexing, indexer, steps in (
                ("port", port_metadata, rowgroup_indexing, SingleFieldIndexer, global_step_count),
                ("jax", jax_metadata, jax_indexing, JaxIndexer, jax_steps)):
            url = f"memory://{base}/{package}"
            metadata.materialize_rows(url, metadata.get_schema_from_dataset_url(store["url"]),
                                      store["rows"], rows_per_row_group=10, **kwargs)
            index = indexing.build_rowgroup_index(url, [indexer("by_part", "part")], **kwargs)
            out[package] = ([index["by_part"].get_row_group_indexes(v) for v in range(5)],
                            [steps(url, 8, shards, **kwargs) for shards in (1, 2, 3)])
        assert out["port"] == out["jax"]
        assert out["port"] == ([{0}, {1}, {2}, {3}, {4}], [6, 2, 1])
    finally:
        memory.rm(base, recursive=True)


# ---------------------------------------------------------------------------
# flash attention's Pallas options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,value", [("block_q", 64), ("block_k", 128), ("interpret", True),
                                        ("interpret", False), ("bwd_impl", "reference")])
def test_flash_pallas_options_are_refused_by_name(name, value):
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match=rf"flash_attention\({name}="):
        fa.flash_attention(q, q, q, device="cpu", **{name: value})
    if name != "bwd_impl":
        with pytest.raises(NotImplementedError, match=rf"flash_attention_with_lse\({name}="):
            fa.flash_attention_with_lse(q, q, q, device="cpu", **{name: value})


def test_flash_jax_defaults_run_unchanged_on_the_cpu():
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 24, 2, 16).astype(np.float32)) for _ in range(3))
    plain = fa.flash_attention(q, k, v, causal=True, device="cpu")
    given = fa.flash_attention(q, k, v, None, None, None, True, "flash", device="cpu")
    assert torch.equal(plain, given)
    out, lse = fa.flash_attention_with_lse(q, k, v, block_q=None, block_k=None, interpret=None,
                                           causal=True, device="cpu")
    assert torch.equal(out, plain) and lse.shape == (2, 24, 2)


# ---------------------------------------------------------------------------
# run_status(watch=)
# ---------------------------------------------------------------------------

def test_run_status_renders_once_unless_watching():
    from petastorm_tpu_torch.service.cli import run_status
    from petastorm_tpu_torch.service.dispatcher import Dispatcher

    with Dispatcher(lease_timeout_s=None).start() as dispatcher:
        once = io.StringIO()
        assert run_status(dispatcher.address, interval_s=0.01, out=once) == 0
        watched, stop = io.StringIO(), threading.Event()
        assert run_status(dispatcher.address, watch=True, interval_s=0.01, out=watched,
                          max_refreshes=2, stop_event=stop) == 0
    header = once.getvalue().splitlines()[0]
    assert "\x1b[2J" not in once.getvalue() and once.getvalue().count(header) == 1
    assert watched.getvalue().count("\x1b[2J\x1b[H") == 2
