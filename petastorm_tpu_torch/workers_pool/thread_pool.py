"""Thread-based worker pool (counterpart of
``petastorm_tpu/workers_pool/thread_pool.py``): pyarrow Parquet decode
releases the GIL, so threads decode row groups in parallel. Its
``diagnostics`` are the JAX pool's live counters, under the same names, and
it feeds the registry's ``POOL_*`` families as the JAX pool does.
:meth:`ThreadPool.resize` changes the number of decode threads while the
pool runs (the autotuner's ``workers_count`` knob). Each ventilated item's
work is one ``reader.decode`` span on its worker's thread, each publish
into the bounded results queue a ``reader.queue_wait`` span inside it (a
worker blocked there waits on the consumer), and the consumer's blocking
in :meth:`ThreadPool.get_results` one ``reader.wait`` span on the
consumer's (:func:`~petastorm_tpu_torch.telemetry.tracing.span`)."""

from __future__ import annotations

import queue
import sys
import threading
import time
import traceback

from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.flight import RECORDER
from petastorm_tpu_torch.telemetry.metrics import (
    POOL_ITEMS_PROCESSED,
    POOL_ITEMS_VENTILATED,
    POOL_RESULTS_QUEUE_DEPTH,
)
from petastorm_tpu_torch.workers_pool import (
    DEFAULT_TIMEOUT_S,
    EmptyResultError,
    TimeoutWaitingForResultError,
    VentilatedItemProcessedMessage,
    WorkerException,
)
from petastorm_tpu_torch.workers_pool.worker_base import EOFSentinel

#: Worker thread name prefix (the test suite's leak guard watches it).
WORKER_THREAD_PREFIX = "petastorm-tpu-worker-torch"


class _RetireSentinel:
    """``resize()`` shrink marker: exactly one worker thread exits on it
    (unlike ``EOFSentinel`` it is made per retirement, never broadcast)."""


class ThreadPool:
    #: Completion markers carry their item's kwargs: the pool can attribute
    #: them (the streaming piece engine needs it).
    supports_item_done_hook = True

    def __init__(self, workers_count, results_queue_size=50, profiling_enabled=False):
        # ``profiling_enabled`` is taken and unused, as in the JAX pool.
        self.workers_count = workers_count
        # Bounded, so decode stays at most ``results_queue_size`` work items
        # ahead of the consumer.
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._ventilator_queue = queue.Queue()
        self._threads = []
        self._workers = []
        self._ventilator = None
        self._stop_event = threading.Event()
        # resize(): start() records how workers are built so a grow spawns
        # identical ones, and a monotonic id keeps thread names unique
        # across grow / shrink cycles.
        self._worker_class = None
        self._worker_setup_args = None
        self._next_worker_id = workers_count
        self._resize_lock = threading.Lock()
        self._ventilated_items = 0
        self._completed_items = 0
        self._results_pending = 0  # payloads in the results queue
        #: ``hook(item_kwargs)``, called on the consuming thread as
        #: :meth:`get_results` drains an item's completion marker: after
        #: every payload of the item (marker and payloads share one FIFO).
        self.item_done_hook = None
        #: ``fn(pair) -> pair``, applied to each published ``(item_key,
        #: payload)`` pair on the worker thread before it enters the
        #: results queue: how stage fusion moves collation, transform and
        #: serialization into the decode task (``Reader.set_publish_transform``).
        self.publish_transform = None
        self._counter_lock = threading.Lock()

    @property
    def diagnostics(self):
        """Items ventilated, processed and in flight, the payloads waiting in
        the results queue, and the worker count (the JAX pool's keys)."""
        with self._counter_lock:
            ventilated, completed = self._ventilated_items, self._completed_items
            pending = self._results_pending
        return {
            "items_ventilated": ventilated,
            "items_processed": completed,
            "items_in_flight": ventilated - completed,
            "results_queue_size": pending,
            "workers_count": self.workers_count,
        }

    def _publish_result(self, item):
        transform = self.publish_transform
        if transform is not None:
            from petastorm_tpu_torch.reader_impl.delivery_tracker import (
                apply_publish_transform,
            )

            # On the pool thread: that is the point, the fused task pays
            # for collation and serialization here, in parallel.
            item = apply_publish_transform(transform, item)
        with self._counter_lock:
            self._results_pending += 1
        POOL_RESULTS_QUEUE_DEPTH.inc()
        with tracing.span("reader.queue_wait"):
            self._results_queue.put(item)

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        if self._threads:
            raise RuntimeError("ThreadPool already started")
        with self._resize_lock:
            self._worker_class = worker_class
            self._worker_setup_args = worker_setup_args
            self._next_worker_id = self.workers_count
            for worker_id in range(self.workers_count):
                self._spawn_worker(worker_id)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def _spawn_worker(self, worker_id):
        worker = self._worker_class(worker_id, self._publish_result, self._worker_setup_args)
        self._workers.append(worker)
        thread = threading.Thread(
            target=self._worker_loop, args=(worker,), daemon=True,
            name=f"{WORKER_THREAD_PREFIX}-{worker_id}")
        self._threads.append(thread)
        thread.start()

    def resize(self, workers_count):
        """Change the number of decode threads while the pool runs.

        A grow spawns worker threads identical to those ``start()`` built; a
        shrink enqueues one retire sentinel per surplus worker, each taken
        by exactly one worker after the items already queued ahead of it
        (FIFO), so no ventilated item is dropped and the in-flight counts
        stay exact. Before ``start()`` it only sets the count; after
        ``stop()`` it does nothing."""
        workers_count = int(workers_count)
        if workers_count < 1:
            raise ValueError("workers_count must be >= 1")
        with self._resize_lock:
            if self._stop_event.is_set():
                return
            if not self._threads:
                self.workers_count = workers_count  # pre-start resize
                return
            delta = workers_count - self.workers_count
            for _ in range(delta):
                self._spawn_worker(self._next_worker_id)
                self._next_worker_id += 1
            for _ in range(-delta):
                self._ventilator_queue.put(_RetireSentinel())
            self.workers_count = workers_count

    @property
    def live_workers(self):
        """Worker threads alive right now: ``workers_count`` once every
        retire sentinel of a shrink has been taken."""
        return sum(thread.is_alive() for thread in self._threads)

    def _worker_loop(self, worker):
        while not self._stop_event.is_set():
            try:
                item = self._ventilator_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if isinstance(item, (EOFSentinel, _RetireSentinel)):
                break
            args, kwargs = item
            try:
                with tracing.span("reader.decode"):
                    worker.process(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - forwarded to the consumer
                tb = "".join(traceback.format_exception(*sys.exc_info()))
                self._results_queue.put(WorkerException(exc, tb))
            finally:
                # Failed items count as processed too, or the ventilator's
                # in-flight window leaks and the pool deadlocks.
                self._results_queue.put(VentilatedItemProcessedMessage(kwargs or None))

    def ventilate(self, *args, **kwargs):
        with self._counter_lock:
            self._ventilated_items += 1
        POOL_ITEMS_VENTILATED.inc()
        self._ventilator_queue.put((args, kwargs))

    def get_results(self, timeout=DEFAULT_TIMEOUT_S):
        """The next published payload; raises :class:`EmptyResultError` once
        ventilation is over and everything was consumed, and re-raises
        worker exceptions."""
        with tracing.span("reader.wait"):
            return self._next_result(timeout)

    def _next_result(self, timeout):
        deadline = time.monotonic() + timeout
        while True:
            error = getattr(self._ventilator, "error", None)
            if error is not None:
                raise RuntimeError(f"Ventilation failed: {error!r}") from error
            if self._results_queue.empty() and self._all_done():
                raise EmptyResultError()
            try:
                wait = min(0.5, max(0.001, deadline - time.monotonic()))
                result = self._results_queue.get(timeout=wait)
            except queue.Empty:
                if self._all_done():
                    raise EmptyResultError() from None
                if time.monotonic() >= deadline:
                    raise TimeoutWaitingForResultError(
                        f"No results for {timeout}s") from None
                continue
            if isinstance(result, VentilatedItemProcessedMessage):
                with self._counter_lock:
                    self._completed_items += 1
                POOL_ITEMS_PROCESSED.inc()
                if self._ventilator is not None:
                    self._ventilator.processed_item()
                hook = self.item_done_hook
                if hook is not None and result.item is not None:
                    hook(result.item)
                continue
            if isinstance(result, WorkerException):
                RECORDER.note("pool.worker_exception", pool="thread",
                              error=repr(result.exc)[:200])
                raise result
            with self._counter_lock:
                self._results_pending -= 1
            POOL_RESULTS_QUEUE_DEPTH.dec()
            return result

    def _all_done(self):
        with self._counter_lock:
            settled = self._ventilated_items == self._completed_items
        over = self._ventilator is None or self._ventilator.completed()
        return settled and over and self._ventilator_queue.empty()

    def results_qsize(self):
        """Result payloads awaiting :meth:`get_results`; the completion
        markers the queue also holds are not counted."""
        with self._counter_lock:
            return self._results_pending

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()
        for _ in self._threads:
            self._ventilator_queue.put(EOFSentinel())

    def join(self):
        deadline = time.monotonic() + 30
        while any(t.is_alive() for t in self._threads):
            # Drain the bounded results queue so a worker blocked in put()
            # can see the stop event.
            try:
                while True:
                    self._results_queue.get_nowait()
            except queue.Empty:
                with self._counter_lock:
                    POOL_RESULTS_QUEUE_DEPTH.dec(self._results_pending)
                    self._results_pending = 0
            if time.monotonic() > deadline:
                break
            time.sleep(0.01)
        for thread in self._threads:
            thread.join(timeout=1)
        for worker in self._workers:
            worker.shutdown()
        self._threads = []
