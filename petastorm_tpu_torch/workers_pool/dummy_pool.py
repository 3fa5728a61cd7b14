"""Synchronous in-caller-thread pool, for deterministic tests (counterpart
of ``petastorm_tpu/workers_pool/dummy_pool.py``), with the JAX pool's
``diagnostics``. Each ventilated item's work is one ``reader.decode`` span,
as in the thread pool, on the ventilating thread."""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque

from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.flight import RECORDER
from petastorm_tpu_torch.workers_pool import (
    EmptyResultError,
    TimeoutWaitingForResultError,
    VentilatedItemProcessedMessage,
    WorkerException,
)


class DummyPool:
    """Processes each ventilated item inside :meth:`ventilate`.
    ``workers_count`` is only reported in :attr:`diagnostics`, and
    ``results_queue_size`` is taken and unused (the results deque is
    unbounded), as in the JAX pool."""

    #: Completion markers carry their item's kwargs (the streaming piece
    #: engine needs the attribution).
    supports_item_done_hook = True

    def __init__(self, workers_count=1, results_queue_size=None):
        self.workers_count = workers_count
        self._results = deque()
        self._worker = None
        self._ventilator = None
        self._stopped = False
        self._ventilated_items = 0
        self._completed_items = 0
        self._counter_lock = threading.Lock()
        #: ``hook(item_kwargs)``, called as :meth:`get_results` drains an
        #: item's completion marker, which follows the item's payloads in
        #: the results deque: after every one of them was returned.
        self.item_done_hook = None
        #: ``fn(pair) -> pair`` applied to each published ``(item_key,
        #: payload)`` pair: the thread pool's publish hook, run inline.
        self.publish_transform = None

    def _publish(self, item):
        transform = self.publish_transform
        if transform is not None:
            from petastorm_tpu_torch.reader_impl.delivery_tracker import (
                apply_publish_transform,
            )

            item = apply_publish_transform(transform, item)
        self._results.append(item)

    @property
    def diagnostics(self):
        """The thread pool's counters, for items processed inline."""
        with self._counter_lock:
            ventilated, completed = self._ventilated_items, self._completed_items
        return {
            "items_ventilated": ventilated,
            "items_processed": completed,
            "items_in_flight": ventilated - completed,
            "results_queue_size": self.results_qsize(),
            "workers_count": self.workers_count,
        }

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        self._worker = worker_class(0, self._publish, worker_setup_args)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        with self._counter_lock:
            self._ventilated_items += 1
        try:
            with tracing.span("reader.decode"):
                self._worker.process(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - forwarded to the consumer
            tb = "".join(traceback.format_exception(*sys.exc_info()))
            self._results.append(WorkerException(exc, tb))
        finally:
            with self._counter_lock:
                self._completed_items += 1
            if self._ventilator is not None:
                self._ventilator.processed_item()
            # Queued behind the item's payloads, so the hook fires only
            # after every one of them was returned.
            self._results.append(VentilatedItemProcessedMessage(kwargs or None))

    def get_results(self, timeout=None):
        """The next payload; EmptyResultError once ventilation is over and
        everything was returned. ``timeout`` (default: none, a slow row
        group is not a failure) bounds a wait on a concurrent ventilator."""
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            if self._results:
                result = self._results.popleft()
                if isinstance(result, VentilatedItemProcessedMessage):
                    hook = self.item_done_hook
                    if hook is not None and result.item is not None:
                        hook(result.item)
                    continue
                if isinstance(result, WorkerException):
                    RECORDER.note("pool.worker_exception", pool="dummy",
                                  error=repr(result.exc)[:200])
                    raise result
                return result
            error = getattr(self._ventilator, "error", None)
            if error is not None:
                raise RuntimeError(f"Ventilation failed: {error!r}") from error
            if self._stopped or self._ventilator is None or self._ventilator.completed():
                # The ventilator thread may have appended between the check
                # above and completed() turning true: look once more.
                if self._results:
                    continue
                raise EmptyResultError()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutWaitingForResultError(f"No results for {timeout}s")
            time.sleep(0.001)

    def results_qsize(self):
        """Result payloads awaiting :meth:`get_results`; completion markers
        are control flow and not counted."""
        return sum(1 for r in list(self._results)
                   if not isinstance(r, VentilatedItemProcessedMessage))

    def stop(self):
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()

    def join(self):
        if self._worker is not None:
            self._worker.shutdown()
