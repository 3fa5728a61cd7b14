"""Synchronous in-caller-thread pool, for deterministic tests (counterpart
of ``petastorm_tpu/workers_pool/dummy_pool.py``), with the JAX pool's
``diagnostics``."""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque

from petastorm_tpu_torch.telemetry.flight import RECORDER
from petastorm_tpu_torch.workers_pool import EmptyResultError, WorkerException


class DummyPool:
    """Processes each ventilated item inside :meth:`ventilate`."""

    workers_count = 1

    def __init__(self):
        self._results = deque()
        self._worker = None
        self._ventilator = None
        self._stopped = False
        self._ventilated_items = 0
        self._completed_items = 0
        self._counter_lock = threading.Lock()

    @property
    def diagnostics(self):
        """The thread pool's counters, for items processed inline."""
        with self._counter_lock:
            ventilated, completed = self._ventilated_items, self._completed_items
        return {
            "items_ventilated": ventilated,
            "items_processed": completed,
            "items_in_flight": ventilated - completed,
            "results_queue_size": len(self._results),
            "workers_count": self.workers_count,
        }

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        self._worker = worker_class(0, self._results.append, worker_setup_args)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        with self._counter_lock:
            self._ventilated_items += 1
        try:
            self._worker.process(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - forwarded to the consumer
            tb = "".join(traceback.format_exception(*sys.exc_info()))
            self._results.append(WorkerException(exc, tb))
        finally:
            with self._counter_lock:
                self._completed_items += 1
            if self._ventilator is not None:
                self._ventilator.processed_item()

    def get_results(self, timeout=None):
        while True:
            if self._results:
                result = self._results.popleft()
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
            time.sleep(0.001)

    def stop(self):
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()

    def join(self):
        if self._worker is not None:
            self._worker.shutdown()
