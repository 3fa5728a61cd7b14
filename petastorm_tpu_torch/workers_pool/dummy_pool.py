"""Synchronous in-caller-thread pool, for deterministic tests (counterpart
of ``petastorm_tpu/workers_pool/dummy_pool.py``)."""

from __future__ import annotations

import sys
import time
import traceback
from collections import deque

from petastorm_tpu_torch.workers_pool import EmptyResultError, WorkerException


class DummyPool:
    """Processes each ventilated item inside :meth:`ventilate`."""

    def __init__(self):
        self._results = deque()
        self._worker = None
        self._ventilator = None
        self._stopped = False

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        self._worker = worker_class(0, self._results.append, worker_setup_args)
        if ventilator is not None:
            self._ventilator = ventilator
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        try:
            self._worker.process(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - forwarded to the consumer
            tb = "".join(traceback.format_exception(*sys.exc_info()))
            self._results.append(WorkerException(exc, tb))
        finally:
            if self._ventilator is not None:
                self._ventilator.processed_item()

    def get_results(self, timeout=None):
        while True:
            if self._results:
                result = self._results.popleft()
                if isinstance(result, WorkerException):
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
