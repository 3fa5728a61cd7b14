"""Work ventilation: feeding items to a pool with a bounded in-flight count
(counterpart of ``petastorm_tpu/workers_pool/ventilator.py``).

The item order per epoch is ``random.Random(random_seed).shuffle`` of the
epoch's item list, exactly as in the JAX package, so one seed gives both
packages the same row-group order, resumed readers (``per_item_iterations``)
included. ``diagnostics`` and ``reset`` keep the JAX ventilator's key names
and meaning (``Reader.diagnostics`` / ``Reader.reset``), and the
``VENTILATOR_*`` registry families count as the JAX ventilator's do.
"""

from __future__ import annotations

import random
import threading
from abc import ABC, abstractmethod

from petastorm_tpu_torch.telemetry.metrics import VENTILATOR_EPOCHS, VENTILATOR_ITEMS


class Ventilator(ABC):
    """Base ventilator: feeds work items to a pool through ``ventilate_fn``."""

    def __init__(self, ventilate_fn):
        self._ventilate_fn = ventilate_fn

    @abstractmethod
    def start(self):
        """Begin ventilation (typically on a background thread)."""

    @abstractmethod
    def processed_item(self):
        """Note that one ventilated item finished (advances the window)."""

    @abstractmethod
    def completed(self):
        """True when no further items will ever be ventilated."""

    @abstractmethod
    def stop(self):
        """Stop ventilation and release the background thread."""


class ConcurrentVentilator(Ventilator):
    """Ventilates ``items_to_ventilate`` (kwargs dicts) for ``iterations``
    epochs (``None`` = forever) on a background thread, with at most
    ``max_ventilation_queue_size`` items in flight.

    ``per_item_iterations`` (resume): a list parallel to
    ``items_to_ventilate`` of how many more epochs each item is ventilated
    for; epoch ``e`` (0-based) ventilates the items with
    ``per_item_iterations[i] > e``. Requires finite ``iterations`` equal to
    ``max(per_item_iterations)``. ``ventilation_interval``: seconds between
    checks for room while the window is full."""

    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 randomize_item_order=False, random_seed=None,
                 max_ventilation_queue_size=None, ventilation_interval=0.01,
                 per_item_iterations=None):
        super().__init__(ventilate_fn)
        if iterations is not None and iterations <= 0:
            raise ValueError(f"iterations must be positive or None, got {iterations}")
        self._items_to_ventilate = list(items_to_ventilate)
        if per_item_iterations is not None:
            if iterations is None:
                raise ValueError("per_item_iterations requires finite iterations")
            if len(per_item_iterations) != len(self._items_to_ventilate):
                raise ValueError("per_item_iterations must parallel items_to_ventilate")
            if max(per_item_iterations, default=0) != iterations:
                raise ValueError("iterations must equal max(per_item_iterations)")
        self._per_item_iterations = per_item_iterations
        self._iterations = iterations
        self._randomize_item_order = randomize_item_order
        self._random = random.Random(random_seed)
        self._max_in_flight = (max_ventilation_queue_size
                               or len(self._items_to_ventilate) or 1)
        self._ventilation_interval = ventilation_interval
        self._in_flight = 0
        self._items_ventilated = 0
        self._epochs_completed = 0
        self._lock = threading.Lock()
        self._space_available = threading.Condition(self._lock)
        self._stop_requested = False
        self._completed = False
        self.error = None
        self._thread = None

    @property
    def diagnostics(self):
        """Live counters under the JAX ventilator's names: items ventilated
        and in flight, epochs completed, and whether ventilation is over."""
        with self._lock:
            return {
                "items_ventilated": self._items_ventilated,
                "items_in_flight": self._in_flight,
                "epochs_completed": self._epochs_completed,
                "ventilation_completed": self._completed,
            }

    def start(self):
        if self._thread is not None:
            raise RuntimeError("Ventilator already started")
        if not self._items_to_ventilate:
            self._completed = True
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-torch-ventilator")
        self._thread.start()

    def _run(self):
        try:
            iterations_left = self._iterations
            epoch = 0
            while iterations_left is None or iterations_left > 0:
                if self._per_item_iterations is None:
                    items = list(self._items_to_ventilate)
                else:
                    items = [item for item, n in zip(self._items_to_ventilate,
                                                     self._per_item_iterations)
                             if n > epoch]
                if self._randomize_item_order:
                    self._random.shuffle(items)
                for item in items:
                    with self._space_available:
                        while (self._in_flight >= self._max_in_flight
                               and not self._stop_requested):
                            self._space_available.wait(self._ventilation_interval)
                        if self._stop_requested:
                            return
                        self._in_flight += 1
                        self._items_ventilated += 1
                    VENTILATOR_ITEMS.inc()
                    self._ventilate_fn(**item)
                with self._lock:
                    self._epochs_completed += 1
                VENTILATOR_EPOCHS.inc()
                epoch += 1
                if iterations_left is not None:
                    iterations_left -= 1
        except Exception as exc:  # noqa: BLE001 - surfaced through self.error
            self.error = exc
        finally:
            self._completed = True

    def processed_item(self):
        with self._space_available:
            if self._in_flight > 0:
                self._in_flight -= 1
            self._space_available.notify()

    def completed(self):
        return self._completed

    def stop(self):
        with self._space_available:
            self._stop_requested = True
            self._space_available.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def reset(self):
        """Ventilate the same items again for the original number of
        iterations, the shuffle continuing its seeded stream; only once the
        previous run has finished."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("Cannot reset a ventilator that is still running")
        self._thread = None
        self._stop_requested = False
        self._completed = False
        self.error = None
        with self._lock:
            self._in_flight = 0
        self.start()


class DynamicVentilator(Ventilator):
    """A ventilator fed one item at a time through :meth:`submit` instead
    of from a planned list: the seam behind ``dynamic_ventilation=True``
    readers, through which the service's streaming piece engine feeds pieces
    into one long-lived pool as its mutable piece queue is consumed. The
    caller owns admission (how many pieces it keeps in flight); this class
    keeps the counts and the finished flag. It has no thread: :meth:`submit`
    calls ``ventilate_fn`` inline (a thread pool enqueues and returns, a
    dummy pool decodes inside the call)."""

    def __init__(self, ventilate_fn):
        super().__init__(ventilate_fn)
        self._lock = threading.Lock()
        self._in_flight = 0
        self._items_ventilated = 0
        self._finished = False
        #: Pools read ``ventilator.error``; a thread-less ventilator has none.
        self.error = None

    @property
    def diagnostics(self):
        with self._lock:
            return {"items_ventilated": self._items_ventilated,
                    "items_in_flight": self._in_flight,
                    "ventilation_completed": self._finished}

    def start(self):
        """Nothing to start: submissions drive everything."""

    def submit(self, item):
        """Feed one work item (a kwargs dict) to the pool."""
        with self._lock:
            if self._finished:
                raise RuntimeError(
                    "DynamicVentilator.submit after finish(): the stream already "
                    "declared its piece queue closed")
            self._in_flight += 1
            self._items_ventilated += 1
        VENTILATOR_ITEMS.inc()
        self._ventilate_fn(**item)

    def processed_item(self):
        with self._lock:
            if self._in_flight > 0:
                self._in_flight -= 1

    def finish(self):
        """No more submissions: once the items in flight drain, consumers
        see end-of-data (``EmptyResultError``) instead of blocking."""
        with self._lock:
            self._finished = True

    def completed(self):
        return self._finished

    def stop(self):
        self.finish()
