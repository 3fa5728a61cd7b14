"""Worker pools and ventilation (the port's own copy of
``petastorm_tpu/workers_pool``).

The three pools share one contract: ``start``/``ventilate``/
``get_results``/``stop``/``join``. The thread pool runs N decode threads
(pyarrow releases the GIL); the process pool runs N fresh interpreters
over zmq (:mod:`.process_pool`), for decode that holds the interpreter;
the dummy pool decodes synchronously, for deterministic tests.
"""

DEFAULT_TIMEOUT_S = 60


class EmptyResultError(Exception):
    """All ventilated items were processed and every result was consumed."""


class TimeoutWaitingForResultError(Exception):
    """``get_results`` waited longer than the configured timeout."""


class VentilatedItemProcessedMessage:
    """Control marker a worker emits after finishing one ventilated item.
    ``item`` carries the item's kwargs in the thread and dummy pools (the
    streaming piece engine attributes a piece's completion through it);
    ``None`` where the pool cannot say."""

    def __init__(self, item=None):
        self.item = item


class WorkerException(Exception):
    """Wraps an exception raised inside a worker, carrying its traceback."""

    def __init__(self, exc, formatted_traceback):
        self.exc = exc
        self.formatted_traceback = formatted_traceback
        super().__init__(f"Worker raised {exc!r}\n{formatted_traceback}")
