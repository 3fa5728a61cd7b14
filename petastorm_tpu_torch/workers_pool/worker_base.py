"""Worker contract (counterpart of ``petastorm_tpu/workers_pool/worker_base.py``)."""

from __future__ import annotations


class WorkerBase:
    """A pool worker: subclasses implement :meth:`process` and emit results
    through ``publish_func``."""

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def process(self, *args, **kwargs):
        raise NotImplementedError

    def shutdown(self):
        """Called once when the pool stops this worker (optional cleanup)."""


class EOFSentinel:
    """End-of-work marker placed on worker input queues."""
