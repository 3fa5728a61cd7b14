"""Multi-process worker pool over zmq PUSH/PULL/PUB (the port's own copy of
``petastorm_tpu/workers_pool/process_pool.py``).

Topology, all host-local ``ipc://`` sockets in a temporary directory:

- ventilation: main PUSH  →  worker PULL   (load-balanced work items)
- results:     worker PUSH →  main PULL    (serialized payloads + control
  frames; ``SNDHWM`` / ``RCVHWM`` = ``results_queue_size`` is the
  backpressure)
- control:     main PUB   →  worker SUB    (the stop broadcast)

Workers are fresh interpreters (:mod:`.exec_in_new_process`), never
forks: the parent holds a CUDA context, and the workers see no card
(``CUDA_VISIBLE_DEVICES=""``) and import no torch. The worker class and its
setup arguments, and each work item, travel with cloudpickle (a predicate
may carry a lambda); payloads cross through a pluggable serializer (pickle
or Arrow IPC, :mod:`petastorm_tpu_torch.reader_impl`). The row and
columnar workers publish ``(item_key, payload)`` pairs and the batch worker
tables tagged in their schema metadata; both survive either serializer.

Frame kinds on the results socket: ``READY`` (startup sync), ``RESULT``
(a payload), ``DONE`` (one ventilated item finished, failed ones too),
``EXC`` (a worker exception and its traceback, raised to the consumer as
:class:`~petastorm_tpu_torch.workers_pool.WorkerException` and noted in
the flight recorder), ``EXIT`` (clean shutdown).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import time
from collections import deque

from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.telemetry.flight import RECORDER
from petastorm_tpu_torch.telemetry.metrics import (
    POOL_ITEMS_PROCESSED,
    POOL_ITEMS_VENTILATED,
)
from petastorm_tpu_torch.workers_pool import (
    DEFAULT_TIMEOUT_S,
    EmptyResultError,
    TimeoutWaitingForResultError,
    WorkerException,
)
from petastorm_tpu_torch.workers_pool.exec_in_new_process import exec_in_new_process

_FRAME_READY = b"READY"
_FRAME_RESULT = b"RESULT"
_FRAME_DONE = b"DONE"
_FRAME_EXC = b"EXC"
_FRAME_EXIT = b"EXIT"
_CTRL_STOP = b"STOP"

_STARTUP_TIMEOUT_S = 60


class ProcessPool:
    def __init__(self, workers_count, serializer=None, zmq_copy_buffers=True,
                 results_queue_size=50):
        self._workers_count = workers_count
        self._serializer = serializer or PickleSerializer()
        self._zmq_copy_buffers = zmq_copy_buffers
        self._results_queue_size = results_queue_size

        self._context = None
        self._vent_socket = None
        self._results_socket = None
        self._control_socket = None
        self._ipc_dir = None
        self._processes = []
        self._ventilator = None
        self._ventilated_items = 0
        self._completed_items = 0
        self._exited_workers = 0
        self._stopped = False
        # Locally buffered (kind, frames) messages already pulled off the zmq
        # socket — makes results_qsize a real depth (zmq's internal queue is
        # not introspectable) and lets diagnostics see pending results.
        # zmq sockets are NOT thread-safe: every poll/recv on the results
        # socket happens under _socket_lock so a diagnostics read from a
        # monitoring thread cannot race the consuming thread's recv.
        self._pending_frames = deque()
        self._socket_lock = threading.Lock()

    @property
    def workers_count(self):
        return self._workers_count

    @property
    def diagnostics(self):
        """Live pool counters under the JAX pool's keys: the thread pool's
        five, plus the workers that exited and the copy mode."""
        return {
            "items_ventilated": self._ventilated_items,
            "items_processed": self._completed_items,
            "items_in_flight": self._ventilated_items - self._completed_items,
            "results_queue_size": self.results_qsize(),
            "workers_count": self._workers_count,
            "exited_workers": self._exited_workers,
            "zmq_copy_buffers": self._zmq_copy_buffers,
        }

    def start(self, worker_class, worker_setup_args=None, ventilator=None):
        import zmq

        if self._context is not None:
            raise RuntimeError("ProcessPool already started")
        self._context = zmq.Context()
        self._ipc_dir = tempfile.mkdtemp(prefix="petastorm_torch_pool_")
        vent_endpoint = f"ipc://{self._ipc_dir}/ventilator"
        results_endpoint = f"ipc://{self._ipc_dir}/results"
        control_endpoint = f"ipc://{self._ipc_dir}/control"

        self._vent_socket = self._context.socket(zmq.PUSH)
        self._vent_socket.setsockopt(zmq.LINGER, 0)
        self._vent_socket.bind(vent_endpoint)

        self._results_socket = self._context.socket(zmq.PULL)
        self._results_socket.setsockopt(zmq.LINGER, 0)
        self._results_socket.setsockopt(zmq.RCVHWM, self._results_queue_size)
        self._results_socket.bind(results_endpoint)

        self._control_socket = self._context.socket(zmq.PUB)
        self._control_socket.setsockopt(zmq.LINGER, 0)
        self._control_socket.bind(control_endpoint)

        import cloudpickle

        for worker_id in range(self._workers_count):
            process = exec_in_new_process(
                _worker_process_main,
                worker_id,
                cloudpickle.dumps((worker_class, worker_setup_args)),
                cloudpickle.dumps(self._serializer),
                vent_endpoint,
                results_endpoint,
                control_endpoint,
                self._results_queue_size,
                self._zmq_copy_buffers,
            )
            self._processes.append(process)

        # Startup sync: wait until every worker's PULL is connected before
        # ventilating, so PUSH load-balancing sees all peers.
        ready = 0
        deadline = time.monotonic() + _STARTUP_TIMEOUT_S
        while ready < self._workers_count:
            if not self._results_socket.poll(200):
                dead = [p for p in self._processes if p.poll() is not None]
                if dead or time.monotonic() > deadline:
                    codes = [p.poll() for p in self._processes]
                    self._emergency_shutdown()
                    raise RuntimeError(
                        f"Only {ready}/{self._workers_count} pool workers came "
                        f"up (exit codes: {codes}, timeout {_STARTUP_TIMEOUT_S}s)"
                    )
                continue
            frames = self._results_socket.recv_multipart()
            if frames[0] == _FRAME_READY:
                ready += 1
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def ventilate(self, *args, **kwargs):
        import cloudpickle

        # cloudpickle: work items may carry lambdas (e.g. in_lambda predicates)
        payload = cloudpickle.dumps((args, kwargs))
        self._ventilated_items += 1
        POOL_ITEMS_VENTILATED.inc()
        self._vent_socket.send(payload)

    def _recv_frames(self):
        """Receive one multipart message off the socket → ``(kind, frames)``."""
        if self._zmq_copy_buffers:
            # copy=False: RESULT payload frames stay in zmq-owned memory
            # and deserialization views them directly (arrays keep the
            # frames alive via the buffer protocol).
            zmq_frames = self._results_socket.recv_multipart(copy=False)
            return zmq_frames[0].bytes, zmq_frames
        frames = self._results_socket.recv_multipart()
        return frames[0], frames

    def _drain_socket_locked(self):
        # Caller must hold _socket_lock. Bounded: local buffer + zmq RCVHWM
        # together cap pending results at ~2x results_queue_size. Draining
        # past the cap would unblock workers stuck on their SNDHWM and defeat
        # the memory backpressure the HWM exists to provide (a monitoring
        # loop polling results_qsize must not grow host memory unboundedly).
        while (self._results_socket is not None
               and len(self._pending_frames) < self._results_queue_size
               and self._results_socket.poll(0)):
            self._pending_frames.append(self._recv_frames())

    def get_results(self, timeout=DEFAULT_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        while True:
            error = getattr(self._ventilator, "error", None) if self._ventilator else None
            if error is not None:
                raise RuntimeError(f"Ventilation failed: {error!r}") from error
            if self._all_done():
                raise EmptyResultError()
            received = None
            with self._socket_lock:
                if self._pending_frames:
                    received = self._pending_frames.popleft()
                elif self._results_socket.poll(100):
                    received = self._recv_frames()
            if received is None:
                self._check_worker_liveness()
                if time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError(
                        f"No results for {timeout}s; ventilated="
                        f"{self._ventilated_items} completed={self._completed_items}"
                    )
                continue
            kind, frames = received
            if kind == _FRAME_RESULT:
                if self._zmq_copy_buffers and hasattr(
                        self._serializer, "deserialize_from_frames"):
                    return self._serializer.deserialize_from_frames(
                        [f.buffer for f in frames[1:]])
                payload_frames = [getattr(f, "bytes", f) for f in frames[1:]]
                payload = (b"".join(payload_frames)
                           if len(payload_frames) > 1 else payload_frames[0])
                return self._serializer.deserialize(payload)
            if kind == _FRAME_DONE:
                self._completed_items += 1
                POOL_ITEMS_PROCESSED.inc()
                if self._ventilator is not None:
                    self._ventilator.processed_item()
                continue
            if kind == _FRAME_EXC:
                exc_repr, tb = pickle.loads(getattr(frames[1], "bytes",
                                                    frames[1]))
                RECORDER.note("pool.worker_exception", pool="process",
                              error=exc_repr[:200])
                raise WorkerException(RuntimeError(exc_repr), tb)
            if kind == _FRAME_EXIT:
                self._exited_workers += 1
                continue
            if kind == _FRAME_READY:  # late duplicate; harmless
                continue

    def _all_done(self):
        ventilation_over = self._ventilator is None or self._ventilator.completed()
        if not (ventilation_over
                and self._ventilated_items == self._completed_items):
            return False
        with self._socket_lock:
            return (not self._pending_frames
                    and not self._results_socket.poll(0))

    def _check_worker_liveness(self):
        for process in self._processes:
            code = process.poll()
            if code is not None and code != 0 and not self._stopped:
                raise WorkerException(
                    RuntimeError(f"Pool worker pid={process.pid} died with exit "
                                 f"code {code}"),
                    "(no traceback; the worker process terminated abnormally)",
                )

    def results_qsize(self):
        """Number of RESULT payloads ready for :meth:`get_results`.

        zmq's internal queue is not introspectable, so pending messages are
        pulled into a local buffer (still zero-copy under
        ``zmq_copy_buffers``) and counted there.
        """
        if self._results_socket is None:
            return 0
        with self._socket_lock:
            self._drain_socket_locked()
            return sum(1 for kind, _ in self._pending_frames
                       if kind == _FRAME_RESULT)

    def stop(self):
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()
        if self._control_socket is not None:
            self._control_socket.send(_CTRL_STOP)

    def join(self):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(p.poll() is not None for p in self._processes):
                break
            # Re-broadcast stop: PUB/SUB slow joiners may have missed the first,
            # and drain results so workers blocked on a full HWM can exit.
            if self._control_socket is not None:
                self._control_socket.send(_CTRL_STOP)
            if self._results_socket is not None:
                with self._socket_lock:
                    self._pending_frames.clear()
                    while self._results_socket.poll(0):
                        self._results_socket.recv_multipart()
            time.sleep(0.05)
        for process in self._processes:
            if process.poll() is None:  # pragma: no cover - stragglers only
                process.terminate()
                try:
                    process.wait(timeout=5)
                except Exception:
                    process.kill()
        self._close_sockets()

    def _emergency_shutdown(self):
        for process in self._processes:
            if process.poll() is None:
                process.terminate()
        self._close_sockets()

    def _close_sockets(self):
        for sock in (self._vent_socket, self._results_socket, self._control_socket):
            if sock is not None:
                sock.close(linger=0)
        self._vent_socket = self._results_socket = self._control_socket = None
        if self._context is not None:
            self._context.term()
            self._context = None
        if self._ipc_dir:
            shutil.rmtree(self._ipc_dir, ignore_errors=True)
            self._ipc_dir = None


class _WorkerStopped(Exception):
    """Raised inside a worker when the stop broadcast arrives mid-publish."""


def _worker_process_main(worker_id, worker_class_payload, serializer_payload,
                         vent_endpoint, results_endpoint, control_endpoint,
                         results_queue_size, zmq_copy_buffers=True):
    """Entry point of one pool worker process (runs in a fresh interpreter)."""
    import zmq

    worker_class, worker_setup_args = pickle.loads(worker_class_payload)
    serializer = pickle.loads(serializer_payload)

    context = zmq.Context()
    vent_socket = context.socket(zmq.PULL)
    vent_socket.setsockopt(zmq.LINGER, 0)
    vent_socket.connect(vent_endpoint)
    results_socket = context.socket(zmq.PUSH)
    results_socket.setsockopt(zmq.LINGER, 0)
    results_socket.setsockopt(zmq.SNDHWM, results_queue_size)
    results_socket.connect(results_endpoint)
    control_socket = context.socket(zmq.SUB)
    control_socket.setsockopt(zmq.LINGER, 0)
    control_socket.setsockopt(zmq.SUBSCRIBE, b"")
    control_socket.connect(control_endpoint)

    stop_requested = False

    def _stop_seen():
        nonlocal stop_requested
        if stop_requested:
            return True
        if control_socket.poll(0):
            control_socket.recv()
            stop_requested = True
        return stop_requested

    def _send(frames, copy=True):
        """Send with backpressure that stays responsive to the stop broadcast."""
        while True:
            try:
                results_socket.send_multipart(frames, flags=zmq.NOBLOCK,
                                              copy=copy)
                return
            except zmq.Again:
                if _stop_seen():
                    raise _WorkerStopped() from None
                time.sleep(0.005)

    use_frames = zmq_copy_buffers and hasattr(serializer,
                                              "serialize_to_frames")

    def publish(data):
        if use_frames:
            # Zero-copy: payload buffers (raw array memory) ride as their own
            # zmq frames; copy=False hands zmq references instead of copies
            # (zmq keeps them alive until the frames are flushed).
            _send([_FRAME_RESULT] + serializer.serialize_to_frames(data),
                  copy=False)
        else:
            _send([_FRAME_RESULT, serializer.serialize(data)])

    worker = worker_class(worker_id, publish, worker_setup_args)
    _send([_FRAME_READY, str(worker_id).encode()])

    poller = zmq.Poller()
    poller.register(vent_socket, zmq.POLLIN)
    poller.register(control_socket, zmq.POLLIN)
    try:
        while not stop_requested:
            events = dict(poller.poll(100))
            if control_socket in events:
                control_socket.recv()
                break
            if vent_socket not in events:
                continue
            args, kwargs = pickle.loads(vent_socket.recv())
            try:
                worker.process(*args, **kwargs)
            except _WorkerStopped:
                break
            except Exception as exc:  # noqa: BLE001 - forwarded to the consumer
                import traceback

                _send([_FRAME_EXC, pickle.dumps((repr(exc),
                                                 traceback.format_exc()))])
            # Failed items count as processed too (keeps the ventilation
            # window moving); send outside the try so a stop during the
            # EXC send doesn't double-fault.
            _send([_FRAME_DONE])
    except _WorkerStopped:
        pass
    finally:
        worker.shutdown()
        try:
            results_socket.send_multipart([_FRAME_EXIT], flags=zmq.NOBLOCK)
        except Exception:  # pragma: no cover
            pass
        vent_socket.close(linger=0)
        results_socket.close(linger=0)
        control_socket.close(linger=0)
        context.term()
        os._exit(0)
