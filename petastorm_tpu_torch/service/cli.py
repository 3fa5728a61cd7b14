"""``python -m petastorm_tpu_torch.service``: run a dispatcher or a batch
worker (the port's own copy of ``petastorm_tpu/service/cli.py``, its
``dispatcher``, ``worker`` and ``status`` commands).

A two-worker service on one machine::

    python -m petastorm_tpu_torch.service dispatcher --port 7077 --mode static
    python -m petastorm_tpu_torch.service worker --dispatcher 127.0.0.1:7077 \\
        --dataset-url file:///data/ds --reader batch --batch-size 512 &
    python -m petastorm_tpu_torch.service worker --dispatcher 127.0.0.1:7077 \\
        --dataset-url file:///data/ds --reader batch --batch-size 512 &

then, trainer-side::

    source = ServiceBatchSource(("127.0.0.1", 7077))
    loader = TorchDataLoader(None, batch_source=source, device="cuda")

Each process prints one JSON line with its bound address (port 0 picks a
free port) and serves until SIGINT or SIGTERM. ``--metrics-port`` serves
the process's metrics registry (:mod:`petastorm_tpu_torch.telemetry.http`).
``status --dispatcher host:port`` prints the dispatcher's control-plane
state as one JSON line. Workers never touch a CUDA device; run them with
``CUDA_VISIBLE_DEVICES=""`` beside a trainer.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def parse_address(value):
    """``"host:port"`` (or a bare ``"port"``) → ``(host, port)``."""
    host, _, port = str(value).rpartition(":")
    return (host or "127.0.0.1", int(port))


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m petastorm_tpu_torch.service",
        description="Data service: the dispatcher owns split assignment; workers "
                    "serve collated numpy batches over TCP")
    sub = parser.add_subparsers(dest="role", required=True)

    disp = sub.add_parser("dispatcher", help="run the split dispatcher")
    disp.add_argument("--host", default="127.0.0.1")
    disp.add_argument("--port", type=int, default=7077,
                      help="0 picks a free port (printed on stdout)")
    disp.add_argument("--mode", choices=["static", "fcfs", "dynamic"], default="static",
                      help="split assignment: static per-client shards or the fcfs shared "
                           "queue (dynamic comes with a later slice)")
    disp.add_argument("--num-epochs", type=int, default=1,
                      help="epochs to serve; 0 means serve forever")
    disp.add_argument("--journal-dir", default=None,
                      help="crash-recovery journal (comes with a later slice)")
    disp.add_argument("--lease-timeout", type=float, default=30.0,
                      help="seconds without a heartbeat before a worker is evicted; 0 "
                           "disables lease expiry")
    disp.add_argument("--journal-fsync", action="store_true",
                      help="fsync the journal per record (with --journal-dir)")
    disp.add_argument("--shuffle-seed", type=int, default=None,
                      help="seed-tree deterministic piece order; omit for ascending order")
    disp.add_argument("--autoscale", action="store_true",
                      help="the fleet autoscaler (comes with a later slice)")

    work = sub.add_parser("worker", help="run a batch worker")
    work.add_argument("--dispatcher", default=None,
                      help="dispatcher address host:port (omit for a worker addressed "
                           "directly)")
    work.add_argument("--host", default="127.0.0.1")
    work.add_argument("--port", type=int, default=0)
    work.add_argument("--dataset-url", required=True)
    work.add_argument("--batch-size", type=int, default=256)
    work.add_argument("--reader", choices=["row", "batch", "columnar"], default="row",
                      help="row=make_reader, batch=make_batch_reader, "
                           "columnar=make_columnar_reader")
    work.add_argument("--workers-count", type=int, default=4,
                      help="reader pool size inside this worker")
    work.add_argument("--reader-pool-type", default="thread",
                      choices=["thread", "process", "dummy"])
    work.add_argument("--worker-id", default=None)
    work.add_argument("--heartbeat-interval", type=float, default=5.0,
                      help="seconds between lease renewals (also re-registers after a "
                           "dispatcher restart); 0 disables")
    work.add_argument("--cache", choices=["off", "mem", "mem+disk"], default="off",
                      help="the decoded-batch cache on workers (comes with a later slice)")
    work.add_argument("--standby", action="store_true",
                      help="pooled standby capacity (comes with a later slice)")
    work.add_argument("--on-piece-error", default="fail", choices=["fail", "quarantine"],
                      dest="on_piece_error",
                      help="poison-piece policy ('quarantine' comes with a later slice)")
    work.add_argument("--corpus", default="",
                      help="corpus of a multi-corpus fleet (comes with a later slice)")
    work.add_argument("--transport", default=None, choices=["auto", "tcp", "shm"],
                      help="data-plane tier: auto and tcp serve TCP (shm comes with a "
                           "later slice); omit for $PETASTORM_TRANSPORT")
    work.add_argument("--batch-transform", default=None,
                      help="module:attr of the batch transform ({field: ndarray} -> "
                           "{field: ndarray}) applied before serialization unless the "
                           "stream asks for local placement")
    for role in (disp, work):
        role.add_argument("--metrics-port", type=int, default=None,
                          help="serve this process's metrics registry on this port (0 "
                               "picks a free one, printed on stdout)")

    stat = sub.add_parser("status", help="print the dispatcher's control-plane state")
    stat.add_argument("--dispatcher", required=True, help="dispatcher address host:port")
    return parser


def build_service_node(args):
    """argparse namespace → an unstarted Dispatcher or BatchWorker."""
    if args.role == "dispatcher":
        from petastorm_tpu_torch.service.dispatcher import Dispatcher

        return Dispatcher(host=args.host, port=args.port, mode=args.mode,
                          num_epochs=args.num_epochs or None, journal_dir=args.journal_dir,
                          lease_timeout_s=args.lease_timeout or None,
                          journal_fsync=args.journal_fsync, shuffle_seed=args.shuffle_seed,
                          autoscale=True if args.autoscale else None)
    from petastorm_tpu_torch.service.worker import BatchWorker

    if args.cache != "off":
        raise NotImplementedError(
            "worker --cache is not ported yet: the decoded-batch cache on workers comes "
            "with the fleet, slice (d)")
    return BatchWorker(
        args.dataset_url,
        dispatcher_address=parse_address(args.dispatcher) if args.dispatcher else None,
        host=args.host, port=args.port, batch_size=args.batch_size,
        reader_factory=args.reader, worker_id=args.worker_id, standby=args.standby,
        on_piece_error=args.on_piece_error, corpus=args.corpus,
        heartbeat_interval_s=args.heartbeat_interval or None,
        batch_transform=resolve_batch_transform(args.batch_transform),
        transport=args.transport,
        reader_kwargs={"workers_count": args.workers_count,
                       "reader_pool_type": args.reader_pool_type})


def resolve_batch_transform(spec):
    """``module:attr`` (dotted attributes allowed) → the callable."""
    if spec is None:
        return None
    module_name, sep, attr = str(spec).partition(":")
    if not sep or not attr:
        raise ValueError(f"--batch-transform must be module:attr, got {spec!r}")
    import importlib

    target = importlib.import_module(module_name)
    for part in attr.split("."):
        target = getattr(target, part)
    if not callable(target):
        raise ValueError(f"--batch-transform {spec!r} is not callable")
    return target


def main(argv=None, run_seconds=None, stop_event=None):
    """Entry point. ``run_seconds`` bounds the serve loop and ``stop_event``
    ends it early (an embedding test tears the node down with it); by
    default a node serves until SIGINT or SIGTERM."""
    args = _build_parser().parse_args(argv)
    if args.role == "status":
        from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

        with FramedConnection.connect(parse_address(args.dispatcher), timeout=10.0) as conn:
            reply, _ = conn.request({"type": "status"})
        print(json.dumps(reply), flush=True)
        return 0 if reply.get("type") == "status" else 1
    node = build_service_node(args)
    metrics_server = None
    if args.metrics_port is not None:
        from petastorm_tpu_torch.telemetry.http import MetricsServer

        # Bound before the node starts: a worker's registration advertises
        # the port the kernel chose for --metrics-port 0.
        metrics_server = MetricsServer(host=args.host, port=args.metrics_port).start()
        if args.role == "worker":
            node.metrics_port = metrics_server.address[1]
        else:
            node.metrics_address = list(metrics_server.address)
    try:
        node.start()
    except BaseException:
        if metrics_server is not None:
            metrics_server.stop()
        raise
    host, port = node.address
    print(json.dumps({"role": args.role, "host": host, "port": port,
                      **({"worker_id": node.worker_id} if args.role == "worker" else {}),
                      **({"metrics_port": metrics_server.address[1]}
                         if metrics_server is not None else {})}), flush=True)
    stop = stop_event if stop_event is not None else threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (tests)
    try:
        stop.wait(timeout=run_seconds)
    except KeyboardInterrupt:
        pass
    finally:
        if metrics_server is not None:
            metrics_server.stop()
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
