"""``python -m petastorm_tpu_torch.service``: run a dispatcher or a batch
worker (the port's own copy of ``petastorm_tpu/service/cli.py``, its
``dispatcher``, ``worker``, ``status``, ``trace`` and ``diagnose``
commands).

A two-worker service on one machine::

    python -m petastorm_tpu_torch.service dispatcher --port 7077 --mode static
    python -m petastorm_tpu_torch.service worker --dispatcher 127.0.0.1:7077 \\
        --dataset-url file:///data/ds --reader batch --batch-size 512 &
    python -m petastorm_tpu_torch.service worker --dispatcher 127.0.0.1:7077 \\
        --dataset-url file:///data/ds --reader batch --batch-size 512 &

then, trainer-side::

    source = ServiceBatchSource(("127.0.0.1", 7077))
    loader = TorchDataLoader(None, batch_source=source, device="cuda")

``--mode dynamic`` rebalances each client's shard across the workers by
work stealing (a slow worker's unstarted pieces move to a faster or newly
joined one); workers started with ``--on-piece-error quarantine`` report an
undecodable piece and serve on. ``worker --cache mem`` (or ``mem+disk``
with ``--cache-dir``) keeps decoded batches, so later epochs skip the
decode; a client on the worker's host is served through a shared-memory
ring unless either side runs ``--transport tcp`` (a cached worker's warm
batches then travel as references into its frame pool).

Each process prints one JSON line with its bound address (port 0 picks a
free port) and serves until SIGINT or SIGTERM. ``--metrics-port`` serves
the process's metrics registry (:mod:`petastorm_tpu_torch.telemetry.http`).
``status --dispatcher host:port`` prints the dispatcher's control-plane
state as one JSON line (``--table``: one row per worker with its breaker
state, the transport its streams negotiated and, under dynamic sharding,
its steals in / out and backlog; the ownership generation in the header;
the brownout, quarantine and journal lines; with ``--trainer-metrics`` the
autotuner's knobs and decisions of a trainer's metrics endpoint). ``--journal-dir``
makes the dispatcher durable: a restart on the same directory replays it.

Fleet tracing: ``trace arm --dispatcher host:port`` arms every process's
span collector through the heartbeats, ``trace collect --out f.json``
writes the clock-aligned merged trace (Perfetto loads it), ``trace
disarm`` stops; ``diagnose --dispatcher host:port [--stall-pct x]`` (or
``--trace f.json``) prints the critical-path stall attribution and
journals its stage profile to the dispatcher. Workers never touch a CUDA
device; run them with ``CUDA_VISIBLE_DEVICES=""`` beside a trainer.
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
                      help="split assignment: static per-client shards, the fcfs shared "
                           "queue, or dynamic (per-client shards rebalanced by work "
                           "stealing)")
    disp.add_argument("--num-epochs", type=int, default=1,
                      help="epochs to serve; 0 means serve forever")
    disp.add_argument("--journal-dir", default=None,
                      help="crash-recovery journal directory (JSONL WAL and compacted "
                           "snapshots); a restarted dispatcher replays it. Omit for "
                           "in-memory state")
    disp.add_argument("--journal-compact-every", type=int, default=256,
                      help="WAL records between snapshot compactions")
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
                      help="decoded-batch cache: serve repeat-epoch streams from memory "
                           "(mem), with disk spill and restart persistence (mem+disk), "
                           "instead of decoding again")
    work.add_argument("--cache-mem-mb", type=float, default=256.0,
                      help="memory budget of the cache's memory tier (LRU beyond it)")
    work.add_argument("--cache-dir", default=None,
                      help="mem+disk tier directory; a given directory persists across "
                           "worker restarts, omitted = a private temporary one removed on "
                           "stop")
    work.add_argument("--cache-disk-mb", type=float, default=None,
                      help="disk-tier budget (LRU beyond it); default unlimited")
    work.add_argument("--fleet-cache", action="store_true", dest="fleet_cache",
                      help="the fleet cache tier (comes with a later slice)")
    work.add_argument("--standby", action="store_true",
                      help="pooled standby capacity (comes with a later slice)")
    work.add_argument("--on-piece-error", default="fail", choices=["fail", "quarantine"],
                      dest="on_piece_error",
                      help="poison-piece policy: 'quarantine' reports an undecodable "
                           "piece (piece_failed) and serves on; 'fail' errors the stream")
    work.add_argument("--corpus", default="",
                      help="corpus of a multi-corpus fleet (comes with a later slice)")
    work.add_argument("--transport", default=None, choices=["auto", "tcp", "shm"],
                      help="data-plane tier: auto (a client on this host negotiates the "
                           "shared-memory ring, others ride TCP), tcp (never negotiate), "
                           "shm (as auto; TCP still serves where shm cannot); omit for "
                           "$PETASTORM_TRANSPORT")
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
    stat.add_argument("--table", action="store_true",
                      help="a table of the workers (transport, breaker state; steals "
                           "and backlog under dynamic sharding) and the brownout, "
                           "quarantine and journal lines instead of JSON")
    stat.add_argument("--trainer-metrics", default=None,
                      help="host:port of a trainer's metrics endpoint: adds the "
                           "autotuner's knob and decision lines to --table")

    trace = sub.add_parser("trace", help="fleet tracing: arm every process's span "
                                         "collector, collect the merged trace, or disarm")
    trace.add_argument("action", nargs="?", default="collect",
                       choices=["arm", "collect", "disarm"])
    trace.add_argument("--dispatcher", required=True, help="dispatcher address host:port")
    trace.add_argument("--out", default="fleet-trace.json",
                       help="collect: where the merged trace JSON lands")

    diag = sub.add_parser("diagnose", help="critical-path stall attribution over a fleet "
                                           "trace")
    diag.add_argument("--dispatcher", default=None,
                      help="collect the trace live from this (armed) dispatcher and "
                           "journal the stage profile back to it")
    diag.add_argument("--trace", default=None, help="a collected trace JSON file instead")
    diag.add_argument("--stall-pct", type=float, default=None,
                      help="the measured input_stall_pct: each bottleneck row then shows "
                           "its share of it")
    diag.add_argument("--json", action="store_true", dest="as_json",
                      help="the full report as JSON instead of the ranked table")
    diag.add_argument("--no-post", action="store_true",
                      help="do not journal the stage profile to the dispatcher")
    return parser


def build_service_node(args):
    """argparse namespace → an unstarted Dispatcher or BatchWorker."""
    if args.role == "dispatcher":
        from petastorm_tpu_torch.service.dispatcher import Dispatcher

        return Dispatcher(host=args.host, port=args.port, mode=args.mode,
                          num_epochs=args.num_epochs or None, journal_dir=args.journal_dir,
                          lease_timeout_s=args.lease_timeout or None,
                          journal_compact_every=args.journal_compact_every,
                          journal_fsync=args.journal_fsync, shuffle_seed=args.shuffle_seed,
                          autoscale=True if args.autoscale else None)
    from petastorm_tpu_torch.cache_impl import CacheConfig
    from petastorm_tpu_torch.service.worker import BatchWorker

    return BatchWorker(
        args.dataset_url,
        dispatcher_address=parse_address(args.dispatcher) if args.dispatcher else None,
        host=args.host, port=args.port, batch_size=args.batch_size,
        reader_factory=args.reader, worker_id=args.worker_id, standby=args.standby,
        on_piece_error=args.on_piece_error, corpus=args.corpus,
        heartbeat_interval_s=args.heartbeat_interval or None,
        batch_transform=resolve_batch_transform(args.batch_transform),
        transport=args.transport, fleet_cache=args.fleet_cache,
        batch_cache=CacheConfig(mode=args.cache, mem_mb=args.cache_mem_mb,
                                cache_dir=args.cache_dir, disk_mb=args.cache_disk_mb).build(),
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


def _request(address, header, timeout=10.0):
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    with FramedConnection.connect(address, timeout=timeout) as conn:
        return conn.request(header)


def _transport_label(tcp_total, shm_total):
    """The TRANSPORT column: the tier the worker's streams negotiated so
    far, ``shm`` / ``tcp`` / ``mixed``, or ``--`` before any stream."""
    if tcp_total is None or shm_total is None or not (tcp_total + shm_total):
        return "--"
    if not tcp_total:
        return "shm"
    if not shm_total:
        return "tcp"
    return "mixed"


def render_status(status, worker_diagnostics=None):
    """A ``status`` reply → the ``status --table`` view: one row per worker
    (alive, lifecycle state, lease, the transport from its ``diagnostics``
    in ``worker_diagnostics``, the dynamic mode's steals in/out and
    backlog, breaker), the ownership generation in the header under dynamic
    sharding, and the brownout, breaker, quarantine, degraded and journal
    lines."""
    worker_diagnostics = worker_diagnostics or {}
    fleet = status.get("fleet") or {}
    breaker_open = fleet.get("breaker_open") or {}
    workers = status.get("workers") or {}
    dynamic = status.get("dynamic") or {}
    dyn_workers = dynamic.get("per_worker") or {}
    alive = sum(1 for w in workers.values() if w.get("alive"))
    header = (f"mode={status.get('mode')} fencing_epoch={status.get('fencing_epoch')} "
              f"workers={alive} alive/{len(workers) - alive} dead "
              f"clients={len(status.get('clients') or {})}")
    if dynamic:
        header += f" generation={dynamic.get('generation')}"
    lines = [header,
             f"{'WORKER':<20} {'ALIVE':>6} {'STATE':>9} {'LEASE_S':>8} {'TRANSPORT':>9} "
             f"{'STEALS':>9} {'BACKLOG':>8} {'BREAKER':>8}"]

    def transport_col(wid):
        metrics = (worker_diagnostics.get(wid) or {}).get("metrics") or {}
        return _transport_label(metrics.get("transport_streams_tcp_total"),
                                metrics.get("transport_streams_shm_total"))


    def steal_cols(wid):
        """``in/out`` piece moves and the pieces booked to the worker;
        ``--`` outside dynamic mode."""
        entry = dyn_workers.get(wid)
        if entry is None:
            return f"{'--':>9} {'--':>8}"
        steals = f"{entry['steals_in']}/{entry['steals_out']}"
        return f"{steals:>9} {entry['backlog']:>8}"

    for wid, w in sorted(workers.items()):
        lease = w.get("lease_expires_in_s")
        lines.append(f"{wid:<20} {'yes' if w.get('alive') else 'no':>6} "
                     f"{w.get('state', 'serving'):>9} "
                     f"{'--' if lease is None else f'{lease:.1f}':>8} "
                     f"{transport_col(wid):>9} {steal_cols(wid)} "
                     f"{'open' if wid in breaker_open else 'ok':>8}")
    brownout = fleet.get("brownout") or {}
    counts = brownout.get("counts") or {}
    line = (f"brownout: level={brownout.get('level', 0)} shed={counts.get('shed', 0)} "
            f"recover={counts.get('recover', 0)}")
    if brownout.get("reason"):
        line += f" reason={brownout['reason']}"
    if brownout.get("armed"):
        line += " [armed]"
    lines.append(line)
    if breaker_open:
        lines.append("breaker-open: " + " ".join(sorted(breaker_open)))
    if status.get("quarantined"):
        lines.append("quarantined: " + " ".join(sorted(status["quarantined"], key=int)))
    if status.get("degraded"):
        lines.append(f"DEGRADED (read-only): {status['degraded']}")
    journal = status.get("journal")
    if journal:
        lines.append(f"journal: {journal['path']} appended={journal['records_appended']} "
                     f"compactions={journal['compactions']} "
                     f"replays={(status.get('recovery') or {}).get('journal_replays', 0)}")
    return "\n".join(lines)


def collect_autotune_sample(metrics_address, timeout=3.0):
    """One ``/metrics.json`` poll of a trainer's metrics endpoint, cut to
    the autotuner's knob values and decision counts; ``None`` when it does
    not answer."""
    import urllib.error
    import urllib.request

    host, port = metrics_address
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics.json",
                                    timeout=timeout) as response:
            snapshot = json.loads(response.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError):
        return None
    knobs = {}
    for series in snapshot.get("petastorm_autotune_knob_value", {}).get("series", []):
        labels = series["labels"]
        knobs[(labels.get("controller", "0"), labels.get("knob", "?"))] = series.get("value")
    decisions = {}
    for series in snapshot.get("petastorm_autotune_decisions_total", {}).get("series", []):
        labels = series["labels"]
        decisions[(labels.get("knob", "?"), labels.get("direction", "?"))] = \
            series.get("value", 0.0)
    return {"knobs": knobs, "decisions": decisions}


def render_autotune_status(prev, cur):
    """The autotuner's lines under the fleet table: the knob values in
    force and the decisions of this window (the total in parentheses)."""
    if cur is None:
        return "autotune: trainer metrics unreachable"
    if not cur["knobs"]:
        return "autotune: no autotuned loader registered"
    controllers = {controller for controller, _ in cur["knobs"]}
    knobs = " ".join(
        (f"{name}={value:g}" if len(controllers) == 1 else f"{controller}/{name}={value:g}")
        for (controller, name), value in sorted(cur["knobs"].items()))
    moved = []
    prev_decisions = (prev or {}).get("decisions", {})
    for (knob, direction), total in sorted(cur["decisions"].items()):
        delta = total - prev_decisions.get((knob, direction), 0.0)
        if delta > 0 or total > 0:
            moved.append(f"{knob}:{direction}={int(delta)}({int(total)})")
    lines = [f"autotune knobs: {knobs}"]
    if moved:
        lines.append("autotune decisions (window(total)): " + " ".join(moved))
    return "\n".join(lines)


def collect_fleet_trace(address, timeout=15.0):
    """One ``trace collect`` request → the clock-aligned merged trace
    document (:func:`~petastorm_tpu_torch.telemetry.clockalign.
    assemble_fleet_trace`). Raises RuntimeError on an error reply."""
    from petastorm_tpu_torch.telemetry.clockalign import assemble_fleet_trace

    reply, payload = _request(address, {"type": "trace", "action": "collect"},
                              timeout=timeout)
    if reply.get("type") == "error":
        raise RuntimeError(reply.get("error", "trace collect failed"))
    payload = payload or {}
    local = payload.get("local") or {}
    peers = {str(name): {"events": buf.get("events") or [],
                         "offset_us": buf.get("offset_us"),
                         "dropped": int(buf.get("dropped") or 0),
                         "min_rtt_us": buf.get("min_rtt_us")}
             for name, buf in (payload.get("peers") or {}).items()}
    return assemble_fleet_trace(local.get("events") or [], peers,
                                local_dropped=int(local.get("dropped") or 0))


def run_trace(address, action, out=None):
    """``trace``: arm / disarm print the dispatcher's reply; collect writes
    the merged trace and prints its path, event count and alignment."""
    if action != "collect":
        reply, _ = _request(address, {"type": "trace", "action": action})
        print(json.dumps(reply), flush=True)
        return 0 if reply.get("type") != "error" else 1
    doc = collect_fleet_trace(address)
    path = out or "fleet-trace.json"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    print(json.dumps({"trace": path, "events": len(doc["traceEvents"]),
                      "clock_alignment": doc["otherData"].get("clock_alignment")}),
          flush=True)
    return 0


def run_diagnose(address=None, trace_path=None, as_json=False, stall_pct=None, post=True,
                 out=None):
    """``diagnose``: critical-path stall attribution over a fleet trace,
    collected live from an armed dispatcher or read from ``trace_path``;
    with ``post`` the stage profile is journaled back to the dispatcher."""
    from petastorm_tpu_torch.telemetry import critical_path

    out = out if out is not None else sys.stdout
    if trace_path is not None:
        with open(trace_path, encoding="utf-8") as f:
            events = (json.load(f) or {}).get("traceEvents") or []
    elif address is not None:
        events = collect_fleet_trace(address).get("traceEvents") or []
    else:
        print("diagnose needs --dispatcher (live collect) or --trace (a collected trace "
              "file)", file=sys.stderr, flush=True)
        return 2
    report = critical_path.diagnose(events, measured_stall_pct=stall_pct)
    if post and address is not None:
        try:
            _request(address, {"type": "stage_profile", "profile": report["stage_profile"],
                               "coverage_pct": report["coverage_pct"],
                               "source": "diagnose"})
        except (ConnectionError, OSError) as exc:
            print(f"stage profile not journaled: {exc}", file=sys.stderr, flush=True)
    print(json.dumps(report) if as_json else critical_path.render(report), file=out,
          flush=True)
    return 0


def main(argv=None, run_seconds=None, stop_event=None):
    """Entry point. ``run_seconds`` bounds the serve loop and ``stop_event``
    ends it early (an embedding test tears the node down with it); by
    default a node serves until SIGINT or SIGTERM."""
    args = _build_parser().parse_args(argv)
    if args.role == "status":
        address = parse_address(args.dispatcher)
        reply, _ = _request(address, {"type": "status"})
        if not args.table or reply.get("type") != "status":
            print(json.dumps(reply), flush=True)
            return 0 if reply.get("type") == "status" else 1
        _, workers = _request(address, {"type": "worker_diagnostics"})
        text = render_status(reply, workers)
        if args.trainer_metrics is not None:
            text += "\n" + render_autotune_status(
                None, collect_autotune_sample(parse_address(args.trainer_metrics)))
        print(text, flush=True)
        return 0
    if args.role == "trace":
        return run_trace(parse_address(args.dispatcher), args.action, out=args.out)
    if args.role == "diagnose":
        return run_diagnose(
            address=parse_address(args.dispatcher) if args.dispatcher else None,
            trace_path=args.trace, as_json=args.as_json, stall_pct=args.stall_pct,
            post=not args.no_post)
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
