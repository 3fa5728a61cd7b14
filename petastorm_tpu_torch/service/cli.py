"""``python -m petastorm_tpu_torch.service``: run a dispatcher or a batch
worker (the port's own copy of ``petastorm_tpu/service/cli.py``, its
``dispatcher``, ``worker``, ``status``, ``trace``, ``diagnose`` and
``set-mixture-weights`` commands).

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
autotuner's knobs and decisions of a trainer's metrics endpoint; ``--watch``:
the fleet view refreshed every ``--interval`` seconds, with per-worker rates,
the cache tier, worker states, jobs, the last fleet plan and hand-off).
``--journal-dir`` makes the dispatcher durable: a restart on the same
directory replays it.

The fleet: ``dispatcher --autoscale [--autoscale-interval s
--autoscale-planner streak|model]`` arms the autoscaler over the workers
started with ``--standby``; ``worker --cache mem --fleet-cache`` joins the
fleet cache tier. Jobs register from the trainer
(:func:`~petastorm_tpu_torch.service.fleet.register_job`).

Fleet tracing: ``trace arm --dispatcher host:port`` arms every process's
span collector through the heartbeats, ``trace collect --out f.json``
writes the clock-aligned merged trace (Perfetto loads it), ``trace
disarm`` stops; ``diagnose --dispatcher host:port [--stall-pct x]`` (or
``--trace f.json``) prints the critical-path stall attribution and
journals its stage profile to the dispatcher. Workers never touch a CUDA
device; run them with ``CUDA_VISIBLE_DEVICES=""`` beside a trainer.

Multi-corpus fleets: ``worker --corpus web`` registers the worker under a
corpus (one dataset a corpus, one dispatcher for all), and
``set-mixture-weights --dispatcher host:port --job j --weights
web=0.6,code=0.4 [--effective-epoch n]`` journals a weight change that
every ``MixedBatchSource`` of the job applies at that pass boundary.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time


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
                      help="arm the fleet autoscaler: admit --standby workers into serving "
                           "when the backlog piles up, drain and retire them when the fleet "
                           "idles; every decision journaled")
    disp.add_argument("--autoscale-interval", type=float, default=1.0,
                      help="the autoscaler's planning tick, seconds")
    disp.add_argument("--autoscale-planner", default="streak", choices=["streak", "model"],
                      help="'streak' (backlog hysteresis streaks) or 'model' (a fitted "
                           "per-worker throughput model, decisions checked by what-if "
                           "replay and journaled as fleet_plan records)")

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
                      help="join the fleet cache tier: entries placed on a consistent-hash "
                           "ring over every --fleet-cache worker, a warm miss fetched from "
                           "its owner instead of decoded, and a drain ships this worker's "
                           "memory tier to the peers inheriting its keys (needs --cache)")
    work.add_argument("--standby", action="store_true",
                      help="register as standby pool capacity: leased and observed but "
                           "granted nothing until the autoscaler (or "
                           "Dispatcher.admit_worker) admits it")
    work.add_argument("--on-piece-error", default="fail", choices=["fail", "quarantine"],
                      dest="on_piece_error",
                      help="poison-piece policy: 'quarantine' reports an undecodable "
                           "piece (piece_failed) and serves on; 'fail' errors the stream")
    work.add_argument("--corpus", default="",
                      help="corpus name for multi-corpus fleets: workers serving different "
                           "datasets under ONE dispatcher register distinct corpora; "
                           "clients request per-corpus assignments for deterministic "
                           "weighted mixing. Default: the single-dataset corpus")
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
    stat.add_argument("--watch", action="store_true",
                      help="refresh the fleet view (per-worker rates, cache tier, worker "
                           "states, jobs, the fleet plan and hand-off lines) until "
                           "interrupted")
    stat.add_argument("--interval", type=float, default=2.0,
                      help="--watch: seconds between polls (the rate window)")
    stat.add_argument("--trainer-metrics", default=None,
                      help="host:port of a trainer's metrics endpoint: adds the "
                           "autotuner's knob and decision lines to --table and --watch")

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

    mix = sub.add_parser(
        "set-mixture-weights",
        help="journal a mixture weight change at the dispatcher: every MixedBatchSource "
             "of the job applies it at the effective pass boundary, with no fleet or "
             "trainer restart")
    mix.add_argument("--dispatcher", required=True, help="dispatcher address host:port")
    mix.add_argument("--job", default="default", help="the job whose mixture to rebalance")
    mix.add_argument("--weights", required=True,
                     help="corpus=weight pairs, comma-separated (e.g. "
                          "web=0.6,code=0.3,books=0.1)")
    mix.add_argument("--effective-epoch", type=int, default=None,
                     help="the mixture pass the change takes effect at (its start "
                          "boundary); omit to apply at the next pass any source starts — "
                          "name it when the run must stay reproducible from the log")
    return parser


def parse_weights(spec):
    """``corpus=weight,…`` → ``{corpus: float}`` (the set-mixture-weights
    payload)."""
    out = {}
    for pair in spec.split(","):
        if "=" not in pair:
            raise ValueError(f"--weights expects corpus=weight pairs, got {pair!r}")
        name, _, value = pair.partition("=")
        out[name.strip()] = float(value)
    return out


def build_service_node(args):
    """argparse namespace → an unstarted Dispatcher or BatchWorker."""
    if args.role == "dispatcher":
        from petastorm_tpu_torch.service.dispatcher import Dispatcher

        return Dispatcher(host=args.host, port=args.port, mode=args.mode,
                          num_epochs=args.num_epochs or None, journal_dir=args.journal_dir,
                          lease_timeout_s=args.lease_timeout or None,
                          journal_compact_every=args.journal_compact_every,
                          journal_fsync=args.journal_fsync, shuffle_seed=args.shuffle_seed,
                          autoscale=({"interval_s": args.autoscale_interval,
                                      "planner": args.autoscale_planner}
                                     if args.autoscale else None))
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


def collect_fleet_sample(address, timeout=5.0, deadline_s=15.0):
    """One poll, timestamped: the dispatcher's ``status`` and the
    ``worker_diagnostics`` fan-out (two straddling an interval give rates).
    A failed poll is retried, so a watch rides through a restart."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
    from petastorm_tpu_torch.utils import retry_with_backoff

    def poll():
        with FramedConnection.connect(address, timeout=timeout) as conn:
            status, _ = conn.request({"type": "status"})
            _, workers = conn.request({"type": "worker_diagnostics"})
        return {"t": time.monotonic(), "status": status, "workers": workers or {}}

    return retry_with_backoff(poll, retries=4, base_delay=0.2, retry_on=(OSError,),
                              deadline_s=deadline_s, description="fleet status poll")


def _worker_totals(sample, wid):
    """The worker's lifetime totals, or ``None`` without a usable snapshot
    (a rate is never computed against an implicit zero)."""
    snapshot = sample["workers"].get(wid)
    if not snapshot or "error" in snapshot:
        return None
    metrics = snapshot.get("metrics") or {}
    return (metrics.get("rows_sent_total", 0.0), metrics.get("batches_sent_total", 0.0),
            metrics.get("credit_wait_seconds_total", 0.0), metrics.get("active_streams", 0.0),
            # None without a batch cache: the column shows "--", not 0 %.
            metrics.get("cache_hits_total"), metrics.get("cache_misses_total"),
            metrics.get("cache_permuted_serves_total"),
            metrics.get("transport_streams_tcp_total"),
            metrics.get("transport_streams_shm_total"),
            metrics.get("columnar_batches_total"), metrics.get("row_fallback_batches_total"),
            metrics.get("cache_tier"), metrics.get("cache_entries_mem"))


def _cache_label(tier, entries_mem):
    """The CACHE column: the worker's cache tier and its memory entries
    (``fleet:12``, ``local:3``), ``--`` without a batch cache."""
    if tier is None:
        return "--"
    return f"{tier}:{int(entries_mem or 0)}"


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


def render_fleet_status(prev, cur):
    """Two timestamped samples → the ``status --watch`` view (the JAX CLI's
    lines): the control-plane header, one row a worker of lifetime totals
    and rates over the window (rows, batches, credit wait, cache hit rate,
    cache tier, columnar share, permuted serves, steals, backlog, breaker),
    the fleet total, then the worker states and autoscale counts, the last
    fleet plan, the last cache hand-off, the brownout, the breakers, a line
    a job (its rows/s, share, epoch, fencing, clients, backlog, steals,
    recovery) and the recovery counters. Pure."""
    status = cur["status"]
    dt = max(1e-9, cur["t"] - prev["t"])
    workers_state = status.get("workers", {})
    alive = sum(1 for w in workers_state.values() if w.get("alive"))
    dynamic = status.get("dynamic") or {}
    dyn_workers = dynamic.get("per_worker", {})
    fleet = status.get("fleet") or {}
    breaker_open = fleet.get("breaker_open") or {}
    header = (f"mode={status.get('mode')} fencing_epoch={status.get('fencing_epoch')} "
              f"workers={alive} alive/{len(workers_state) - alive} dead "
              f"clients={len(status.get('clients', {}))} window={dt:.1f}s")
    if dynamic:
        header += f" generation={dynamic.get('generation')}"
    lines = [header,
             f"{'WORKER':<20} {'ROWS/S':>10} {'BATCH/S':>8} {'STREAMS':>8} "
             f"{'TRANSPORT':>9} {'CREDITWAIT/S':>13} {'ROWS_TOTAL':>12} "
             f"{'CACHEHIT%':>10} {'CACHE':>10} {'COL%':>6} {'PERM/S':>7} "
             f"{'STEALS':>9} {'BACKLOG':>8} {'BREAKER':>8}"]

    def breaker_col(wid):
        return f"{'open' if wid in breaker_open else 'ok':>8}"

    def steal_cols(wid):
        entry = dyn_workers.get(wid)
        if entry is None:
            return f"{'--':>9} {'--':>8}"
        steals = f"{entry['steals_in']}/{entry['steals_out']}"
        return f"{steals:>9} {entry['backlog']:>8}"

    fleet_rows = fleet_batches = 0.0
    for wid in sorted(cur["workers"]):
        now = _worker_totals(cur, wid)
        if now is None:
            lines.append(f"{wid:<20} {'unreachable':>10}")
            continue
        (rows1, batches1, wait1, active, hits1, misses1, perm1, tcp1, shm1, col1, colfb1,
         tier1, entries1) = now
        transport = _transport_label(tcp1, shm1)
        cache = _cache_label(tier1, entries1)
        before = _worker_totals(prev, wid)
        if before is None:
            # No baseline: the totals are real, the rates unknowable.
            lines.append(f"{wid:<20} {'--':>10} {'--':>8} {int(active):>8} {transport:>9} "
                         f"{'--':>13} {int(rows1):>12} {'--':>10} {cache:>10} {'--':>6} "
                         f"{'--':>7} {steal_cols(wid)} {breaker_col(wid)}")
            continue
        rows0, batches0, wait0, _, hits0, misses0, perm0, _, _, col0, colfb0, _, _ = before
        rows_rate = max(0.0, rows1 - rows0) / dt
        batch_rate = max(0.0, batches1 - batches0) / dt
        wait_rate = max(0.0, wait1 - wait0) / dt
        fleet_rows += rows_rate
        fleet_batches += batch_rate
        hit_pct = "--"
        if hits1 is not None and misses1 is not None and hits0 is not None \
                and misses0 is not None:
            # This window's hit rate (a missing baseline shows "--").
            hit_delta = max(0.0, hits1 - hits0)
            lookups = hit_delta + max(0.0, misses1 - misses0)
            if lookups > 0:
                hit_pct = f"{100.0 * hit_delta / lookups:.1f}"
        col_pct = "--"
        if col1 is not None and colfb1 is not None:
            col_delta = max(0.0, col1 - (col0 or 0.0))
            col_total = col_delta + max(0.0, colfb1 - (colfb0 or 0.0))
            if col_total > 0:
                col_pct = f"{100.0 * col_delta / col_total:.1f}"
        perm_rate = "--"
        if perm1 is not None:
            perm_rate = f"{max(0.0, perm1 - (perm0 or 0.0)) / dt:.2f}"
        lines.append(f"{wid:<20} {rows_rate:>10.1f} {batch_rate:>8.2f} {int(active):>8} "
                     f"{transport:>9} {wait_rate:>13.3f} {int(rows1):>12} {hit_pct:>10} "
                     f"{cache:>10} {col_pct:>6} {perm_rate:>7} {steal_cols(wid)} "
                     f"{breaker_col(wid)}")
    lines.append(f"{'fleet':<20} {fleet_rows:>10.1f} {fleet_batches:>8.2f}")
    by_state = fleet.get("workers_by_state") or {}
    if by_state:
        autoscale = fleet.get("autoscale") or {}
        line = "states: " + " ".join(f"{state}={len(by_state.get(state) or [])}"
                                     for state in ("serving", "standby", "draining"))
        if any(autoscale.values()):
            line += " autoscale: " + " ".join(f"{k}={v}" for k, v in sorted(autoscale.items())
                                              if v)
        if fleet.get("autoscaler_armed"):
            line += " [autoscaler on]"
        lines.append(line)
    plans = fleet.get("fleet_plans") or []
    if plans:
        last = plans[-1]
        parts = [f"fleet-plan: {last.get('action')}", f"worker={last.get('worker_id')}"]
        if last.get("predicted_rows_s") is not None:
            parts.append(f"predicted_rows/s={last['predicted_rows_s']:.1f}")
        if last.get("whatif_error") is not None:
            parts.append(f"whatif_err={100.0 * last['whatif_error']:.1f}%")
        lines.append(" ".join(parts))
    handoffs = fleet.get("cache_handoffs") or []
    if handoffs:
        last = handoffs[-1]
        lines.append(f"cache-handoff: {last.get('worker_id')} shipped "
                     f"{last.get('entries', 0)} entries ({last.get('bytes', 0)} bytes) to "
                     f"{len(last.get('peers') or {})} peers, {last.get('errors', 0)} errors"
                     + (" [TORN]" if last.get("torn") else ""))
    brownout = fleet.get("brownout") or {}
    if brownout.get("level") or brownout.get("armed") \
            or any((brownout.get("counts") or {}).values()):
        counts = brownout.get("counts") or {}
        parts = [f"brownout: level={brownout.get('level', 0)}",
                 f"shed={counts.get('shed', 0)}", f"recover={counts.get('recover', 0)}"]
        if brownout.get("reason"):
            parts.append(f"reason={brownout['reason']}")
        if brownout.get("armed"):
            parts.append("[armed]")
        lines.append(" ".join(parts))
    if breaker_open:
        lines.append("breaker-open: " + " ".join(sorted(breaker_open)))
    jobs = status.get("jobs") or {}
    if len(jobs) > 1 or any(jid != "default" for jid in jobs):
        prev_jobs, cur_jobs = _job_row_totals(prev), _job_row_totals(cur)
        for jid, job in sorted(jobs.items()):
            rate = "--"
            if jid in cur_jobs and jid in prev_jobs:
                rate = f"{max(0.0, cur_jobs[jid] - prev_jobs[jid]) / dt:.1f}"
            parts = [f"job {jid}:", f"rows/s={rate}", f"share={job.get('fair_share', 0.0):g}",
                     f"epoch={job.get('epoch', 0)}", f"fencing={job.get('fencing_epoch', 0)}",
                     f"clients={len(job.get('clients') or [])}"]
            if "backlog" in job:
                parts.append(f"backlog={job['backlog']}")
                parts.append(f"steals={job.get('steals_in', 0)}/{job.get('steals_out', 0)}")
            job_recovery = {k: v for k, v in (job.get("recovery") or {}).items() if v}
            if job_recovery:
                parts.append("recovery: " + " ".join(f"{k}={v}"
                                                     for k, v in sorted(job_recovery.items())))
            lines.append(" ".join(parts))
    recovery = {k: v for k, v in (status.get("recovery") or {}).items() if v}
    if recovery:
        lines.append("recovery: " + " ".join(f"{k}={v}" for k, v in sorted(recovery.items())))
    return "\n".join(lines)


def _job_row_totals(sample):
    """Rows per job summed over every reachable worker's ``jobs`` block."""
    totals = {}
    for snapshot in sample["workers"].values():
        if not snapshot or "error" in snapshot:
            continue
        for jid, counts in (snapshot.get("jobs") or {}).items():
            totals[jid] = totals.get(jid, 0) + counts.get("rows", 0)
    return totals


def run_status(address, watch=False, interval_s=2.0, out=None, max_refreshes=None,
               stop_event=None, trainer_metrics=None):
    """Poll and render :func:`render_fleet_status` once after
    ``interval_s``, or with ``watch`` each ``interval_s`` until interrupted
    (``max_refreshes`` / ``stop_event`` bound it). An unreachable
    dispatcher ends a single render with 1; a watch reports it and polls
    again."""
    out = out if out is not None else sys.stdout
    prev = collect_fleet_sample(address)
    prev_tune = (collect_autotune_sample(trainer_metrics)
                 if trainer_metrics is not None else None)
    refreshes = 0
    while not (stop_event is not None and stop_event.is_set()):
        time.sleep(interval_s)
        try:
            cur = collect_fleet_sample(address)
        except OSError as exc:
            if not watch:
                out.write(f"dispatcher unreachable: {exc}\n")
                return 1
            out.write(f"dispatcher unreachable ({exc}); retrying...\n")
            out.flush()
            continue
        if watch:
            out.write("\x1b[2J\x1b[H")  # clear and home
        out.write(render_fleet_status(prev, cur) + "\n")
        if trainer_metrics is not None:
            cur_tune = collect_autotune_sample(trainer_metrics)
            out.write(render_autotune_status(prev_tune, cur_tune) + "\n")
            prev_tune = cur_tune
        out.flush()
        prev = cur
        refreshes += 1
        if not watch or (max_refreshes is not None and refreshes >= max_refreshes):
            break
    return 0


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
    if args.role == "set-mixture-weights":
        from petastorm_tpu_torch.service.mixture import set_mixture_weights

        reply = set_mixture_weights(parse_address(args.dispatcher),
                                    parse_weights(args.weights), job_id=args.job,
                                    effective_epoch=args.effective_epoch)
        print(json.dumps({"job_id": reply.get("job_id"), "seq": reply.get("seq"),
                          "entries": reply.get("entries")}), flush=True)
        return 0
    if args.role == "status":
        address = parse_address(args.dispatcher)
        if args.watch:
            try:
                return run_status(address, watch=True, interval_s=args.interval,
                                  trainer_metrics=(parse_address(args.trainer_metrics)
                                                   if args.trainer_metrics else None))
            except KeyboardInterrupt:
                return 0
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
