"""``python -m petastorm_tpu_torch.benchmark`` console entry.

The port's own copy of ``petastorm_tpu/benchmark/cli.py`` (reference
parity: ``petastorm/benchmark/cli.py``, console script
``petastorm-throughput.py``), with the port's flag names for the loader
mode: ``--torch-loader``, ``--torch-batch-size`` and ``--device``. The
JAX package's ``--jax-loader`` / ``--jax-batch-size`` are refused by name.
"""

from __future__ import annotations

import argparse
import sys

#: The JAX CLI's loader flags, with the port's.
_JAX_FLAGS = {"--jax-loader": "--torch-loader",
              "--jax-batch-size": "--torch-batch-size"}


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "scenario":
        return _scenario_main(argv[1:])
    from petastorm_tpu_torch.benchmark.scenarios import SCENARIOS

    parser = argparse.ArgumentParser(
        description="Measure Reader throughput (rows/sec) on a dataset; or "
                    "run a named workload: "
                    f"`scenario {{{','.join(sorted(SCENARIOS))}}}`")
    parser.add_argument("dataset_url")
    parser.add_argument("--field-regex", nargs="*", default=None,
                        help="read only fields matching these regexes")
    parser.add_argument("-w", "--warmup-cycles", type=int, default=200)
    parser.add_argument("-m", "--measure-cycles", type=int, default=1000)
    parser.add_argument("-p", "--pool-type", default="thread",
                        choices=["thread", "process", "dummy"])
    parser.add_argument("-l", "--loaders-count", type=int, default=3)
    parser.add_argument("--read-method", default="python",
                        choices=["python", "arrow"])
    parser.add_argument("--torch-loader", action="store_true",
                        help="measure through make_torch_dataloader onto "
                             "--device (adds input-stall %%)")
    parser.add_argument("--torch-batch-size", type=int, default=128)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the --torch-loader's device (default cuda; "
                             "raises without a card)")
    parser.add_argument("--jax-loader", action="store_const", const=True,
                        default=None, help=argparse.SUPPRESS)
    parser.add_argument("--jax-batch-size", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for jax_flag, torch_flag in _JAX_FLAGS.items():
        if getattr(args, jax_flag.lstrip("-").replace("-", "_")) is not None:
            parser.error(f"{jax_flag} is the JAX package's flag; the "
                         f"port's is {torch_flag}")

    from petastorm_tpu_torch.benchmark.throughput import reader_throughput

    result = reader_throughput(
        args.dataset_url, field_regex=args.field_regex,
        warmup_cycles_count=args.warmup_cycles,
        measure_cycles_count=args.measure_cycles,
        pool_type=args.pool_type, loaders_count=args.loaders_count,
        read_method=args.read_method, apply_torch_loader=args.torch_loader,
        torch_batch_size=args.torch_batch_size, device=args.device)
    stall = (f", input_stall={result.input_stall_pct:.2f}%"
             if result.input_stall_pct is not None else "")
    print(f"{result.rows_per_second:.1f} rows/sec "
          f"({result.rows_count} rows in {result.duration_s:.2f}s{stall})")
    return 0


def _scenario_main(argv):
    import inspect
    import json

    from petastorm_tpu_torch.benchmark.scenarios import SCENARIOS

    parser = argparse.ArgumentParser(
        prog="python -m petastorm_tpu_torch.benchmark scenario",
        description="Run a named benchmark scenario on synthetic data "
                    "(BASELINE.md configs #2-#5, plus the `service` "
                    "loopback data-service tier)")
    parser.add_argument("name", choices=sorted(SCENARIOS))
    parser.add_argument("--dataset-url", default=None,
                        help="reuse an existing dataset instead of "
                             "synthesizing one (weighted: a base url "
                             "holding corpus_<i> datasets with a 'corpus' "
                             "column)")
    parser.add_argument("--workers", type=int, default=3,
                        help="reader pool threads (service: batch-worker "
                             "fleet size)")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="rows per batch (scenarios that batch)")
    parser.add_argument("--sharding", default=None,
                        choices=["static", "fcfs", "dynamic"],
                        help="service scenario sharding mode: static "
                             "per-client splits, fcfs shared queue, or "
                             "dynamic work-stealing piece rebalancing. "
                             "fcfs is single-tenant and single-epoch: no "
                             "per-job assignment (register_job is "
                             "rejected) and no per-client epoch "
                             "boundaries — multi-job / multi-epoch runs "
                             "need static or dynamic "
                             "(docs/guides/service.md#sharding-modes)")
    parser.add_argument("--mode", default=None,
                        choices=["static", "fcfs", "dynamic"],
                        help="legacy alias of --sharding")
    parser.add_argument("--skew-ms", type=float, default=None,
                        help="service scenario fault injection: delay one "
                             "worker this many ms per batch (head-of-line "
                             "demonstration)")
    parser.add_argument("--credits", type=int, default=None,
                        help="service scenario per-worker flow-control "
                             "window (un-acked batches in flight)")
    parser.add_argument("--json-out", default=None,
                        help="also append the result as one JSON line to "
                             "this file (BENCH-style perf trajectory)")
    parser.add_argument("--chaos", default=None,
                        help="service scenario fault harness: "
                             "dispatcher-restart, worker-kill, conn-drop, "
                             "cache-corrupt, job-cancel, worker-drain, "
                             "failpoints (comma-separable; failpoints = "
                             "the seeded in-process fault schedule — see "
                             "--chaos-seed). Checks delivery invariants "
                             "and raises on violation")
    parser.add_argument("--chaos-seed", type=int, default=None,
                        dest="chaos_seed",
                        help="reproducer seed: drives the failpoint "
                             "schedule AND the timed chaos kinds' event "
                             "sequence, so the same seed injects the "
                             "identical fault sequence (the injection "
                             "log lands in the --json-out result)")
    parser.add_argument("--failpoint-points", default=None,
                        dest="failpoint_points",
                        help="comma-separated failpoint names restricting "
                             "the armed --chaos failpoints vocabulary "
                             "(the fuzz shrinker's reproducers use this)")
    parser.add_argument("--failpoint-window", type=int, default=None,
                        dest="failpoint_window",
                        help="fire indices land in [4, window) calls per "
                             "failpoint (default 400); fuzz reproducers "
                             "pin the small window their runs used")
    parser.add_argument("--rows", type=int, default=None,
                        help="service scenario: synthesized dataset rows "
                             "(fuzz reproducers pin the small geometry "
                             "their runs used)")
    parser.add_argument("--days", type=int, default=None,
                        help="service scenario: synthesized dataset day "
                             "chunks = row-group pieces")
    parser.add_argument("--chaos-interval", type=float, default=None,
                        dest="chaos_interval_s",
                        help="seconds between injected chaos events")
    parser.add_argument("--chaos-max-events", type=int, default=None,
                        dest="chaos_max_events",
                        help="stop injecting after this many events "
                             "(default 4; 0 = unbounded)")
    parser.add_argument("--journal-dir", default=None,
                        help="service scenario dispatcher journal "
                             "directory (default under chaos: a tmpdir)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        dest="metrics_port",
                        help="serve the metrics registry in Prometheus "
                             "text format on this port for the run's "
                             "duration (0 picks a free port; address "
                             "lands in the result)")
    parser.add_argument("--trace-out", default=None, dest="trace_out",
                        help="write a Perfetto-loadable Chrome "
                             "trace_event JSON of per-batch lifecycle "
                             "spans (worker decode → client queue → "
                             "device dispatch) to this path")
    parser.add_argument("--epochs", type=int, default=None,
                        help="service scenario: stream the dataset this "
                             "many times (per-epoch rows/s + cache hit "
                             "rate land in the result)")
    parser.add_argument("--cache", default=None,
                        choices=["off", "mem", "mem+disk"],
                        help="service scenario: arm the workers' decoded-"
                             "batch cache so warm epochs skip Parquet + "
                             "decode (docs/guides/caching.md)")
    parser.add_argument("--cache-mem-mb", type=float, default=None,
                        dest="cache_mem_mb",
                        help="per-worker memory-tier budget for --cache")
    parser.add_argument("--cache-dir", default=None, dest="cache_dir",
                        help="shared disk-tier directory for "
                             "--cache mem+disk (default: a scenario-owned "
                             "tempdir)")
    parser.add_argument("--fleet-cache", action="store_true", default=None,
                        dest="fleet_cache",
                        help="service scenario: promote the per-worker "
                             "--cache to the consistent-hash fleet tier — "
                             "warm entries are served from ring peers "
                             "before falling back to a local cold fill "
                             "(docs/guides/caching.md#fleet-cache-tier)")
    parser.add_argument("--fleet-cache-drain-after", type=int, default=None,
                        dest="fleet_cache_drain_after",
                        help="service scenario: drain bench-worker-0 after "
                             "this many consumed batches, exercising the "
                             "warm handoff at a deterministic stream "
                             "position (needs --fleet-cache and >=2 "
                             "workers)")
    parser.add_argument("--shuffle-seed", type=int, default=None,
                        dest="shuffle_seed",
                        help="service scenario: dispatcher-side seed-tree "
                             "deterministic shuffle — piece order derives "
                             "from fold_in(seed, epoch, piece), invariant "
                             "to worker count and steal/failure history "
                             "(docs/guides/service.md#deterministic-order)")
    parser.add_argument("--ordered", action="store_true", default=None,
                        help="service scenario: re-sequence delivery into "
                             "the canonical seed-tree order so the "
                             "delivered stream (and its stream_digest) is "
                             "byte-identical across runs and fleet shapes")
    parser.add_argument("--predicate", default=None,
                        help="service scenario: declared row filter as "
                             "FIELD:OP:VALUE[:MODULUS] (ops eq/ne/lt/le/"
                             "gt/ge/in/not-in/mod-eq, e.g. "
                             "sample_index:mod-eq:0:4 keeps every 4th "
                             "row) — docs/guides/pipeline.md"
                             "#graph-rewrites")
    parser.add_argument("--filter-placement", default=None,
                        dest="filter_placement",
                        choices=["client", "worker"],
                        help="service scenario: where --predicate runs — "
                             "client (mask received batches, baseline) "
                             "or worker (hoisted below decode: dropped "
                             "rows never decode)")
    parser.add_argument("--transport", default=None,
                        choices=["auto", "tcp", "shm"],
                        help="service scenario: delivery tier for both "
                             "ends of the fleet — tcp forces the framed "
                             "sockets, shm/auto negotiate the shared-"
                             "memory ring per stream (docs/guides/"
                             "service.md#transport-tiers). Default: "
                             "PETASTORM_TRANSPORT env var, else auto")
    parser.add_argument("--device-stage", default=None,
                        choices=["on", "off"], dest="device_stage",
                        help="image scenario: run the on-card decode leg — "
                             "raw uint8 staged, cast/normalize on the "
                             "device (--device)")
    parser.add_argument("--device-prefetch", type=int, default=None,
                        dest="device_prefetch",
                        help="batches kept in flight on device by the "
                             "device-stage leg (>=2 = double buffering; "
                             "each costs one batch of device memory)")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="device of the scenario's device leg (image: "
                             "the --device-stage leg; default cuda)")
    args = parser.parse_args(argv)

    scenario = SCENARIOS[args.name]
    kwargs = {"dataset_url": args.dataset_url, "workers": args.workers}
    # Optional knobs forward only to scenarios whose signature takes them
    # (argparse exposes one surface; each scenario keeps its own defaults).
    # Each entry carries the real flag spelling — kwarg names and flags
    # diverge (--chaos-interval ↔ chaos_interval_s), and a rejection
    # message must name a flag that exists.
    accepted = set(inspect.signature(scenario).parameters)
    for name, flag, value in (
            ("batch_size", "--batch-size", args.batch_size),
            ("sharding", "--sharding", args.sharding),
            ("mode", "--mode", args.mode),
            ("skew_ms", "--skew-ms", args.skew_ms),
            ("credits", "--credits", args.credits),
            ("json_out", "--json-out", args.json_out),
            ("chaos", "--chaos", args.chaos),
            ("chaos_interval_s", "--chaos-interval", args.chaos_interval_s),
            ("chaos_max_events", "--chaos-max-events",
             args.chaos_max_events),
            ("chaos_seed", "--chaos-seed", args.chaos_seed),
            ("failpoint_points", "--failpoint-points",
             args.failpoint_points),
            ("failpoint_window", "--failpoint-window",
             args.failpoint_window),
            ("rows", "--rows", args.rows),
            ("days", "--days", args.days),
            ("journal_dir", "--journal-dir", args.journal_dir),
            ("metrics_port", "--metrics-port", args.metrics_port),
            ("trace_out", "--trace-out", args.trace_out),
            ("epochs", "--epochs", args.epochs),
            ("cache", "--cache", args.cache),
            ("cache_mem_mb", "--cache-mem-mb", args.cache_mem_mb),
            ("cache_dir", "--cache-dir", args.cache_dir),
            ("fleet_cache", "--fleet-cache", args.fleet_cache),
            ("fleet_cache_drain_after", "--fleet-cache-drain-after",
             args.fleet_cache_drain_after),
            ("shuffle_seed", "--shuffle-seed", args.shuffle_seed),
            ("ordered", "--ordered", args.ordered),
            ("predicate", "--predicate", args.predicate),
            ("filter_placement", "--filter-placement",
             args.filter_placement),
            ("transport", "--transport", args.transport),
            ("device_stage", "--device-stage", args.device_stage),
            ("device_prefetch", "--device-prefetch",
             args.device_prefetch),
            ("device", "--device", args.device)):
        if value is not None:
            if name not in accepted:
                parser.error(f"{flag} is not a knob of "
                             f"the {args.name!r} scenario")
            kwargs[name] = value
    result = scenario(**kwargs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
