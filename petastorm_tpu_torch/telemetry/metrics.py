"""The metric families the port's modules feed, declared in one place (the
port's own copy of the matching part of ``petastorm_tpu/telemetry/
metrics.py``).

Each family keeps the JAX package's name, help text, labels and buckets,
so a scrape of either package reads the same vocabulary. The framed
transport's, the batch worker's, the dispatcher's and the service
client's families came with the data service's first slice; the
failpoints', quarantine's, the resilience layer's and fleet tracing's with
its control plane; the shared-memory tier's, the columnar counter and the
graph rewrites' with the data plane of one host; the fleet's (jobs, the
autoscaler, the fleet cache tier and its model planner) with the fleet;
the packing stage's and the mixture sampler's with the LLM stages. Naming
follows Prometheus: ``petastorm_<layer>_...``, base units, ``_total`` on
counters; label values are bounded (stage names, tiers, a recycled
per-loader id, a per-controller id), never row- or batch-scoped.
"""

from __future__ import annotations

from petastorm_tpu_torch.telemetry.registry import REGISTRY


# -- reader / worker pools / ventilator (reader/reader.py, workers_pool/) ------

READER_READERS = REGISTRY.counter(
    "petastorm_reader_readers_total",
    "Reader instances constructed in this process")
READER_ROWGROUPS_PLANNED = REGISTRY.gauge(
    "petastorm_reader_rowgroups_planned",
    "Row-group pieces in the most recently constructed reader's plan "
    "(after filters/selector/shard)")
POOL_ITEMS_VENTILATED = REGISTRY.counter(
    "petastorm_pool_items_ventilated_total",
    "Work items handed to reader worker pools (all pools in-process)")
POOL_ITEMS_PROCESSED = REGISTRY.counter(
    "petastorm_pool_items_processed_total",
    "Work items fully processed by reader worker pools")
POOL_RESULTS_QUEUE_DEPTH = REGISTRY.gauge(
    "petastorm_pool_results_queue_depth",
    "Decoded payloads sitting in thread-pool results queues right now, "
    "summed over live pools (pinned at its cap = the consumer can't keep "
    "up; process pools report depth via reader diagnostics only)")
VENTILATOR_ITEMS = REGISTRY.counter(
    "petastorm_ventilator_items_ventilated_total",
    "Items ventilated into pools across all ventilators in-process")
VENTILATOR_EPOCHS = REGISTRY.counter(
    "petastorm_ventilator_epochs_completed_total",
    "Full ventilation epochs completed across all ventilators in-process")

# -- columnar decode (reader/columnar_worker.py) -------------------------------

COLUMNAR_KERNEL_SECONDS = REGISTRY.histogram(
    "petastorm_columnar_kernel_seconds",
    "Per-column vectorized codec decode time inside the columnar reader "
    "worker (one observation per codec column per row-group batch — the "
    "decode_column kernels the row_vs_columnar rewrite bets on)")

# -- loader (torch_utils/loader.py) --------------------------------------------

LOADER_BATCHES = REGISTRY.counter(
    "petastorm_loader_batches_total",
    "Batches yielded to the training loop, per loader instance",
    labels=("loader",))
LOADER_ROWS = REGISTRY.counter(
    "petastorm_loader_rows_total",
    "Rows yielded to the training loop, per loader instance",
    labels=("loader",))
LOADER_STAGE_SECONDS = REGISTRY.histogram(
    "petastorm_loader_stage_seconds",
    "Per-batch time in each loader pipeline stage (decode, queue_wait, "
    "wait, raw_stage, device_decode, shard_put, device_put, consumer) — "
    "the legacy diagnostics stage sums are derived from these series. "
    "raw_stage = staging the raw uint8 bytes batch onto the device(s), "
    "device_decode = the fused on-device decode/augment kernel dispatch, "
    "shard_put = each per-shard device_put inside a sharded delivery "
    "(observed once per target device per batch)",
    labels=("loader", "stage"))
LOADER_DISPATCH_OVERLAP = REGISTRY.gauge(
    "petastorm_loader_dispatch_overlap_pct",
    "Share of the loader's device-dispatch time that rode inside the "
    "producer's decode windows or the consumer's step window instead of "
    "extending the wall ((decode + consumer + dispatch - wall) / "
    "dispatch, clipped to [0, 100]; refreshed on every diagnostics read "
    "and at iteration end) — 100 means H2D staging and on-device decode "
    "are fully hidden behind decode/compute",
    labels=("loader",))

# -- decoded-batch cache (cache_impl/batch_cache.py) ---------------------------

CACHE_HITS = REGISTRY.counter(
    "petastorm_cache_hits_total",
    "Decoded-batch cache lookups served without re-decoding, by tier "
    "(mem = LRU memory tier, disk = spill tier; a disk hit is promoted "
    "into memory)",
    labels=("tier",))
CACHE_MISSES = REGISTRY.counter(
    "petastorm_cache_misses_total",
    "Decoded-batch cache lookups absent from every tier (the key's pieces "
    "were decoded and the entry filled)")
CACHE_BYTES = REGISTRY.gauge(
    "petastorm_cache_bytes",
    "Bytes resident in the decoded-batch cache right now, by tier "
    "(summed over every cache instance in the process)",
    labels=("tier",))
CACHE_ENTRIES = REGISTRY.gauge(
    "petastorm_cache_entries",
    "Entries resident in the decoded-batch cache right now, by tier",
    labels=("tier",))
CACHE_EVICTIONS = REGISTRY.counter(
    "petastorm_cache_evictions_total",
    "Entries evicted from a decoded-batch cache tier to honor its size "
    "budget (mem evictions are harmless when the disk tier holds the "
    "entry — fills write through)",
    labels=("tier",))
CACHE_FILL_SECONDS = REGISTRY.histogram(
    "petastorm_cache_fill_seconds",
    "Per-entry time to serialize, pack, and store a decoded-batch cache "
    "entry (decode time excluded — that is the cost caching removes)")
CACHE_SERVE_SECONDS = REGISTRY.histogram(
    "petastorm_cache_serve_seconds",
    "Per-hit time to fetch a decoded-batch cache entry (memory hits are "
    "~free; disk hits pay one contiguous file read)")
CACHE_CORRUPT = REGISTRY.counter(
    "petastorm_cache_corrupt_entries_total",
    "Disk-tier entry files that failed validation on load (bad magic, "
    "torn length, or checksum mismatch from a truncated/bit-flipped "
    "file). Each one is deleted and treated as a miss — the worker "
    "degrades to a fresh decode, never serves corrupt bytes, never "
    "errors the stream")
CACHE_PERMUTED_SERVES = REGISTRY.counter(
    "petastorm_cache_permuted_serves_total",
    "Cache entries served through a seed-tree serve-time permutation "
    "(shuffle-compatible serving: canonical cached bytes, per-epoch "
    "order), by the tier the entry was fetched from (mem/disk)",
    labels=("tier",))
CACHE_VERSION_EVICTED = REGISTRY.counter(
    "petastorm_cache_version_evicted_total",
    "Disk-tier entry files written by an older cache format version, "
    "detected on load, deleted, and treated as a miss (fresh decode "
    "refills them in the current format — a format bump never errors a "
    "stream)")
CACHE_DISK_WRITE_ERRORS = REGISTRY.counter(
    "petastorm_cache_disk_write_errors_total",
    "Disk-tier entry writes that failed with an OSError (ENOSPC, vanished "
    "directory, fd exhaustion) and were skipped: the cache degrades to "
    "pass-through for that entry — the batch still streams, it just is "
    "not persisted (docs/guides/service.md#failure-model-and-recovery)")

# -- pipeline autotuner (pipeline/autotune.py) -------------------------------

AUTOTUNE_DECISIONS = REGISTRY.counter(
    "petastorm_autotune_decisions_total",
    "Knob changes the online autotuner applied, by knob and direction "
    "(up/down = a capacity knob raised/lowered one hill-climb step, flip = "
    "a placement knob moved, revert = a probe that regressed throughput "
    "was rolled back). The decision journal: every entry here also lands "
    "in the controller's in-memory trail with before/after values",
    labels=("knob", "direction"))
AUTOTUNE_KNOB_VALUE = REGISTRY.gauge(
    "petastorm_autotune_knob_value",
    "Current value of each autotuned pipeline knob (workers_count, "
    "host_prefetch, device_prefetch, credits, ready_queue_depth; "
    "transform_placement renders 0 = remote, 1 = local) — set when the "
    "controller binds the knob and on every applied decision, so a scrape "
    "shows the configuration actually in force, not the constructed one. "
    "Labeled per controller instance (two concurrently autotuned loaders "
    "must not clobber each other's gauges); a garbage-collected "
    "controller's series are removed",
    labels=("controller", "knob"))
AUTOTUNE_ROUNDS = REGISTRY.counter(
    "petastorm_autotune_rounds_total",
    "Autotuner planning rounds by outcome: applied (a knob changed), "
    "reverted (a regressing probe rolled back), noop (balanced, "
    "hysteresis-held, or all candidate knobs settled), idle (window too "
    "short or no rows moved). A converged pipeline shows only noop/idle "
    "growth",
    labels=("outcome",))

# -- graph rewrites (pipeline/rewrites.py) -----------------------------------

REWRITE_DECISIONS = REGISTRY.counter(
    "petastorm_rewrite_decisions_total",
    "Graph rewrites the autotuner applied or reverted, by rewrite kind "
    "(fuse_worker_stages / hoist_filter / cache_placement — the catalog in "
    "docs/guides/pipeline.md#graph-rewrites) and direction (flip = applied "
    "or moved, revert = a probe that regressed throughput rolled the "
    "topology back). A subset of petastorm_autotune_decisions_total: every "
    "rewrite decision counts in both",
    labels=("rewrite", "direction"))
REWRITE_ACTIVE = REGISTRY.gauge(
    "petastorm_rewrite_active",
    "Whether each graph rewrite is currently in force (1) or at its "
    "baseline topology (0): stage fusion fused, the row filter hoisted "
    "worker-side, the cache insertion point moved post-decode. Set by the "
    "autotune controller on every applied/reverted rewrite decision; "
    "labeled per controller instance like the knob-value gauge (two "
    "autotuned loaders must not clobber each other's topology reading — "
    "a collected controller's series are removed)",
    labels=("controller", "rewrite"))

# -- flight recorder (telemetry/flight.py) -------------------------------------

FLIGHT_EVENTS = REGISTRY.counter(
    "petastorm_flight_events_total",
    "Structured events noted into this process's flight-recorder ring "
    "(always on, bounded; the ring holds only the most recent ones — "
    "this counter is the lifetime total)")
FLIGHT_DUMPS = REGISTRY.counter(
    "petastorm_flight_dumps_total",
    "Flight-recorder rings dumped to disk, by reason (invariant "
    "violation, thread-crash, sigusr2, fuzz failure attachment; "
    "write_failed counts dumps that could not be persisted). Nonzero "
    "outside a chaos run means a real incident left a postmortem file",
    labels=("reason",))

# -- transport (reader_impl/framed_socket.py) ------------------------------

TRANSPORT_MESSAGES = REGISTRY.counter(
    "petastorm_transport_messages_total",
    "Framed messages moved by the data-plane transports, by direction "
    "(sent/recv) and transport tier (tcp = stream sockets, shm = the "
    "shared-memory ring for colocated peers)",
    labels=("direction", "transport"))
TRANSPORT_FRAMES = REGISTRY.counter(
    "petastorm_transport_frames_total",
    "Payload frames inside framed messages, by direction and transport "
    "tier (a wide numpy batch is dozens of frames per message)",
    labels=("direction", "transport"))
TRANSPORT_BYTES = REGISTRY.counter(
    "petastorm_transport_bytes_total",
    "Bytes moved by the framed transports, by direction and transport "
    "tier (header + framing prefixes + payload frames; shm counts bytes "
    "made visible through the ring, including pool-mapped frame bytes "
    "that were never copied)",
    labels=("direction", "transport"))
TRANSPORT_SYSCALLS = REGISTRY.counter(
    "petastorm_transport_syscalls_total",
    "Send-path kernel crossings per transport tier (tcp = sendmsg calls "
    "incl. short-write resumes; shm = eventfd doorbell writes + bounded "
    "waits on the ring). Divide a delta by the matching sent-messages "
    "delta for syscalls-per-message — the number the shm tier drives "
    "toward zero (bench.py shm_transport leg)",
    labels=("transport",))

TRANSPORT_DOWNGRADES = REGISTRY.counter(
    "petastorm_transport_downgrades_total",
    "Stream negotiations that advertised the shm tier but completed over "
    "TCP, by reason (arena_setup = the worker could not create/pre-fault "
    "the memfd arena — memfd unavailable or shm exhaustion; client_nack "
    "= the client could not attach the offered arena, e.g. a container "
    "boundary between colocated-looking peers). The stream itself "
    "proceeds on TCP with its credit window intact",
    labels=("reason",))

# -- shared-memory ring tier (service/shm_ring.py) ---------------------------

SHM_FRAMES = REGISTRY.counter(
    "petastorm_shm_frames_total",
    "Payload frames delivered through a shared-memory ring, by path "
    "(mapped = the frame already lived in the shared frame pool — a warm "
    "cache hit served as offsets, zero copy; copied = frame bytes "
    "memcpy'd inline into the ring; spilled = the message exceeded the "
    "ring's capacity and rode the fallback TCP socket behind an in-ring "
    "ordering marker). mapped / (mapped + copied + spilled) is the warm "
    "mapped-serve ratio",
    labels=("path",))
SHM_ARENAS = REGISTRY.gauge(
    "petastorm_shm_arenas",
    "Live shared-memory mappings in this process, by kind (ring = "
    "per-stream doorbell'd rings, producer and consumer ends each count "
    "one; pool = worker-global frame pools backing mapped cache serves). "
    "Nonzero after every stream and worker is closed means a leaked "
    "arena — the conftest leak guard fails the test",
    labels=("kind",))

# -- service: batch worker (service/worker.py) -----------------------------

WORKER_BATCHES_SENT = REGISTRY.counter(
    "petastorm_service_worker_batches_sent_total",
    "Collated batches streamed to clients, per worker",
    labels=("worker",))
WORKER_ROWS_SENT = REGISTRY.counter(
    "petastorm_service_worker_rows_sent_total",
    "Rows streamed to clients, per worker",
    labels=("worker",))
WORKER_CREDIT_WAIT = REGISTRY.counter(
    "petastorm_service_worker_credit_wait_seconds_total",
    "Seconds a worker's stream loop spent blocked waiting for credit "
    "replenishment (high = the trainer is the bottleneck, flow control is "
    "holding workers back as designed)",
    labels=("worker",))
WORKER_STREAMS = REGISTRY.counter(
    "petastorm_service_worker_streams_total",
    "Stream requests finished, per worker and outcome "
    "(completed/error/disconnected/aborted — aborted = the worker "
    "stopped mid-stream without sending `end`)",
    labels=("worker", "outcome"))
WORKER_ACTIVE_STREAMS = REGISTRY.gauge(
    "petastorm_service_worker_active_streams",
    "Streams a worker is serving right now",
    labels=("worker",))
WORKER_DECODE_SECONDS = REGISTRY.histogram(
    "petastorm_service_worker_decode_seconds",
    "Per-batch read+collate time inside a worker's stream loop (the time "
    "to pull the next batch from its reader pipeline)",
    labels=("worker",))
WORKER_READERS_CONSTRUCTED = REGISTRY.counter(
    "petastorm_service_worker_readers_constructed_total",
    "Reader pipelines this worker built (dataset enumeration + decode-pool "
    "spinup each). Streams served through the streaming piece engine cost "
    "ONE construction per stream regardless of piece count; the per-piece "
    "fallback (process pools) pays one per missed piece",
    labels=("worker",))
WORKER_TRANSFORM_SECONDS = REGISTRY.histogram(
    "petastorm_service_worker_transform_seconds",
    "Per-batch time in the worker-side batch transform stage (the "
    "placement-flippable collated-batch transform, applied when the "
    "stream's transform_placement is remote — docs/guides/pipeline.md)",
    labels=("worker",))

COLUMNAR_BATCHES = REGISTRY.counter(
    "petastorm_columnar_batches_total",
    "Batches served through the columnar decode path, per worker and path "
    "(columnar = vectorized per-column codec kernels decoded the batch; "
    "row_fallback = a stream requested reader_family='columnar' but this "
    "worker degraded it to the per-row path — bytes identical, speedup "
    "lost). columnar / (columnar + row_fallback) is the COL%% column of "
    "`service status --watch`",
    labels=("worker", "path"))

# -- fused worker stages (stage-fusion rewrite) ------------------------------

WORKER_HANDOFF_SECONDS = REGISTRY.counter(
    "petastorm_service_worker_handoff_seconds_total",
    "Seconds the stream-serving thread spent on per-output hand-off work "
    "(collation of pool outputs into batches + wire serialization) — the "
    "overhead the stage-fusion rewrite moves into the pool task. High "
    "relative to decode seconds is the fusion trigger "
    "(docs/guides/pipeline.md#graph-rewrites); near zero while fused",
    labels=("worker",))
WORKER_FUSED_STAGE_SECONDS = REGISTRY.counter(
    "petastorm_service_worker_fused_stage_seconds_total",
    "Seconds spent inside the FUSED pool task, attributed per constituent "
    "stage — stage fusion collapses the stages into one task but their "
    "costs stay separately attributable here, feeding the same graph "
    "nodes the unfused stages would. Labels: collate (includes the "
    "packing wrapper's work when worker-placed packing is fused; the "
    "petastorm_packing_* families stay the precise packing measurement) "
    "and serialize; the transform keeps its own worker_transform_seconds "
    "family",
    labels=("stage",))

# -- service: dispatcher (service/dispatcher.py) ---------------------------

DISPATCHER_REQUESTS = REGISTRY.counter(
    "petastorm_service_dispatcher_requests_total",
    "Control-plane requests handled, by request type",
    labels=("type",))
DISPATCHER_FENCING_EPOCH = REGISTRY.gauge(
    "petastorm_service_dispatcher_fencing_epoch",
    "Current fencing epoch (bumps invalidate outstanding assignments)")
DISPATCHER_WORKERS = REGISTRY.gauge(
    "petastorm_service_dispatcher_workers",
    "Registered workers by liveness state (alive/dead)",
    labels=("state",))
DISPATCHER_RECOVERY_EVENTS = REGISTRY.gauge(
    "petastorm_service_dispatcher_recovery_events",
    "Dispatcher recovery counters (journal_replays, evictions, "
    "failures_reported, re_registrations, fencing_bumps, "
    "stale_fencing_rejections). A gauge, not a counter: the values are "
    "journaled and restored across restarts, so they can jump on replay",
    labels=("event",))
DISPATCHER_STEALS = REGISTRY.gauge(
    "petastorm_service_dispatcher_steals",
    "Dynamic-mode piece moves per worker and direction (out = pieces "
    "stolen away from this worker's deque, in = pieces granted to it); "
    "dead-worker takeover reassignments count too. A gauge like the "
    "recovery events: journaled, so it can jump on replay",
    labels=("worker", "direction"))
DISPATCHER_BACKLOG_PIECES = REGISTRY.gauge(
    "petastorm_service_dispatcher_backlog_pieces",
    "Dynamic-mode pieces currently booked to each worker and not yet "
    "reported done (summed over clients) — the backlog the work-stealing "
    "planner balances",
    labels=("worker",))
DISPATCHER_GENERATION = REGISTRY.gauge(
    "petastorm_service_dispatcher_generation",
    "Dynamic-mode ownership-generation high-water mark: every assignment, "
    "steal, and takeover stamps moved pieces with a fresh generation, and "
    "clients drop batches tagged with a superseded (piece, generation) — "
    "the fencing that makes a stolen piece count exactly once")

# -- service: trainer client (service/client.py) ---------------------------

CLIENT_BATCHES = REGISTRY.counter(
    "petastorm_service_client_batches_total",
    "Remote batches consumed by this trainer, per source worker",
    labels=("worker",))
CLIENT_RECV_STALL = REGISTRY.counter(
    "petastorm_service_client_recv_stall_seconds_total",
    "Seconds a client stream-reader thread spent blocked waiting on its "
    "worker (a skewed worker shows up here, not in delivery latency)",
    labels=("worker",))
CLIENT_READY_QUEUE_DEPTH = REGISTRY.gauge(
    "petastorm_service_client_ready_queue_depth",
    "Batches waiting in the multiplexed drain's shared ready-queue "
    "(sampled as the consumer dequeues)")
CLIENT_RECOVERY_EVENTS = REGISTRY.counter(
    "petastorm_service_client_recovery_events_total",
    "Client-observed recovery events (resyncs, resync_failures, "
    "streams_retired, takeovers, stale_fencing_retries, "
    "heartbeat_failures)",
    labels=("event",))
CLIENT_DEDUP_DROPPED = REGISTRY.counter(
    "petastorm_service_client_dedup_dropped_total",
    "Batches the client received but refused to yield because delivery "
    "bookkeeping proved them duplicates, by path: steal = a stale "
    "ownership generation (a superseded dynamic-mode grant), takeover = a "
    "sub-watermark ordinal (a re-served piece repeating batches already "
    "handed to the consumer). Zero on healthy exactly-once paths — the "
    "worker-side watermark skip means re-serves start past what was "
    "delivered; a nonzero takeover count is the safety net firing",
    labels=("path",))
CLIENT_WATERMARK_LAG = REGISTRY.gauge(
    "petastorm_service_client_watermark_lag",
    "Batches received from workers but not yet yielded past the "
    "deterministic delivery cursor (the ordered-mode reorder buffer depth; "
    "0 when ordered delivery is off). Persistent growth = the next piece "
    "in the seed-tree order is stuck behind a slow or recovering worker "
    "while its peers run ahead")
CLIENT_TRANSFORM_SECONDS = REGISTRY.histogram(
    "petastorm_service_client_transform_seconds",
    "Per-batch time in the trainer-local batch transform stage (the same "
    "placement-flippable transform executed client-side when "
    "transform_placement is local — high values here with low consumer "
    "stall say the trainer host can afford the stage; the autotuner flips "
    "placement back when it cannot)")

# -- client-side row filter (filter-hoisting rewrite baseline) ---------------

CLIENT_FILTER_ROWS = REGISTRY.counter(
    "petastorm_service_client_filter_rows_total",
    "Rows entering (outcome=in) and surviving (outcome=kept) the "
    "trainer-local row filter (ServiceBatchSource(predicate=...) with "
    "filter_placement='client'). The kept/in ratio is the measured "
    "selectivity the filter-hoisting rewrite triggers on: a low ratio "
    "means most decoded bytes are dropped after the fact, and hoisting "
    "the predicate below the workers' decode stops paying for them",
    labels=("outcome",))

# -- failpoints and quarantine (failpoints.py, service/*) --------------------

FAILPOINT_FIRES = REGISTRY.counter(
    "petastorm_failpoint_fires_total",
    "Deterministic fault injections fired by the armed FaultSchedule, by "
    "failpoint name and action (reset/torn/delay/enospc/oserror/partial/"
    "drop/torn_rename/poison/detach/stale). Zero — and zero overhead "
    "beyond one branch-on-None per site — when no schedule is armed",
    labels=("point", "action"))
FAILPOINT_ARMED = REGISTRY.gauge(
    "petastorm_failpoint_armed",
    "1 while a FaultSchedule is armed process-wide (failpoints compiled "
    "into the hot-path I/O boundaries are live), else 0. A nonzero value "
    "outside a chaos/fuzz run means a schedule leaked past its context")
QUARANTINE_REPORTS = REGISTRY.counter(
    "petastorm_quarantine_reports_total",
    "Poison-piece quarantine events, by the site that observed them "
    "(worker = engine detected an undecodable/poisoned piece and sent "
    "piece_failed; client = the drain recorded it and kept streaming; "
    "dispatcher = the report was journaled and the piece excluded from "
    "re-grant)",
    labels=("site",))
QUARANTINE_PIECES = REGISTRY.gauge(
    "petastorm_quarantine_pieces",
    "Pieces currently quarantined in the dispatcher's (journaled) "
    "quarantine set — excluded from every future assignment, plan, "
    "takeover re-partition, and fcfs split until the journal is reset")

# -- the resilience layer: deadlines, retry budgets, breakers, hedging and
#    brownout (service/resilience.py and its dispatcher / worker / client wiring)

RESILIENCE_DEADLINE_EXCEEDED = REGISTRY.counter(
    "petastorm_resilience_deadline_exceeded_total",
    "Requests a handler refused (retryable DEADLINE_EXCEEDED) because the "
    "caller's propagated budget (the deadline_left_s header field, stamped "
    "from retry_with_backoff's remaining deadline) had already expired — "
    "work nobody would wait for, shed before it started. By handler site "
    "(dispatcher.<request type> or worker.<request kind>)",
    labels=("site",))
RESILIENCE_RETRY_BUDGET = REGISTRY.gauge(
    "petastorm_resilience_retry_budget",
    "Remaining tokens in the client's per-peer retry budget (token bucket: "
    "each retry spends one, each success refills a fraction). Zero means "
    "retries against that peer are exhausted and failures route straight "
    "to takeover instead of feeding a retry storm",
    labels=("peer",))
RESILIENCE_BREAKER_STATE = REGISTRY.gauge(
    "petastorm_resilience_breaker_state",
    "Client-side circuit breaker state per peer worker: 0 closed (healthy), "
    "1 open (failing fast — consecutive-failure threshold tripped, peer "
    "routed around and reported to the dispatcher), 2 half-open (one probe "
    "in flight after the cooldown)",
    labels=("peer",))
RESILIENCE_HEDGES = REGISTRY.counter(
    "petastorm_resilience_hedges_total",
    "Hedged watermark re-serves, by outcome: launched (a stream's "
    "inter-batch gap crossed the histogram-fit threshold and a re-grant of "
    "the in-flight piece was opened at its watermark on a peer), won (the "
    "hedge finished the piece first; the slow original was cancelled), "
    "lost (the original finished first; the hedge was cancelled). "
    "Duplicates from the losing side are dropped by the ordinary "
    "(piece, generation) + watermark dedup, so every outcome is "
    "digest-invariant",
    labels=("outcome",))
FLEET_BROWNOUT_LEVEL = REGISTRY.gauge(
    "petastorm_fleet_brownout_level",
    "The dispatcher's journaled brownout level: 0 normal, 1 shedding "
    "low-weight/sideband jobs' credit windows (fleet.credit_scales with "
    "the brownout factor applied), 2 also shedding optional stages "
    "(tracing spans, autotune probes). Entered under sustained overload "
    "(credit-wait + ready-queue-saturation streaks), recovered "
    "symmetrically — every transition is a WAL op")

# -- the fleet: multi-tenant jobs and the autoscaler (service/fleet.py and its
#    dispatcher / worker wiring) ---------------------------------------------

FLEET_WORKERS = REGISTRY.gauge(
    "petastorm_fleet_workers",
    "Live workers by lifecycle state (serving/standby/draining): serving "
    "workers receive grants, standby workers are pooled capacity awaiting "
    "autoscaler admission, draining workers finish their granted work and "
    "retire back to standby",
    labels=("state",))
FLEET_JOBS = REGISTRY.gauge(
    "petastorm_fleet_jobs",
    "Jobs the dispatcher currently tracks (register_job/end_job plus the "
    "implicit default job once touched)")
FLEET_AUTOSCALE_DECISIONS = REGISTRY.counter(
    "petastorm_fleet_autoscale_decisions_total",
    "Fleet autoscale decisions applied (and journaled), by action "
    "(admit/drain/retire)",
    labels=("action",))
FLEET_JOB_FENCING_EPOCH = REGISTRY.gauge(
    "petastorm_fleet_job_fencing_epoch",
    "Per-job scoped fencing epoch (the fleet-wide base plus the job's "
    "private offset): fleet-wide events move every job's epoch, a job's "
    "own restart moves only its own — one job's chaos never fences "
    "another's streams",
    labels=("job",))
FLEET_JOB_FAIR_SHARE = REGISTRY.gauge(
    "petastorm_fleet_job_fair_share",
    "Each job's weighted max-min fair share of serving-worker capacity "
    "(fleet.plan_fair_shares over the jobs' weights/quotas and live "
    "backlog) — the allocation credit scaling enforces",
    labels=("job",))
FLEET_JOB_BACKLOG = REGISTRY.gauge(
    "petastorm_fleet_job_backlog_pieces",
    "Dynamic-mode pieces booked to each JOB and not yet done (summed over "
    "its clients) — the per-tenant view of the dispatcher backlog gauge",
    labels=("job",))
FLEET_JOB_ROWS = REGISTRY.counter(
    "petastorm_fleet_job_rows_total",
    "Rows streamed to each job's clients (worker-side attribution from "
    "the stream request's job_id) — two scrapes give per-job delivery "
    "rates, the fairness measurement",
    labels=("job",))
FLEET_JOB_CACHE_LOOKUPS = REGISTRY.counter(
    "petastorm_fleet_job_cache_lookups_total",
    "Decoded-batch cache lookups attributed to each job, by outcome "
    "(hit/miss) — N jobs sharing one cache tier decode once, and this is "
    "how the sharing is measured (a job whose every lookup hits paid "
    "zero decode)",
    labels=("job", "outcome"))

# -- fleet cache tier: consistent-hash peers + warm handoff
# (cache_impl/fleet_tier.py, cache_impl/hash_ring.py) ------------------------

CACHE_PEER_FETCHES = REGISTRY.counter(
    "petastorm_cache_peer_fetches_total",
    "Remote cache-peer fetches attempted by this worker's fleet tier, by "
    "outcome: hit = the ring owner served the warm entry (promoted into "
    "the local memory tier, zero re-decode), miss = the owner had no "
    "entry (a genuine fleet-wide cold key), error = dial/protocol "
    "failure (fed to the per-peer breaker), breaker_open = the fetch was "
    "skipped without dialing because the owner's breaker is open — all "
    "non-hit outcomes degrade to a local fill, never a stream error",
    labels=("outcome",))
CACHE_PEER_SERVES = REGISTRY.counter(
    "petastorm_cache_peer_serves_total",
    "cache_fetch requests this worker answered FOR its peers, by outcome "
    "(hit/miss) — the serving-side mirror of the fetches counter; a "
    "fleet-wide scrape balances the two",
    labels=("outcome",))
CACHE_PEER_PUSHES = REGISTRY.counter(
    "petastorm_cache_peer_pushes_total",
    "Write-through placement pushes of freshly-filled entries to their "
    "ring owner, by outcome (sent/error/dropped — dropped = the bounded "
    "push queue was full; placement is best-effort, the remote-fetch "
    "path covers the gap)",
    labels=("outcome",))
CACHE_PEER_HANDOFF_ENTRIES = REGISTRY.counter(
    "petastorm_cache_peer_handoff_entries_total",
    "Warm entries moved by drain handoff, by direction (sent = shipped "
    "off a draining worker, received = adopted from one) — a drain with "
    "handoff enabled re-homes its memory tier so the fleet re-decodes "
    "nothing",
    labels=("direction",))

# -- model-based fleet planner (service/fleet_model.py) ----------------------

FLEET_MODEL_PREDICTED_ROWS = REGISTRY.gauge(
    "petastorm_fleet_model_predicted_rows_per_s",
    "The fitted throughput model's predicted fleet rows/s at the planner-"
    "chosen serving-worker count (min(n * per_worker_rate, ceiling)) — "
    "compare with the measured delivery rate to read the model's error "
    "live")
FLEET_MODEL_WHATIF_ERROR = REGISTRY.gauge(
    "petastorm_fleet_model_whatif_error_pct",
    "Median relative error (percent) of the model's what-if replay over "
    "the recorded (serving count, rows/s) sample history — decisions are "
    "gated on this staying under the tolerance, so a persistently high "
    "value means the planner is holding, not scaling")
FLEET_MODEL_DECISIONS = REGISTRY.counter(
    "petastorm_fleet_model_decisions_total",
    "Decisions the model-based planner issued (and journaled as "
    "fleet_plan records), by action (admit/drain/retire, plus "
    "probe-revert drains) — the journaled mirror of the generic "
    "autoscale decisions counter",
    labels=("action",))

# -- sequence packing + mixture sampling (service/packing_stage.py,
#    service/mixture.py) -------------------------------------------------------

PACKING_BATCHES = REGISTRY.counter(
    "petastorm_packing_batches_total",
    "Dense [slots, slot_len] batches emitted by the sequence-packing "
    "stage, by placement (worker = packed pre-serialization inside the "
    "streaming engine; trainer = packed client-side)",
    labels=("placement",))
PACKING_SEQUENCES = REGISTRY.counter(
    "petastorm_packing_sequences_total",
    "Variable-length sequences placed by the packing stage, by placement",
    labels=("placement",))
PACKING_TOKENS = REGISTRY.counter(
    "petastorm_packing_tokens_total",
    "Real (non-padding) tokens placed by the packing stage, by placement",
    labels=("placement",))
PACKING_SECONDS = REGISTRY.histogram(
    "petastorm_packing_seconds",
    "Per-row packing cost (first-fit placement + copy), by placement",
    labels=("placement",))
PACKING_FILL_RATIO = REGISTRY.gauge(
    "petastorm_packing_fill_ratio",
    "Real-token fraction of the most recently emitted packed batch's "
    "slots x slot_len capacity, by placement (1 - fill = padding waste; "
    "compare against last_batch='pad' in the llm_packing bench leg)",
    labels=("placement",))
MIXTURE_DRAWS = REGISTRY.counter(
    "petastorm_mixture_draws_total",
    "Mixture-sampler draws that yielded a batch, by corpus (the served "
    "mix; compare ratios against the configured weights)",
    labels=("corpus",))
MIXTURE_EXHAUSTED = REGISTRY.counter(
    "petastorm_mixture_exhausted_total",
    "Corpus-exhaustion events observed by the mixture sampler (the "
    "exhaustion policy — stop/exhaust/reweight — decides what happens "
    "next), by corpus",
    labels=("corpus",))
MIXTURE_WEIGHT = REGISTRY.gauge(
    "petastorm_mixture_weight",
    "The mixture weight currently in force per corpus (moves on "
    "set_mixture_weights reloads and reweight-policy exhaustions)",
    labels=("corpus",))
MIXTURE_WEIGHT_RELOADS = REGISTRY.counter(
    "petastorm_mixture_weight_reloads_total",
    "Weight-change events applied by mixture samplers in this process "
    "(journaled set_mixture_weights entries + reweight-policy "
    "exhaustions)")

# -- fleet tracing: trace shipping and clock alignment (telemetry/tracing.py,
#    telemetry/clockalign.py) -------------------------------------------------

TRACE_SHIP_EVENTS = REGISTRY.counter(
    "petastorm_trace_ship_events_total",
    "Trace events moved by the fleet trace-assembly protocol, by "
    "direction (push = a peer shipped its span ring to the dispatcher "
    "on a heartbeat tick; collect = events handed to a `trace collect` "
    "caller, the dispatcher's own ring included)",
    labels=("direction",))
CLOCK_OFFSET_US = REGISTRY.gauge(
    "petastorm_clock_offset_us",
    "Each peer's estimated clock offset against the dispatcher's trace "
    "timebase (NTP-style midpoint over heartbeat RTTs, median of the "
    "lowest-RTT samples; microseconds, applied to the peer's events at "
    "fleet-trace merge). Error bound is ±min-RTT/2 — see "
    "docs/guides/diagnostics.md#clock-alignment",
    labels=("peer",))
