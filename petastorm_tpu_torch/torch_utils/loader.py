"""``make_torch_dataloader`` / ``TorchDataLoader``: reader batches → the card,
prefetched and overlapped.

Counterpart of ``petastorm_tpu/jax_utils/loader.py`` (``make_jax_dataloader``
and ``JaxDataLoader``) on one device: a producer thread pulls host batches
from a ``batch_source`` — a reader's fixed-size row batches
(:func:`make_torch_dataloader` over :mod:`.batcher`: last-batch policy, a
seeded shuffle buffer), the packer of :mod:`.packing` or the data service's
:class:`~petastorm_tpu_torch.service.ServiceBatchSource` — into a bounded
queue, and the consuming thread keeps ``device_prefetch`` batches in flight
on the card. A source whose iterator says it is ``prefetched`` (the
service's multiplexed drain: its own reader threads feeding a bounded
ready-queue) is pulled directly by the consuming thread, as the JAX loader
does: a producer thread would only move batches between two bounded
queues.

Staging (the counterpart of ``jax.device_put``) for a CUDA device:

- the producer copies each numeric column into pinned host memory; columns
  of strings, Decimals or ragged rows follow ``non_tensor_policy`` (kept on
  the host as numpy, dropped, or an error);
- the H2D copies are issued ``non_blocking`` on a dedicated copy stream;
  with a :class:`~.device_stage.DeviceStage` the image fields are staged as
  raw uint8 bytes and the stage's crop / flip / cast / normalize run on
  that stream too, after which the raw tensors are dropped at once;
- an event recorded on the copy stream after all of that is what the
  consumer's stream waits on when a batch is handed out, and every tensor
  is ``record_stream``-ed onto it then, on the consuming thread (the
  current stream is a per-thread setting), so the caching allocator cannot
  reuse a buffer while the copy or the step still reads it.

Staging runs on the consuming thread, or with ``stage_in_producer=True``
on a staging thread between the producer and a device queue bounded by
``device_prefetch``, so decode and H2D dispatch overlap. The device stage's
draws are keyed by the production ordinal of each batch, assigned on
whichever thread stages, so the data are the same either way.

The decoded-batch cache (``batch_cache``, :mod:`petastorm_tpu_torch.
cache_impl`) sits in front of the reader: the first pass fills one entry
for the epoch, every later pass replays it without touching the reader, in
the fill's order or, when shuffling is asked for, through a fresh seed-tree
permutation of its batches per pass (``cache_resume`` re-enters such a pass
at a batch position).

``diagnostics`` reports the keys of the JAX loader's unsharded path,
derived from this loader's children of the registry's ``LOADER_*``
families (labelled by a process-unique loader id, recycled when the loader
is collected), and :meth:`TorchDataLoader.stage_quantiles` estimates each
stage's per-batch latency quantiles from them; ``trace_path`` writes each
iteration's per-batch spans as Chrome trace JSON
(:mod:`petastorm_tpu_torch.telemetry.tracing`, the JAX span names), and
every stage is one :func:`~petastorm_tpu_torch.telemetry.tracing.span`,
which a running ``torch.profiler`` also sees as
``petastorm_tpu_torch.loader.<stage>``. Threads are joined by :meth:`stop`
and on ``__exit__``.

:meth:`TorchDataLoader.state_dict` checkpoints the input at what the loader
has *yielded*: the reader's state rolled back past the rows still buffered
in the batcher, the host queue and the device prefetch, so they are re-read
on resume; in a permuted cache pass, the pass and its yielded batches; with
a batch source that checkpoints itself (the data service's), that source's
``state_dict(yielded_batches=...)``. Under a ``torch.distributed`` group,
:func:`make_torch_dataloader` derives the equal-step ``max_batches`` from
the reader's shard metadata, as the JAX loader does under a sharding.
(Global arrays are not ported; in the data-parallel layout each rank keeps
its own local batch on its own card.)

``autotune=`` arms the online autotuner (:mod:`petastorm_tpu_torch.
pipeline`): at the first iteration the loader is described as a stage graph
and a controller thread re-plans ``workers_count`` (a thread-pool reader),
``host_prefetch`` and ``device_prefetch`` from windowed stage profiles. The
stage timers are host clocks: on a CUDA device the dispatch stages time the
enqueue of the copies, so a dispatch-bound class means host-side staging
cost, and a step that does not synchronise shows in ``consumer_s``.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
import warnings
import weakref

import numpy as np
import torch

from petastorm_tpu_torch.ops.flash_attention import resolve_device
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.metrics import (
    LOADER_BATCHES,
    LOADER_DISPATCH_OVERLAP,
    LOADER_ROWS,
    LOADER_STAGE_SECONDS,
)
from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY, batch_iterator
from petastorm_tpu_torch.utils import resize_bounded_queue

_SENTINEL = object()

#: The pipeline stages the ``loader_stage_seconds`` histogram is labelled
#: by, the JAX loader's: ``decode`` (reader pull or cache serve, collation,
#: pinning), ``queue_wait`` (the producer blocked on a full queue), ``wait``
#: (the consumer blocked on input: the stall), ``raw_stage`` (the raw image
#: bytes' copy), ``device_decode`` (the device stage's ops), ``shard_put``
#: (never observed here: no sharded delivery), ``device_put`` (the plain
#: tensors' copies), ``consumer`` (the training step between yields).
_STAGES = ("decode", "queue_wait", "wait", "raw_stage", "device_decode",
           "shard_put", "device_put", "consumer")

#: The device-dispatch stages (``device_dispatch_s``, the overlap gauge).
_DISPATCH_STAGES = ("raw_stage", "device_decode", "device_put")

#: Loader ids, the ``loader`` label: recycled when a loader is collected
#: (``weakref.finalize``), so live series track live loaders.
_LOADER_IDS = itertools.count()
_LOADER_ID_POOL = []


def _acquire_loader_id():
    try:
        return _LOADER_ID_POOL.pop()
    except IndexError:
        return str(next(_LOADER_IDS))


def _release_loader_metrics(loader_id):
    """weakref.finalize callback: retire a collected loader's series."""
    LOADER_BATCHES.remove(loader_id)
    LOADER_ROWS.remove(loader_id)
    LOADER_DISPATCH_OVERLAP.remove(loader_id)
    for stage in _STAGES:
        LOADER_STAGE_SECONDS.remove(loader_id, stage)
    _LOADER_ID_POOL.append(loader_id)


def make_torch_dataloader(reader, batch_size, last_batch="drop", max_batches=None,
                          device="cuda", host_prefetch=4, device_prefetch=2,
                          non_tensor_policy="host", shuffle_buffer_size=0,
                          shuffle_seed=None, device_stage=None, group=None,
                          stage_in_producer=False, trace_path=None, batch_cache=None,
                          cache_resume=None, autotune=None):
    """A :class:`TorchDataLoader` over ``reader``'s rows (``make_reader``)
    or column batches (``make_columnar_reader``, ``make_batch_reader``).

    :param batch_size: rows per batch.
    :param last_batch: ``"drop"`` | ``"pad"`` | ``"keep"``; ``"pad"`` adds a
        boolean ``__pad_mask__`` column (True = real row).
    :param max_batches: stop after this many batches.
    :param device: ``"cuda"`` (the default) or ``"cpu"``.
    :param host_prefetch: depth of the host-batch queue (live-resizable).
    :param device_prefetch: batches kept in flight on the device (>= 1,
        live-resizable); with ``stage_in_producer`` also the bound of the
        device queue, so up to 2 x ``device_prefetch`` + 1 batches are on
        the card.
    :param non_tensor_policy: ``"host"`` | ``"drop"`` | ``"error"`` for
        object, string and datetime columns.
    :param shuffle_buffer_size: > 0 shuffles rows through a
        ``RandomShufflingBuffer`` seeded by ``shuffle_seed`` (row readers).
    :param device_stage: a :class:`~.device_stage.DeviceStage` or None.
    :param group: a ``torch.distributed`` group whose ranks train in
        lockstep on their shards; with ``max_batches=None`` every rank stops
        after the smallest shard's batch count
        (:func:`~.sharding.derive_equal_step_max_batches`, no collective).
    :param stage_in_producer: issue the H2D copies and the device stage on
        a staging thread, off the consuming thread.
    :param trace_path: write each iteration's per-batch spans here as
        Chrome ``trace_event`` JSON (Perfetto loads it); None records
        nothing.
    :param batch_cache: a :class:`~petastorm_tpu_torch.cache_impl.
        BatchCache` or None. The first pass fills an entry for the epoch
        (published only when the pass ends cleanly); later passes replay it
        without the reader, byte for byte, or, when shuffling is asked for
        (``shuffle_seed``, a shuffle buffer, or a ``shuffle_row_groups``
        reader), through a fresh seed-tree permutation of its batches per
        pass. The fill then reads without the shuffle buffer and, with a
        seed, holds the whole epoch before its first batch.
    :param cache_resume: a ``state_dict()`` of kind ``"cache_replay"``
        (from either package's loader): resume that permuted pass at its
        batch position. Needs ``batch_cache`` and the same reader
        construction.
    :param autotune: arm the online autotuner (:mod:`petastorm_tpu_torch.
        pipeline`): a controller thread re-plans ``workers_count`` (thread
        pool readers), ``host_prefetch`` and ``device_prefetch`` within
        declared bounds from measured stage profiles. ``True`` uses the
        defaults; a dict may set ``interval_s``, ``bounds`` (``{knob: (lo,
        hi)}``), ``hysteresis``, ``placement_hysteresis``, ``tolerance``,
        ``probe_defer``, ``classify_kwargs``, ``rewrite_hysteresis``,
        ``rewrites`` and ``rewrite_thresholds``, the JAX loader's keys.
        ``None`` or ``False`` builds no graph and starts no thread.
    """
    if group is not None and max_batches is None:
        from petastorm_tpu_torch.torch_utils.sharding import derive_equal_step_max_batches

        max_batches = derive_equal_step_max_batches(reader, batch_size, last_batch)
    return TorchDataLoader(
        reader, ReaderBatchSource(reader, batch_size, last_batch, shuffle_buffer_size,
                                  shuffle_seed),
        max_batches=max_batches, device=device, host_prefetch=host_prefetch,
        device_prefetch=device_prefetch, non_tensor_policy=non_tensor_policy,
        device_stage=device_stage, stage_in_producer=stage_in_producer,
        trace_path=trace_path, batch_cache=batch_cache, cache_resume=cache_resume,
        autotune=autotune)


#: The keys an ``autotune=`` dict may hold (the JAX loader's).
_AUTOTUNE_KEYS = frozenset({"interval_s", "bounds", "hysteresis", "placement_hysteresis",
                            "tolerance", "probe_defer", "classify_kwargs",
                            "rewrite_hysteresis", "rewrites", "rewrite_thresholds"})


def _parse_autotune(autotune):
    """``autotune=`` → the controller's config dict, or None when disabled;
    the JAX loader's ValueErrors for anything else."""
    if autotune is None or autotune is False:
        return None
    if autotune is True:
        return {}
    if isinstance(autotune, dict):
        unknown = set(autotune) - _AUTOTUNE_KEYS
        if unknown:
            # A misspelled key would otherwise fall back to the default
            # unnoticed: the user believes they tuned something.
            raise ValueError(
                f"unknown autotune config key(s) {sorted(unknown)}; "
                f"allowed: {sorted(_AUTOTUNE_KEYS)}")
        return dict(autotune)
    raise ValueError(
        "autotune must be None, True, or a config dict "
        "(interval_s/bounds/hysteresis/placement_hysteresis/"
        "tolerance/probe_defer/classify_kwargs/"
        "rewrite_hysteresis/rewrites/rewrite_thresholds)")


class ReaderBatchSource:
    """A reader's rows as fixed-size batches (:func:`batch_iterator`), the
    ``batch_source`` of :func:`make_torch_dataloader`. The rows it batches
    are those the reader delivered, in order, so the loader can checkpoint
    by rolling the reader's state back to the rows it yielded."""

    def __init__(self, reader, batch_size, last_batch, shuffle_buffer_size, shuffle_seed):
        self.reader = reader
        self.batch_size = batch_size
        self.last_batch = last_batch
        self.shuffle_buffer_size = shuffle_buffer_size
        self.shuffle_seed = shuffle_seed

    def __call__(self):
        return batch_iterator(self.reader, self.batch_size, last_batch=self.last_batch,
                              shuffle_buffer_size=self.shuffle_buffer_size,
                              shuffle_seed=self.shuffle_seed)


class TorchDataLoader:
    """Iterable / context manager yielding ``{field: tensor}`` batches on
    ``device`` (host-side columns stay numpy arrays). Batches come from
    ``batch_source``, a zero-argument callable returning an iterator of
    ``{field: ndarray}`` batches (row batches of ``reader`` for
    :func:`make_torch_dataloader`, packed batches for the packing loader,
    remote batches for a :class:`~petastorm_tpu_torch.service.
    ServiceBatchSource`, with ``reader=None``); ``reader`` is stopped and
    joined on ``__exit__``. ``batch_cache`` and
    ``cache_resume`` need a :class:`ReaderBatchSource`; see
    :func:`make_torch_dataloader` for them and the other arguments.
    ``autotune`` holds the :class:`~petastorm_tpu_torch.pipeline.
    AutotuneController` once an armed loader was first iterated (None
    otherwise); it runs while an iteration does."""

    def __init__(self, reader, batch_source, max_batches=None, device="cuda",
                 host_prefetch=4, device_prefetch=2, non_tensor_policy="host",
                 device_stage=None, stage_in_producer=False, trace_path=None,
                 batch_cache=None, cache_resume=None, autotune=None):
        self._autotune_config = _parse_autotune(autotune)
        self.autotune = None  # the AutotuneController once armed
        self._device = resolve_device(device)
        if non_tensor_policy not in ("host", "drop", "error"):
            raise ValueError("non_tensor_policy must be host|drop|error")
        if device_prefetch < 1:
            raise ValueError("device_prefetch must be >= 1")
        if batch_cache is not None and not isinstance(batch_source, ReaderBatchSource):
            raise ValueError(
                "batch_cache is the local-reader decode bypass: it needs the reader's "
                "own batches (make_torch_dataloader), not a custom batch_source whose "
                "stream the cache key cannot describe")
        if cache_resume is not None:
            if batch_cache is None:
                raise ValueError(
                    "cache_resume is a batch_cache replay position; it needs batch_cache "
                    "armed (and the cache key ingredients the snapshot was taken under)")
            if cache_resume.get("kind") != "cache_replay":
                raise ValueError(f"cache_resume must be a state_dict() of kind "
                                 f"'cache_replay', got {cache_resume.get('kind')!r}")
            ventilator = getattr(reader, "_ventilator", None)
            if getattr(ventilator, "_randomize_item_order", False) \
                    and getattr(reader, "_shard_seed", None) is None:
                raise ValueError(
                    "cache_resume with a shuffle_row_groups reader requires shard_seed: "
                    "without one the fill order is not reproducible, so a cold-cache "
                    "resume would refill the entry in another canonical order and seek "
                    "the resume position into the wrong sequence")
        self.reader = reader
        self._batch_source = batch_source
        self._max_batches = max_batches
        self._non_tensor_policy = non_tensor_policy
        self._device_stage = device_stage
        self._host_prefetch = max(1, host_prefetch)
        self._device_prefetch = device_prefetch
        self._stage_in_producer = bool(stage_in_producer)
        self._trace_path = trace_path
        # Production ordinal of the next staged raw batch, the device
        # stage's draw seed: monotonic across iterations, so epoch 2 draws
        # afresh, and assigned on whichever thread stages, so the draws do
        # not depend on the prefetch depth or on stage_in_producer.
        self._stage_step = 0
        self._copy_stream = None
        self._queue = None       # host batches, or staged ones with stage_in_producer
        self._host_queue = None  # producer -> stager, with stage_in_producer
        self._producer = None
        self._stager = None
        self._source_iter = None  # this iteration's batch_source() iterator
        self._source_diag = None  # the batch source's diagnostics, snapshotted
        self._direct_iter = None  # ... when the consumer pulls it (prefetched)
        self._producer_error = None
        self._stop = threading.Event()
        self._rows_yielded = 0  # real rows handed out since the reader's tracker began
        self._yield_count_tracker = getattr(reader, "_delivery_tracker", None)
        self._batch_cache = batch_cache
        # A fill is valid only from the reader's start: the first pass this
        # loader pulls. Any later miss finds the reader mid-stream or
        # exhausted and streams uncached, never committing a tail.
        self._cache_fill_attempted = False
        # Each iteration of a cache-armed loader is one cache epoch; a
        # permuted pass serves permutation(fold_in(seed, ("cache-epoch",
        # k))), and cache_resume re-enters one at a batch position.
        self._cache_epoch = 0
        self._cache_skip = 0
        self._cache_pass = None  # the live permuted pass, for state_dict
        self._cache_resume_seed = None
        self._cache_resume_has_seed = False
        if cache_resume is not None:
            self._cache_epoch = int(cache_resume["cache_epoch"])
            self._cache_skip = max(0, int(cache_resume.get("batches_yielded", 0)))
            # Checked against the permutation seed at serve time: another
            # seed's permutation would re-serve some batches and skip others.
            self._cache_resume_seed = cache_resume.get("shuffle_seed")
            self._cache_resume_has_seed = "shuffle_seed" in cache_resume
        self._loader_id = _acquire_loader_id()
        self._m_batches = LOADER_BATCHES.labels(self._loader_id)
        self._m_rows = LOADER_ROWS.labels(self._loader_id)
        self._m_stage = {stage: LOADER_STAGE_SECONDS.labels(self._loader_id, stage)
                         for stage in _STAGES}
        self._m_overlap = LOADER_DISPATCH_OVERLAP.labels(self._loader_id)
        self._metrics_finalizer = weakref.finalize(self, _release_loader_metrics,
                                                   self._loader_id)
        # Module globals may be gone at interpreter exit; only long-lived
        # processes need the series retired.
        self._metrics_finalizer.atexit = False
        self._h2d_bytes = 0
        self._reset_diagnostics()

    # -- diagnostics -------------------------------------------------------

    @property
    def loader_id(self):
        """This loader's ``loader`` label value in the registry."""
        return self._loader_id

    def _reset_diagnostics(self):
        """Start the per-iteration view: the registry's current values
        become the baseline ``diagnostics`` subtracts (the series stay
        monotonic for scrapers)."""
        self._base = {"batches": self._m_batches.value, "rows": self._m_rows.value,
                      "h2d_bytes": self._h2d_bytes,
                      "stage": {stage: child.sum for stage, child in self._m_stage.items()}}
        self._iter_start = None
        self._iter_end = None

    @property
    def diagnostics(self):
        """This iteration's counters, read live, under the JAX loader's key
        names: ``batches``, ``rows``, ``wall_s``, ``stall_s`` and
        ``input_stall_pct`` (the consumer's wait for batches over wall
        time), ``producer_decode_s`` (reader pull or cache serve +
        collation + pinning), ``producer_queue_wait_s``,
        ``device_dispatch_s`` (issuing the H2D copies and the device stage:
        the sum of plain-tensor copies, ``raw_stage_s`` and
        ``device_decode_s``), ``shard_put_s`` (0.0: no sharded delivery
        here), ``dispatch_overlap_pct`` (the share of dispatch hidden inside
        decode or the consumer's step rather than extending the wall),
        ``consumer_s`` (time the caller held each batch) and ``h2d_bytes``
        (bytes copied to a CUDA device). Each is this loader's registry
        series less its value when the iteration began; reading refreshes
        the ``loader_dispatch_overlap_pct`` gauge. A batch source with a
        ``diagnostics`` dict of its own (the data service's) adds it under
        ``source``, as of the iteration's start or end."""
        start, end = self._iter_start, self._iter_end
        wall = 0.0 if start is None else max(
            0.0, (time.perf_counter() if end is None else end) - start)
        base = self._base
        stage = {name: max(0.0, child.sum - base["stage"][name])
                 for name, child in self._m_stage.items()}
        dispatch = sum(stage[name] for name in _DISPATCH_STAGES)
        overlap_pct = (round(100.0 * max(0.0, min(1.0, (
            stage["decode"] + stage["consumer"] + dispatch - wall) / dispatch)), 2)
            if dispatch > 0 else 100.0)
        self._m_overlap.set(overlap_pct)
        return {
            "batches": int(self._m_batches.value - base["batches"]),
            "rows": int(self._m_rows.value - base["rows"]),
            "stall_s": stage["wait"],
            "wall_s": wall,
            "input_stall_pct": (round(100.0 * stage["wait"] / wall, 2)
                                if wall > 0 else 0.0),
            "max_batches": self._max_batches,
            "producer_decode_s": stage["decode"],
            "producer_queue_wait_s": stage["queue_wait"],
            "device_dispatch_s": dispatch,
            "raw_stage_s": stage["raw_stage"],
            "device_decode_s": stage["device_decode"],
            "shard_put_s": stage["shard_put"],
            "dispatch_overlap_pct": overlap_pct,
            "h2d_bytes": int(self._h2d_bytes - base["h2d_bytes"]),
            "consumer_s": stage["consumer"],
            **({"source": dict(self._source_diag)} if self._source_diag is not None
               else {}),
        }

    def _snapshot_source_diagnostics(self):
        """Copy a batch source's ``diagnostics`` dict (the data service's
        per-worker, ready-queue and recovery counters) into
        ``diagnostics["source"]``: at an iteration's start and end."""
        source_diag = getattr(self._batch_source, "diagnostics", None)
        if isinstance(source_diag, dict):
            self._source_diag = dict(source_diag)

    def exclude_stall_so_far(self):
        """Zero this iteration's stall up to now, e.g. the pipeline-fill
        wait for the first batch, which every run pays once (the registry
        histogram keeps the whole history)."""
        self._base["stage"]["wait"] = self._m_stage["wait"].sum

    def stage_quantiles(self, quantiles=(0.5, 0.99)):
        """Approximate per-batch latency quantiles of each pipeline stage,
        ``{stage: {"p50": s, "p99": s}}``, estimated from this loader's
        registry histograms over its lifetime (None for a stage never
        observed)."""
        return {stage: {f"p{int(q * 100)}": child.quantile(q) for q in quantiles}
                for stage, child in self._m_stage.items()}

    # -- runtime knobs -------------------------------------------------------

    @property
    def host_prefetch(self):
        """Depth of the host-batch queue. Settable while the loader runs:
        the running iteration's queue takes the new bound at once."""
        return self._host_prefetch

    @host_prefetch.setter
    def host_prefetch(self, value):
        value = int(value)
        if value < 1:
            raise ValueError("host_prefetch must be >= 1")
        self._host_prefetch = value
        host_queue = self._host_queue if self._stage_in_producer else self._queue
        if host_queue is not None:
            resize_bounded_queue(host_queue, value)

    @property
    def device_prefetch(self):
        """Batches kept in flight on the device. Settable while the loader
        runs: the consumer reads it per batch (a raise deepens the window
        at the next fill, a shrink drains down), and with
        ``stage_in_producer`` the device queue takes it as its bound."""
        return self._device_prefetch

    @device_prefetch.setter
    def device_prefetch(self, value):
        value = int(value)
        if value < 1:
            raise ValueError("device_prefetch must be >= 1")
        self._device_prefetch = value
        if self._stage_in_producer and self._queue is not None:
            resize_bounded_queue(self._queue, value)

    def _ensure_autotune(self):
        """Build (once) and start the autotune controller when armed: the
        graph binds the reader and this loader as they are iterated."""
        if self._autotune_config is None:
            return
        if self.autotune is None:
            from petastorm_tpu_torch.pipeline import (
                AutotuneController,
                Planner,
                build_loader_graph,
            )

            cfg = self._autotune_config
            graph = build_loader_graph(self, bounds=cfg.get("bounds"))
            planner = Planner(
                {name: knob.descriptor() for name, knob in graph.knobs.items()},
                hysteresis=cfg.get("hysteresis", 2),
                placement_hysteresis=cfg.get("placement_hysteresis", 4),
                tolerance=cfg.get("tolerance", 0.05),
                probe_defer=cfg.get("probe_defer", 3),
                classify_kwargs=cfg.get("classify_kwargs"),
                rewrite_hysteresis=cfg.get("rewrite_hysteresis", 6),
                rewrites=cfg.get("rewrites", True),
                rewrite_thresholds=cfg.get("rewrite_thresholds"))
            self.autotune = AutotuneController(
                graph, interval_s=cfg.get("interval_s", 0.5), planner=planner)
        self.autotune.start()

    # -- producer ----------------------------------------------------------

    def _host_tensor(self, arr):
        """A host column as a tensor: copied into pinned memory for a CUDA
        device; for the CPU, shared, or copied when it is read-only (Arrow
        buffers of the batch reader, a cache entry's columns), which torch
        cannot share."""
        arr = np.ascontiguousarray(arr)
        if self._device.type == "cuda":
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            pinned.numpy()[...] = arr
            return pinned
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

    def _to_host(self, batch):
        """A collated batch → ``(columns, raw image fields)``: numeric
        columns as (pinned) tensors, non-tensor columns as numpy or dropped
        by ``non_tensor_policy``, the device stage's fields apart."""
        raw = {}
        if self._device_stage is not None:
            raw, batch = self._device_stage.split(batch)
        out = {}
        for name, col in batch.items():
            arr = np.asarray(col)
            if arr.dtype == object or arr.dtype.kind in ("U", "S", "M", "m"):
                if self._non_tensor_policy == "error":
                    raise TypeError(
                        f"Column {name!r} has non-tensor dtype {arr.dtype}; set "
                        "non_tensor_policy='host' or 'drop', select numeric "
                        "schema_fields, or add a TransformSpec")
                if self._non_tensor_policy == "host":
                    out[name] = arr
                continue
            out[name] = self._host_tensor(arr)
        return out, {name: self._host_tensor(arr) for name, arr in raw.items()}

    def _put(self, q, item):
        """Put ``item`` on the bounded queue ``q`` unless the loader stops."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _put_sentinel(self, q):
        # The sentinel must land or the next stage blocks forever; only a
        # stop (which drains the queues) gives up on it.
        while True:
            try:
                q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                if self._stop.is_set():
                    return

    def _produce(self):
        target = self._host_queue if self._stage_in_producer else self._queue
        try:
            source_iter = (self._reader_batches() if self._source_iter is None
                           else self._source_iter)
            batches = iter(source_iter)
            if self._max_batches is not None:
                batches = itertools.islice(batches, self._max_batches)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                with tracing.span("loader.decode") as span:
                    batch = next(batches, _SENTINEL)
                    if batch is _SENTINEL:
                        span.discard()
                    else:
                        batch = self._to_host(batch)
                self._m_stage["decode"].observe(time.perf_counter() - t0)
                if batch is _SENTINEL:
                    break
                t0 = time.perf_counter()
                self._put(target, batch)
                batch = None
                self._m_stage["queue_wait"].observe(time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 - re-raised on the consumer side
            self._producer_error = exc
        finally:
            close = getattr(locals().get("source_iter"), "close", None)
            if callable(close):
                close()  # a service source's streams and reader threads
            self._put_sentinel(target)

    # -- the decoded-batch cache -------------------------------------------

    def _uncached_batches(self):
        """The reader's batches without the shuffle buffer: what a fill
        stores, canonical whatever the seed."""
        source = self._batch_source
        return batch_iterator(source.reader, source.batch_size,
                              last_batch=source.last_batch, max_batches=self._max_batches)

    def _reader_batches(self):
        """The producer's batch stream with the cache in front of the
        reader. A hit serves the whole epoch from the entry (the reader is
        not pulled, so an exhausted ``num_epochs=1`` reader replays); a
        miss streams the reader's batches while writing them into an entry
        that is published only when the pass ends cleanly. With shuffling
        asked for, the entry stays canonical and each pass serves it
        through a fresh permutation (:meth:`_serve_entry`); such a fill
        holds the epoch before it serves the first batch."""
        cache = self._batch_cache
        key = self._reader_cache_key()
        permute_seed = self._cache_permute_seed()
        if self._cache_resume_has_seed and self._cache_resume_seed != permute_seed:
            raise ValueError(
                f"cache_resume was snapshotted under shuffle_seed="
                f"{self._cache_resume_seed!r} but this loader's permutation seed is "
                f"{permute_seed!r}: the resume position indexes that seed's "
                f"permutation, so resuming here would re-serve some batches and skip "
                f"others; rebuild the loader and reader with the snapshot's shuffle "
                f"configuration")
        cache_epoch = self._cache_epoch
        self._cache_epoch += 1
        skip, self._cache_skip = self._cache_skip, 0
        if permute_seed is not None:
            # Set before any yield, so a state_dict() taken mid-fill resumes
            # at `skip`; ``n`` (set once the entry exists) lets it roll a
            # finished pass forward.
            self._cache_pass = {"cache_epoch": cache_epoch, "base": skip,
                                "seed": permute_seed, "n": None}
        entry, tier = cache.get_tiered(key)
        if entry is not None:
            yield from self._serve_entry(entry, tier, permute_seed, cache_epoch, skip)
            return
        if self._cache_fill_attempted:
            # The reader's start was consumed by an earlier (complete or
            # abandoned) pass: what it yields now is a tail, served uncached
            # and never committed, and no replayable position.
            self._cache_pass = None
            produced = 0
            for batch in self._uncached_batches():
                produced += 1
                yield batch
            if produced == 0:
                warnings.warn(
                    "batch_cache miss over an exhausted reader: the cached epoch entry "
                    "is no longer retained (evicted by other fills?), so this "
                    "iteration yields no batches; raise the cache budgets or enable "
                    "the disk tier", RuntimeWarning, stacklevel=2)
            return
        self._cache_fill_attempted = True
        builder = cache.begin_fill(key)
        if permute_seed is not None:
            for batch in self._uncached_batches():
                if self._stop.is_set():
                    return  # abandoned: the builder never commits
                builder.add_batch(batch)
            entry = builder.commit()
            self._warn_unless_retained(key)
            yield from self._serve_entry(entry, None, permute_seed, cache_epoch, skip)
            return
        for batch in self._uncached_batches():
            builder.add_batch(batch)
            yield batch
        builder.commit()
        self._warn_unless_retained(key)

    def _warn_unless_retained(self, key):
        if not self._batch_cache.retained(key):
            # The next pass would find a miss over an exhausted reader and
            # yield nothing: say so while the budget can still be raised.
            warnings.warn(
                "batch_cache could not retain this epoch's entry (larger than the "
                "memory budget and no disk tier kept it); re-iterating this exhausted "
                "reader will yield no batches; raise mem_budget_bytes or enable the "
                "disk tier", RuntimeWarning, stacklevel=3)

    def _cache_permute_seed(self):
        """The serve-time permutation seed, or None for byte-exact replay
        (no shuffling asked for). Shuffling is asked for by a shuffle
        buffer, a ``shuffle_seed`` or a ``shuffle_row_groups`` reader; the
        seed is ``shuffle_seed``, else the reader's ``shard_seed``, else 0."""
        source = self._batch_source
        ventilator = getattr(self.reader, "_ventilator", None)
        reader_shuffled = bool(getattr(ventilator, "_randomize_item_order", False))
        if not (source.shuffle_buffer_size or source.shuffle_seed is not None
                or reader_shuffled):
            return None
        if source.shuffle_seed is not None:
            return int(source.shuffle_seed)
        shard_seed = getattr(self.reader, "_shard_seed", None)
        return int(shard_seed) if shard_seed is not None else 0

    def _serve_entry(self, entry, tier, permute_seed, cache_epoch, skip):
        """A whole-epoch entry, permuted when ``permute_seed`` is set:
        position ``i`` of the pass is canonical batch ``order[i]`` with
        ``order = permutation(fold_in(seed, ("cache-epoch", k)), n)``, the
        JAX loader's order; ``skip`` (a resume position) indexes the
        permuted stream."""
        from petastorm_tpu_torch.service.seedtree import fold_in, permutation

        if permute_seed is None:
            order = range(entry.num_batches)
        else:
            order = permutation(fold_in(int(permute_seed), ("cache-epoch", cache_epoch)),
                                entry.num_batches)
            self._batch_cache.note_permuted_serve(tier or "mem")
            if self._cache_pass is not None:
                self._cache_pass["n"] = entry.num_batches
        for position, index in enumerate(order):
            if position >= skip:
                yield entry.batch_at(index).to_dict()

    def _reader_cache_key(self):
        """The content key of this loader's batch sequence, the JAX
        loader's for the same reader construction: the reader's pieces
        (path, row group), fields, transform, predicate, pass count and
        resume position, and the batching knobs. Every shuffle ingredient
        is left out: order is composed at serve time, so one fill serves
        any seed and every epoch."""
        from petastorm_tpu_torch.cache_impl import batch_fingerprint

        reader = self.reader
        source = self._batch_source
        pieces = [(piece.path, piece.row_group) for piece in getattr(reader, "_pieces", [])]
        return batch_fingerprint(
            reader._dataset_path_signature(), pieces, source.batch_size,
            fields=sorted(reader.schema.fields),
            transform=getattr(reader, "_transform_spec", None),
            factory=type(reader).__name__ + "/"
            + type(reader._results_queue_reader).__name__,
            extra={"last_batch": source.last_batch,
                   "max_batches": self._max_batches,
                   "num_epochs": reader.num_epochs,
                   "predicate": repr(getattr(reader, "_predicate", None)),
                   "resume": repr(getattr(reader, "_resume_state", None))})

    # -- staging -------------------------------------------------------------

    def _stage(self, host_batch):
        """``(columns, raw)`` host tensors → ``(device batch, ready event)``;
        the event is None when there is no copy to wait for (CPU device).
        The raw image fields go through the device stage, timed apart as
        ``raw_stage_s`` (their copy) and ``device_decode_s`` (its ops)."""
        columns, raw = host_batch
        cuda = self._device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self._device)
        with torch.cuda.stream(self._copy_stream) if cuda else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = {name: t.to(self._device, non_blocking=True) if torch.is_tensor(t) else t
                   for name, t in columns.items()}
            self._m_stage["device_put"].observe(time.perf_counter() - t0)
            if cuda:
                self._h2d_bytes += sum(t.nbytes for t in columns.values()
                                       if torch.is_tensor(t))
            if raw:
                step, self._stage_step = self._stage_step, self._stage_step + 1
                t0 = time.perf_counter()
                with tracing.span("loader.raw_stage"):
                    raw_dev = {name: t.to(self._device, non_blocking=True)
                               for name, t in raw.items()}
                self._m_stage["raw_stage"].observe(time.perf_counter() - t0)
                if cuda:
                    raw_bytes = sum(t.nbytes for t in raw.values())
                    self._h2d_bytes += raw_bytes
                    self._device_stage.h2d_bytes += raw_bytes
                t0 = time.perf_counter()
                with tracing.span("loader.device_decode"):
                    out.update(self._device_stage.apply(raw_dev, step))
                raw_dev = None  # the outputs exist: drop the raw bytes now
                self._m_stage["device_decode"].observe(time.perf_counter() - t0)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return out, ready

    def _stage_traced(self, host_batch):
        span = tracing.span("loader.device_put")
        if span.armed:
            # The batch's tensors, each one copy to the device.
            tensors = [t for part in host_batch for t in part.values() if torch.is_tensor(t)]
            span.args.update(copies=len(tensors), bytes=sum(t.nbytes for t in tensors))
        with span:
            return self._stage(host_batch)

    def _stage_loop(self):
        """The staging thread (``stage_in_producer``): host batches →
        staged batches on the device queue."""
        try:
            while not self._stop.is_set():
                try:
                    host_batch = self._host_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if host_batch is _SENTINEL:
                    break
                staged = self._stage_traced(host_batch)
                host_batch = None
                self._put(self._queue, staged)
                # On the device: a reference held while blocked on the
                # device queue would keep one batch past device_prefetch.
                staged = None
        except Exception as exc:  # noqa: BLE001 - re-raised on the consumer side
            self._producer_error = exc
        finally:
            self._put_sentinel(self._queue)

    # -- consumer ----------------------------------------------------------

    def _hand_over(self, batch, ready):
        if ready is None:
            return batch
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(ready)
        for t in batch.values():
            if torch.is_tensor(t):
                # Allocated on the copy stream: tell the allocator the
                # consumer's stream uses it too.
                t.record_stream(consumer)
        return batch

    @staticmethod
    def _batch_rows(batch):
        for name, col in batch.items():
            if name != PAD_MASK_KEY:
                return int(col.shape[0])
        return 0

    def __iter__(self):
        # Both threads of an earlier iteration are stopped and joined before
        # the queues are replaced: a survivor would put stale batches and a
        # premature sentinel into the new ones.
        self.stop()
        self._direct_iter = self._source_iter = None
        if self._batch_cache is None:
            self._source_iter = self._batch_source()
            if not self._stage_in_producer and getattr(self._source_iter, "prefetched", False):
                self._direct_iter = self._source_iter
        if self._direct_iter is not None:
            self._queue = self._host_queue = None
        elif self._stage_in_producer:
            self._queue = queue.Queue(maxsize=self._device_prefetch)
            self._host_queue = queue.Queue(maxsize=self._host_prefetch)
        else:
            self._queue = queue.Queue(maxsize=self._host_prefetch)
            self._host_queue = None
        self._stop.clear()
        self._producer_error = None
        # reader.reset() installs a fresh delivery tracker whose counts start
        # at zero, so the yielded-row count restarts with it.
        tracker = getattr(self.reader, "_delivery_tracker", None)
        if tracker is not self._yield_count_tracker:
            self._yield_count_tracker = tracker
            self._rows_yielded = 0
        self._reset_diagnostics()
        self._iter_start = time.perf_counter()
        if self._trace_path is not None:
            # Scoped arming: the first armer clears the buffer, so each
            # iteration's file holds that iteration's spans.
            tracing.COLLECTOR.acquire()
        if self._direct_iter is not None:
            self._ensure_autotune()
            return self._iterate()
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name="torch-loader-producer")
        self._producer.start()
        if self._stage_in_producer:
            self._stager = threading.Thread(target=self._stage_loop, daemon=True,
                                            name="torch-loader-stager")
            self._stager.start()
        self._ensure_autotune()
        return self._iterate()

    def _iterate(self):
        inflight = []
        done = False
        collector = tracing.COLLECTOR
        direct = self._direct_iter
        if direct is not None and self._max_batches is not None:
            direct = itertools.islice(direct, self._max_batches)
        self._snapshot_source_diagnostics()
        try:
            while True:
                while not done and len(inflight) < self._device_prefetch:
                    t0 = time.perf_counter()
                    with tracing.span("loader.wait") as span:
                        item = (next(direct, _SENTINEL) if direct is not None
                                else self._queue.get())
                        if item is _SENTINEL:
                            span.discard()
                    t1 = time.perf_counter()
                    self._m_stage["wait"].observe(t1 - t0)
                    if direct is not None and item is not _SENTINEL:
                        # The host copies a producer would have made.
                        with tracing.span("loader.decode"):
                            item = self._to_host(item)
                        self._m_stage["decode"].observe(time.perf_counter() - t1)
                    if item is _SENTINEL:
                        done = True
                        if self._producer_error is not None:
                            raise self._producer_error
                        break
                    inflight.append(item if self._stage_in_producer
                                    else self._stage_traced(item))
                    item = None
                if not inflight:
                    return
                batch = self._hand_over(*inflight.pop(0))
                rows = self._batch_rows(batch)
                self._m_batches.inc()
                self._m_rows.inc(rows)
                mask = batch.get(PAD_MASK_KEY)
                # Resume accounting counts real rows only (a padded final
                # batch's mask is read once, at the end of a stream).
                self._rows_yielded += rows if mask is None else int(mask.sum())
                t_yield = time.perf_counter()
                yield batch
                t_back = time.perf_counter()
                batch = None
                self._m_stage["consumer"].observe(t_back - t_yield)
                # Not a tracing.span: the caller's own profiler ranges open
                # and close inside this interval, which no range may span.
                if collector.enabled:
                    collector.record_span("loader.consumer", t_yield, t_back)
        finally:
            self._iter_end = time.perf_counter()
            self._snapshot_source_diagnostics()
            if self._trace_path is not None:
                collector.export(self._trace_path)
                collector.release()
            if self._direct_iter is not None:
                self._direct_iter.close()  # the source's streams and threads
            self.stop()

    # -- checkpoint ----------------------------------------------------------

    def state_dict(self):
        """The input pipeline's checkpoint at what this loader has yielded.

        In a permuted cache pass (fill or replay): ``{"version": 1,
        "kind": "cache_replay", "cache_epoch", "batches_yielded",
        "shuffle_seed"}``, the JAX loader's dict, to pass as
        ``cache_resume=`` with the same reader construction and a cache
        (a cold cache refills canonically and then seeks); a fully
        consumed pass rolls forward to the next pass's start. Otherwise the
        reader's ``state_dict(yielded_rows=...)``, so rows pulled into the
        batcher, the host queue or the device prefetch but not yet yielded
        are re-read on resume (at-least-once); pass it as ``resume_state=``
        to the reader factory feeding a fresh loader. Call it between steps
        from the training thread.

        A custom ``batch_source`` with a ``state_dict`` of its own (the
        data service's :class:`~petastorm_tpu_torch.service.
        ServiceBatchSource`) owns the snapshot: it is given
        ``yielded_batches``, the batches this loader has yielded, when it
        takes that argument, so batches still in the prefetch queues are
        re-delivered on resume. Refused with a custom ``batch_source``
        without one (the packed loader: repacked batches cannot be
        attributed to deliveries) and, outside a cache pass, with a shuffle
        buffer (it reorders rows, so buffered rows are not the newest
        deliveries).
        """
        source = self._batch_source
        if not isinstance(source, ReaderBatchSource):
            source_state = getattr(source, "state_dict", None)
            if callable(source_state):
                import inspect

                try:
                    params = inspect.signature(source_state).parameters
                except (TypeError, ValueError):
                    params = {}
                if "yielded_batches" in params or any(
                        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
                    return source_state(yielded_batches=int(
                        self._m_batches.value - self._base["batches"]))
                return source_state()
            raise ValueError(
                "state_dict is not supported with a custom batch_source "
                "(e.g. the packed loader): yielded-row accounting cannot "
                "attribute repacked batches to reader deliveries. Checkpoint "
                "at an epoch boundary with the reader's state_dict()")
        if self._batch_cache is not None and self._cache_pass is not None:
            pass_info = self._cache_pass
            yielded = pass_info["base"] + int(self._m_batches.value - self._base["batches"])
            cache_epoch = pass_info["cache_epoch"]
            n = pass_info["n"]
            if n is not None and yielded >= n:
                # Resuming "at the end of pass k" must serve pass k + 1.
                cache_epoch, yielded = cache_epoch + 1, 0
            return {"version": 1, "kind": "cache_replay", "cache_epoch": cache_epoch,
                    "batches_yielded": yielded, "shuffle_seed": pass_info["seed"]}
        if source.shuffle_buffer_size:
            raise ValueError(
                "state_dict is not supported with shuffle_buffer_size > 0: "
                "the shuffle buffer reorders rows, so buffered rows cannot "
                "be attributed to recent deliveries. Shuffle with "
                "shuffle_row_groups/shard_seed instead, or checkpoint at "
                "an epoch boundary with the reader's state_dict()")
        if not hasattr(self.reader, "state_dict"):
            raise TypeError("state_dict requires a petastorm_tpu_torch Reader "
                            f"(got {type(self.reader).__name__})")
        return self.reader.state_dict(yielded_rows=self._rows_yielded)

    # -- lifecycle ---------------------------------------------------------

    def stop(self):
        """Stop the autotune controller, the producer and the stager and
        join them (a stopped loader can be iterated again; batches still
        queued are discarded)."""
        self._stop.set()
        if self.autotune is not None:
            self.autotune.stop()
            self.autotune.join()
        if self._direct_iter is not None:
            try:
                self._direct_iter.close()
            except ValueError:
                pass  # being pulled on another thread: its own finally closes it
        for thread in (self._producer, self._stager):
            while thread is not None and thread.is_alive():
                for q in (self._queue, self._host_queue):
                    if q is not None:
                        try:  # unblock a thread waiting on a full queue
                            q.get_nowait()
                        except queue.Empty:
                            pass
                thread.join(timeout=0.1)
        self._producer = self._stager = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        if self.reader is not None:
            self.reader.stop()
            self.reader.join()
