"""The pipeline as an explicit stage graph (the port's own copy of
``petastorm_tpu/pipeline/graph.py``, its local half).

The reader / loader stack is described as a chain of :class:`StageNode` s —
worker side ``read → decode → transform → collate → serialize → send``,
loader side ``recv → queue → raw_stage / device_decode → device_put →
consume``. Each node carries:

- its **measured cost**: a callable returning the cumulative ``(count,
  seconds)`` of the stage, fed from the loader's ``loader_stage_seconds``
  histograms (``telemetry/metrics.py``); a node with no series of its own
  carries ``None``;
- a **placement**: ``trainer`` (runs on the training host), ``worker`` (a
  data-service worker) or ``device`` (runs on the card).

On top of the nodes the graph binds :class:`Knob` s, the runtime handles
the autotuner (``pipeline/autotune.py``) moves within declared bounds: the
reader pool's ``workers_count`` (:meth:`ThreadPool.resize`) and the
loader's ``host_prefetch`` / ``device_prefetch`` (live queue resizes).

:func:`build_loader_graph` inspects a
:class:`~petastorm_tpu_torch.torch_utils.loader.TorchDataLoader` and wires
nodes, signals and knobs to the live objects.
:meth:`PipelineGraph.snapshot` reads everything once (cumulative,
monotonic); the controller windows consecutive snapshots into the
profiles the planner reads.

On a CUDA device every stage timer is a host clock: ``device_put``,
``raw_stage`` and ``device_decode`` time the enqueue of ``non_blocking``
copies and of the device stage's ops on the copy stream, and the
consumer's wait for them is a device-side ``wait_event``. So the
``dispatch_s`` signal reads host-side staging cost, and a training step
whose host does not synchronise shows up in ``consumer_s`` or in the next
blocking call, not in ``dispatch_s``.

Over the data service's batch source the worker-side stages run on the
remote workers, and the graph binds the source's ``credits``,
``ready_queue_depth`` and ``transform_placement`` knobs and reads the
``recv_stall_s`` and ``credit_wait_s`` signals, the four rewrite knobs
and their trigger signals, and over a packing source the ``pack`` stage
between ``collate`` and ``serialize`` with its ``packing_placement`` knob.
"""

from __future__ import annotations

import os

#: Placement vocabulary: where a stage's work executes.
PLACEMENTS = ("trainer", "worker", "device")

#: Setters only a data-service batch source has: a source with any of them
#: is remote.
_SERVICE_SETTERS = ("set_credits", "set_ready_queue_depth", "set_transform_placement",
                    "set_packing_placement", "set_stage_fusion", "set_filter_placement",
                    "set_cache_placement", "set_reader_family")


class StageNode:
    """One pipeline stage: a name, where it runs, and how it is measured.

    :param name: stage name (unique within a graph side).
    :param side: ``"worker"`` (produces batches) or ``"client"`` (consumes
        them): the two chains of the stage graph.
    :param placement: one of :data:`PLACEMENTS`.
    :param metric: zero-argument callable returning cumulative ``(count,
        seconds)`` for the stage, or ``None`` when the stage has no series
        of its own.
    :param flippable: True for a stage whose placement the autotuner may
        move.
    :param description: one line for rendering.
    :param placement_fn: a flippable stage's live placement reader.
    :param fuse_group: the stage names this node runs fused with.
    """

    def __init__(self, name, side, placement, metric=None, flippable=False,
                 description="", placement_fn=None, fuse_group=None):
        if side not in ("worker", "client"):
            raise ValueError(f"side must be worker|client, got {side!r}")
        if placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, got {placement!r}")
        self.name = name
        self.side = side
        self._placement = placement
        self.metric = metric
        self.flippable = flippable
        self.description = description
        self.fuse_group = tuple(fuse_group) if fuse_group else None
        self._placement_fn = placement_fn

    @property
    def placement(self):
        if self._placement_fn is not None:
            value = self._placement_fn()
            if value in PLACEMENTS:
                return value
        return self._placement

    def measure(self):
        """Cumulative ``(count, seconds)``: ``(0, 0.0)`` when unmeasured."""
        if self.metric is None:
            return (0, 0.0)
        return self.metric()

    def __repr__(self):
        return (f"StageNode({self.name!r}, side={self.side!r}, "
                f"placement={self.placement!r})")


class Knob:
    """A runtime-adjustable pipeline parameter with declared bounds.

    :param name: knob name (the telemetry label value).
    :param get/set: live accessors against the owning object; ``set``
        receives an already-clamped value.
    :param lo/hi: inclusive bounds: the autotuner never sets a value
        outside them (clamped at apply time as well as plan time).
    :param kind: ``"int"`` (geometric hill-climb steps) or ``"choice"``
        (a discrete flip between ``choices``).
    :param choices: for ``kind="choice"``: the allowed values.
    :param applies: ``"live"`` (takes effect at once), ``"next-stream"`` or
        ``"next-iteration"``, carried into the decision trail.
    :param rewrite: the rewrite kind (``pipeline/rewrites.py``) this knob
        applies, or None.
    """

    def __init__(self, name, get, set, lo=None, hi=None, kind="int",
                 choices=None, applies="live", rewrite=None):
        if kind not in ("int", "choice"):
            raise ValueError(f"kind must be int|choice, got {kind!r}")
        if kind == "choice" and not choices:
            raise ValueError("choice knobs need choices")
        if kind == "int" and (lo is None or hi is None or lo > hi):
            raise ValueError(f"int knob {name!r} needs lo <= hi bounds")
        self.name = name
        self.get = get
        self.set = set
        self.lo = lo
        self.hi = hi
        self.kind = kind
        self.choices = tuple(choices) if choices else None
        self.applies = applies
        self.rewrite = rewrite

    def clamp(self, value):
        if self.kind == "choice":
            return value if value in self.choices else self.get()
        return max(self.lo, min(self.hi, int(value)))

    def descriptor(self):
        """The planner-facing bounds and kind (plain data)."""
        out = {"kind": self.kind, "applies": self.applies}
        if self.kind == "choice":
            out["choices"] = list(self.choices)
        else:
            out["lo"] = self.lo
            out["hi"] = self.hi
        if self.rewrite:
            out["rewrite"] = self.rewrite
        return out


class PipelineGraph:
    """A pipeline described as stage nodes, edges, knobs and signals.

    ``signals`` are graph-level cumulative measurements that are not one
    stage's histogram, the quantities the planner classifies bottlenecks
    from: ``rows`` delivered, ``stall_s`` (the consumer blocked on input),
    ``queue_wait_s`` (the producer blocked on a full queue), ``decode_s``,
    ``dispatch_s`` and ``consumer_s``. A signal that raises reads as None.
    """

    def __init__(self, nodes, edges, knobs=(), signals=None):
        self.nodes = {}
        for node in nodes:
            key = (node.side, node.name)
            if key in self.nodes:
                raise ValueError(f"duplicate stage {key}")
            self.nodes[key] = node
        names = {key[1] for key in self.nodes}
        for src, dst in edges:
            if src not in names or dst not in names:
                raise ValueError(f"edge ({src!r}, {dst!r}) names an "
                                 f"unknown stage")
        self.edges = list(edges)
        self.knobs = {}
        for knob in knobs:
            if knob.name in self.knobs:
                raise ValueError(f"duplicate knob {knob.name!r}")
            self.knobs[knob.name] = knob
        self._signals = dict(signals or {})

    def node(self, name, side=None):
        for (node_side, node_name), node in self.nodes.items():
            if node_name == name and (side is None or node_side == side):
                return node
        raise KeyError(name)

    def snapshot(self):
        """One cumulative reading of every stage, signal and knob (plain
        data); the controller subtracts consecutive snapshots to window a
        profile."""
        stages = {}
        for (side, name), node in self.nodes.items():
            count, seconds = node.measure()
            stages[name] = {"side": side, "placement": node.placement,
                            "count": int(count),
                            "seconds": float(seconds)}
            if node.fuse_group:
                stages[name]["fuse_group"] = list(node.fuse_group)
        signals = {}
        for name, fn in self._signals.items():
            try:
                signals[name] = fn()
            except Exception:  # noqa: BLE001 - an unreadable signal reads as None
                signals[name] = None
        return {
            "stages": stages,
            "signals": signals,
            "knobs": {name: knob.get() for name, knob in self.knobs.items()},
        }

    def describe(self):
        """The static structure, without measurements."""
        return {
            "stages": [{"name": node.name, "side": node.side,
                        "placement": node.placement,
                        "flippable": node.flippable,
                        "fuse_group": (list(node.fuse_group)
                                       if node.fuse_group else None),
                        "description": node.description}
                       for node in self.nodes.values()],
            "edges": list(self.edges),
            "knobs": {name: knob.descriptor()
                      for name, knob in self.knobs.items()},
        }


def _histogram_metric(child):
    """Adapt a registry histogram child to the node metric contract."""
    return lambda: (child.count, child.sum)


def _default_workers_hi():
    return max(4, 2 * (os.cpu_count() or 1))


def _is_service_source(source):
    """True for a data-service batch source (it has the service's setters);
    a :class:`ReaderBatchSource`, a packer or any other local callable is
    not one."""
    from petastorm_tpu_torch.torch_utils.loader import ReaderBatchSource

    if source is None or isinstance(source, ReaderBatchSource):
        return False
    return any(hasattr(source, name) for name in _SERVICE_SETTERS)


def build_loader_graph(loader, bounds=None):
    """Describe a live :class:`TorchDataLoader`'s pipeline as a graph.

    Wires the loader-side chain to the loader's own stage histograms, adds
    the worker-side chain (measured when a local reader runs in-process:
    the reader's pull is the one measured stage, ``decode``; declared but
    unmeasured for the data service's remote workers, whose cost the
    planner reads through the ``recv_stall_s`` / ``credit_wait_s``
    signals) and binds the knobs the attached objects support:

    - ``workers_count``: when ``loader.reader`` has a resizable pool (a
      thread pool; a process pool or the dummy pool cannot resize);
    - ``host_prefetch``: on the local path (and with ``stage_in_producer``);
      a service source's iterator is pulled by the consumer, so its
      buffering is the source's ready-queue and credits;
    - ``device_prefetch``: always;
    - ``credits``, ``ready_queue_depth`` (only when pinned: a derived depth
      follows ``credits``) and ``transform_placement`` (when a transform
      is armed): when the batch source is a
      :class:`~petastorm_tpu_torch.service.ServiceBatchSource`.

    ``bounds`` overrides per-knob ``(lo, hi)`` tuples. A ``TorchDataLoader``
    always has a batch source (``make_torch_dataloader`` wraps the reader
    in a :class:`ReaderBatchSource`), so remote-ness is decided by what the
    source is, not by whether there is one.
    """
    bounds = dict(bounds or {})
    source = loader._batch_source
    remote = _is_service_source(source)

    def bound(name, lo, hi):
        return bounds.get(name, (lo, hi))

    stage = loader._m_stage
    reader = loader.reader
    nodes = []
    edges = []

    # -- worker side: read → decode → transform → collate → serialize → send.
    # On the local path read, decode, transform and collate all run inside
    # the producer's reader pull: one measured stage ("decode"), attached to
    # the node that times the whole pull. A service worker's series are
    # per-worker and remote: unmeasured here.
    worker_placement = "worker" if remote else "trainer"
    nodes.append(StageNode("read", "worker", worker_placement,
                           description="Parquet row-group read"))
    nodes.append(StageNode(
        "decode", "worker", worker_placement,
        metric=None if remote else _histogram_metric(stage["decode"]),
        description=("reader pull: codec decode (+read/transform/collate "
                     "on the local path — one measured stage)")))
    if _has_transform(source):
        nodes.append(StageNode(
            "transform", "worker", worker_placement if _transform_remote(source) else "trainer",
            flippable=True, metric=_transform_metric,
            placement_fn=lambda: worker_placement if _transform_remote(source) else "trainer",
            description="placement-flippable collated-batch transform"))
    else:
        nodes.append(StageNode("transform", "worker", worker_placement,
                               description="the reader's transform (inside the pull)"))
    nodes.append(StageNode("collate", "worker", worker_placement,
                           description="rows → fixed-size numpy batch"))
    packing_spec = _packing_spec(source)
    if packing_spec is not None:
        # Sequence packing: N row batches into M packed ones. Worker-side
        # it runs before serialization (the cache holds packed frames),
        # trainer-side it packs the received rows; flippable when the
        # source is a PackedBatchSource.
        flippable = _packing_flippable(source)
        nodes.append(StageNode(
            "pack", "worker", worker_placement if _packing_remote(source) else "trainer",
            flippable=flippable, metric=_packing_metric,
            placement_fn=(lambda: worker_placement if _packing_remote(source) else "trainer")
            if flippable else None,
            description=(f"sequence packing into [{packing_spec['slots']}, "
                         f"{packing_spec['slot_len']}] + segment ids")))
    nodes.append(StageNode("serialize", "worker", worker_placement,
                           metric=_fused_stage_metric("serialize") if remote else None,
                           description="batch → wire frames (service path only)"))
    nodes.append(StageNode("send", "worker", worker_placement,
                           description="framed socket send (service path only)"))
    packed = ("pack",) if packing_spec is not None else ()
    chain = ("read", "decode", "transform", "collate") + packed + ("serialize", "send")
    edges += list(zip(chain, chain[1:]))
    if remote:
        # The group these stages run as, one pool task a piece, when stage
        # fusion is on; collate (with the packing wrapper's work when
        # worker-placed packing is fused) and serialize read their share
        # of the fused task from the fused-stage series.
        group = ("decode", "transform", "collate") + packed + ("serialize",)
        for node in nodes:
            if node.name in group:
                node.fuse_group = group
                if node.metric is None and node.name == "collate":
                    node.metric = _fused_stage_metric("collate")

    # -- loader side: recv → queue → raw_stage/device_decode → device_put →
    #    consume
    nodes.append(StageNode(
        "recv", "client", "trainer",
        metric=_histogram_metric(stage["wait"]),
        description="consumer blocked on the next host batch (the stall)"))
    nodes.append(StageNode(
        "queue", "client", "trainer",
        metric=_histogram_metric(stage["queue_wait"]),
        description="producer blocked on a full host queue"))
    nodes.append(StageNode(
        "raw_stage", "client", "trainer",
        metric=_histogram_metric(stage["raw_stage"]),
        description="raw uint8 bytes batch staged to the device (copy enqueued)"))
    device_stage = getattr(loader, "_device_stage", None)
    nodes.append(StageNode(
        "device_decode", "client", "device",
        metric=_histogram_metric(stage["device_decode"]),
        description=("the device stage's crop/flip/cast/normalize on the copy stream"
                     + (f" {device_stage.describe()}"
                        if device_stage is not None else ""))))
    nodes.append(StageNode(
        "device_put", "client", "trainer",
        metric=_histogram_metric(stage["device_put"]),
        description="H2D copies of ordinary tensors (enqueued)"))
    nodes.append(StageNode(
        "consume", "client", "device",
        metric=_histogram_metric(stage["consumer"]),
        description="training step between yields"))
    edges += [("send", "recv"), ("recv", "queue"), ("queue", "raw_stage"),
              ("queue", "device_put"), ("raw_stage", "device_decode"),
              ("device_decode", "consume"), ("device_put", "consume")]

    knobs = []
    pool = getattr(reader, "_workers_pool", None) if reader is not None else None
    if pool is not None and hasattr(pool, "resize") \
            and hasattr(reader, "resize_workers"):
        lo, hi = bound("workers_count", 1, _default_workers_hi())
        knobs.append(Knob(
            "workers_count",
            get=lambda: pool.workers_count,
            set=reader.resize_workers, lo=lo, hi=hi))
    if not remote or loader._stage_in_producer:
        lo, hi = bound("host_prefetch", 1, 64)
        knobs.append(Knob(
            "host_prefetch",
            get=lambda: loader.host_prefetch,
            set=lambda v: setattr(loader, "host_prefetch", v),
            lo=lo, hi=hi))
    lo, hi = bound("device_prefetch", 1, 16)
    knobs.append(Knob(
        "device_prefetch",
        get=lambda: loader.device_prefetch,
        set=lambda v: setattr(loader, "device_prefetch", v), lo=lo, hi=hi))
    if remote and hasattr(source, "set_credits") and getattr(source, "credits", None) is not None:
        lo, hi = bound("credits", 1, 64)
        knobs.append(Knob("credits", get=lambda: source.credits, set=source.set_credits,
                          lo=lo, hi=hi, applies="next-stream"))
    if remote and hasattr(source, "set_ready_queue_depth") \
            and source._ready_queue_depth is not None:
        # Only a pinned depth: a derived one follows the credits knob, and a
        # probe here would pin it for good.
        lo, hi = bound("ready_queue_depth", 2, 256)
        knobs.append(Knob("ready_queue_depth", get=lambda: source.ready_queue_depth,
                          set=source.set_ready_queue_depth, lo=lo, hi=hi))
    if _has_transform(source):
        knobs.append(Knob("transform_placement", get=lambda: source.transform_placement,
                          set=source.set_transform_placement, kind="choice",
                          choices=("remote", "local"), applies="next-iteration"))
    if _packing_flippable(source):
        # Packing between the workers (the cache holds packed frames) and
        # the trainer (the workers serve rows, this host packs).
        knobs.append(Knob("packing_placement", get=lambda: source.packing_placement,
                          set=source.set_packing_placement, kind="choice",
                          choices=("worker", "trainer"), applies="next-iteration"))
    # The graph-rewrite knobs: choice knobs tagged with their rewrite, so the
    # planner gates them on its trigger economics. Never bound on an fcfs
    # source, whose streams bypass the engine the rewrites run in (the graph
    # is built after the source's first call, so its mode is known).
    rewritable = remote and getattr(source, "_mode", None) != "fcfs"
    if rewritable and hasattr(source, "set_stage_fusion"):
        knobs.append(Knob("stage_fusion", get=lambda: source.stage_fusion,
                          set=source.set_stage_fusion, kind="choice",
                          choices=("off", "fused"), applies="next-iteration",
                          rewrite="fuse_worker_stages"))
    if rewritable and getattr(source, "_predicate", None) is not None \
            and hasattr(source, "set_filter_placement") and not _has_transform(source):
        # With a transform the filter is pinned hoisted: nothing to flip.
        knobs.append(Knob("filter_placement", get=lambda: source.filter_placement,
                          set=source.set_filter_placement, kind="choice",
                          choices=("client", "worker"), applies="next-iteration",
                          rewrite="hoist_filter"))
    if rewritable and _has_transform(source) and hasattr(source, "set_cache_placement"):
        knobs.append(Knob("cache_placement", get=lambda: source.cache_placement,
                          set=source.set_cache_placement, kind="choice",
                          choices=("post-transform", "post-decode"),
                          applies="next-iteration", rewrite="cache_placement"))
    if rewritable and hasattr(source, "set_reader_family"):
        # get() says "row" for the unset default: the planner needs a
        # concrete value to revert to.
        knobs.append(Knob("reader_family", get=lambda: source.reader_family or "row",
                          set=source.set_reader_family, kind="choice",
                          choices=("row", "columnar"), applies="next-iteration",
                          rewrite="row_vs_columnar"))

    signals = {
        "rows": lambda: loader._m_rows.value,
        "stall_s": lambda: stage["wait"].sum,
        "queue_wait_s": lambda: stage["queue_wait"].sum,
        "decode_s": lambda: stage["decode"].sum,
        "dispatch_s": lambda: (stage["raw_stage"].sum
                               + stage["device_decode"].sum
                               + stage["device_put"].sum),
        "consumer_s": lambda: stage["consumer"].sum,
    }
    if remote:
        signals["recv_stall_s"] = lambda: _source_recv_stall(source)
        signals["credit_wait_s"] = _process_credit_wait
        # The rewrites' trigger signals. The worker-side series are this
        # process's (in-process fleets); a remote fleet's are not visible
        # here, and a rewrite they trigger then never probes.
        signals["worker_decode_s"] = _process_worker_decode
        signals["handoff_s"] = _process_handoff
        signals["transform_s"] = lambda: _transform_metric()[1]
        signals["cache_hits"] = lambda: _process_cache_counter("hits")
        signals["cache_misses"] = lambda: _process_cache_counter("misses")
        signals["cache_evictions"] = lambda: _process_cache_counter("evictions")
        signals["filter_rows_in"] = lambda: _client_filter_rows("in")
        signals["filter_rows_kept"] = lambda: _client_filter_rows("kept")
    return PipelineGraph(nodes, edges, knobs=knobs, signals=signals)


def _fused_stage_metric(stage):
    """A node metric read from the fused task's per-stage seconds
    (``petastorm_service_worker_fused_stage_seconds_total{stage}``) of the
    workers in this process; zero while unfused or remote."""

    def measure():
        from petastorm_tpu_torch.telemetry.metrics import WORKER_FUSED_STAGE_SECONDS

        child = WORKER_FUSED_STAGE_SECONDS.children().get((stage,))
        return 0, float(child.value) if child is not None else 0.0

    return measure


def _process_worker_decode():
    """Worker decode seconds in this process's registry: the stage work
    the fusion trigger compares the hand-off with."""
    from petastorm_tpu_torch.telemetry.metrics import WORKER_DECODE_SECONDS

    return float(sum(child.sum for child in WORKER_DECODE_SECONDS.children().values()))


def _process_handoff():
    """The stream threads' hand-off seconds (collation and serialization of
    pool outputs) in this process: what stage fusion removes."""
    from petastorm_tpu_torch.telemetry.metrics import WORKER_HANDOFF_SECONDS

    return float(sum(child.value for child in WORKER_HANDOFF_SECONDS.children().values()))


def _process_cache_counter(which):
    """A batch-cache counter summed over its tiers in this process (the
    cache-placement rewrite's signals)."""
    from petastorm_tpu_torch.telemetry.metrics import CACHE_EVICTIONS, CACHE_HITS, CACHE_MISSES

    family = {"hits": CACHE_HITS, "misses": CACHE_MISSES, "evictions": CACHE_EVICTIONS}[which]
    return float(sum(child.value for child in family.children().values()))


def _client_filter_rows(outcome):
    from petastorm_tpu_torch.telemetry.metrics import CLIENT_FILTER_ROWS

    return float(CLIENT_FILTER_ROWS.labels(outcome).value)


def _has_transform(source):
    return source is not None and getattr(source, "transform", None) is not None


def _packing_spec(source):
    """The packing spec's key dict when the source packs (a
    PackedBatchSource, or a ServiceBatchSource with ``packing=``), else
    ``None``."""
    if source is None:
        return None
    spec = getattr(source, "spec", None)
    if spec is not None and hasattr(spec, "key_dict") and hasattr(source, "packing_placement"):
        return spec.key_dict()
    packing = getattr(source, "packing", None)
    return packing.key_dict() if packing is not None and hasattr(packing, "key_dict") else None


def _packing_flippable(source):
    return (source is not None and hasattr(source, "set_packing_placement")
            and _packing_spec(source) is not None)


def _packing_remote(source):
    return getattr(source, "packing_placement", "worker") == "worker"


def _packing_metric():
    """Cumulative ``(count, seconds)`` of the packing stage in both
    placements (the trainer's packer, and the worker series of workers
    running in this process)."""
    from petastorm_tpu_torch.telemetry.metrics import PACKING_SECONDS

    count = total = 0
    for child in PACKING_SECONDS.children().values():
        count += child.count
        total += child.sum
    return count, total


def _transform_remote(source):
    return getattr(source, "transform_placement", "remote") == "remote"


def _transform_metric():
    """Cumulative ``(count, seconds)`` of the batch transform in both
    placements: the client's histogram, and the worker series of workers
    running in this process."""
    from petastorm_tpu_torch.telemetry.metrics import (
        CLIENT_TRANSFORM_SECONDS,
        WORKER_TRANSFORM_SECONDS,
    )

    client = CLIENT_TRANSFORM_SECONDS.labels()
    count, total = client.count, client.sum
    for child in WORKER_TRANSFORM_SECONDS.children().values():
        count += child.count
        total += child.sum
    return count, total


def _source_recv_stall(source):
    """Seconds the client's stream readers spent waiting on their workers."""
    diag = getattr(source, "diagnostics", None)
    if not isinstance(diag, dict):
        return 0.0
    return float(sum(w.get("stall_s", 0.0) for w in diag.get("per_worker", {}).values()))


def _process_credit_wait():
    """Worker credit-wait seconds visible in this process's registry (workers
    running in-process; a remote fleet's are not visible here)."""
    from petastorm_tpu_torch.telemetry.metrics import WORKER_CREDIT_WAIT

    return float(sum(child.value for child in WORKER_CREDIT_WAIT.children().values()))
