"""Deterministic weighted mixture sampling with hot-reloadable weights (the
port's own copy of ``petastorm_tpu/service/mixture.py``).

``weighted_sampling_reader.py`` is the reference's answer to multi-corpus
mixing: an ad-hoc ``random.Random`` draw loop that is nondeterministic by
default (``random_seed=None``), not checkpointable (the RNG state is
implicit in how many draws happened), not subset-stable (remove one corpus
and every later draw changes), and ends by silently propagating a
``StopIteration`` from whichever corpus exhausts first. None of that
survives contact with the service's contracts — byte-identical streams
across kills, resumes, and fleet reshapes.

This module is the service-grade replacement:

- :class:`MixtureSpec` — named corpora with weights; the thing
  ``set_mixture_weights`` rebalances.
- :class:`MixtureSampler` — every draw is a pure function of
  ``(seed, epoch, draw ordinal)`` via the seed-tree fold-in
  (:mod:`petastorm_tpu_torch.service.seedtree`): draw ``i`` lands on the same
  corpus in every run of the same seed and weight log, regardless of
  process, prefetch depth, or what happened to other draws —
  checkpointable by construction (``state_dict`` is a handful of
  ordinals). An explicit seed is REQUIRED; there is no nondeterministic
  default to forget. Exhaustion is a declared policy (``stop`` /
  ``exhaust`` / ``reweight``), not an escaped exception.
- :class:`MixedBatchSource` — the trainer-side composition: one batch
  source per corpus (``ServiceBatchSource`` over per-corpus fleets of one
  dispatcher — workers register with ``corpus=`` names), batches drawn per
  the sampler. Weight changes journaled at the dispatcher
  (``set_mixture_weights``) are fetched and applied at epoch boundaries,
  so the delivered stream is a pure function of
  ``(seed, weight-change log)`` — rebalance the data mix mid-run without
  restarting the fleet, reproducibly (``docs/guides/llm.md``).
"""

from __future__ import annotations

import threading

from petastorm_tpu_torch.service.seedtree import fold_in
from petastorm_tpu_torch.telemetry.log import service_logger
from petastorm_tpu_torch.telemetry.metrics import (
    MIXTURE_DRAWS,
    MIXTURE_EXHAUSTED,
    MIXTURE_WEIGHT,
    MIXTURE_WEIGHT_RELOADS,
)

logger = service_logger(__name__)

_U64 = float(1 << 64)

#: Process-wide count of mixture passes whose iterator is open (for the
#: test suite's leak guard): a pass holds N live per-corpus sources —
#: stream threads, heartbeats, sockets — so abandoning one mid-iteration
#: without ``close()`` leaks a whole fleet's worth of client state.
_OPEN_PASSES_LOCK = threading.Lock()
_OPEN_PASSES = 0


def open_mixture_passes():
    """Live (un-closed, un-exhausted) mixture passes in this process —
    read by the port's tests' resource-leak guard."""
    with _OPEN_PASSES_LOCK:
        return _OPEN_PASSES


def _note_pass(delta):
    global _OPEN_PASSES
    with _OPEN_PASSES_LOCK:
        _OPEN_PASSES += delta

#: Exhaustion policies (what happens when a drawn corpus has no next
#: batch). ``stop``: the mix ends at the first exhausted draw — every
#: corpus contributes its weighted share right up to a clean, deterministic
#: end. ``exhaust``: the exhausted corpus drops out and the draw re-rolls
#: deterministically among survivors (their relative weights preserved);
#: the mix ends when every corpus is dry. ``reweight``: like ``exhaust``,
#: but the drop-out is recorded as an explicit weight-log entry (corpus →
#: 0, applied at that exact draw ordinal) so the full mixing history reads
#: as one weight-change log.
EXHAUSTION_POLICIES = ("stop", "exhaust", "reweight")


class MixtureExhausted(Exception):
    """The mix ended per its exhaustion policy (a clean end-of-stream,
    not an error)."""


class MixtureSpec:
    """Named corpora and their sampling weights.

    :param corpora: ordered ``[{"name", "url", "weight"}, ...]`` (or
        ``(name, url, weight)`` tuples). Names must be unique and
        non-empty; weights non-negative with a positive sum. Order is
        canonical — it is part of the determinism contract (draws walk
        the cumulative weights in this order).
    """

    def __init__(self, corpora):
        entries = []
        for corpus in corpora or ():
            if isinstance(corpus, dict):
                entry = {"name": str(corpus["name"]),
                         "url": corpus.get("url"),
                         "weight": float(corpus["weight"])}
            else:
                name, url, weight = corpus
                entry = {"name": str(name), "url": url,
                         "weight": float(weight)}
            if not entry["name"]:
                raise ValueError("corpus names must be non-empty")
            if entry["weight"] < 0:
                raise ValueError(
                    f"corpus {entry['name']!r} has negative weight "
                    f"{entry['weight']}")
            entries.append(entry)
        if not entries:
            raise ValueError("a mixture needs at least one corpus")
        names = [e["name"] for e in entries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate corpus names: {names}")
        if sum(e["weight"] for e in entries) <= 0:
            raise ValueError("mixture weights must sum to a positive value")
        self.corpora = entries

    @property
    def names(self):
        return [e["name"] for e in self.corpora]

    def weights(self):
        return {e["name"]: e["weight"] for e in self.corpora}

    def to_dict(self):
        return {"corpora": [dict(e) for e in self.corpora]}

    @classmethod
    def from_dict(cls, d):
        if isinstance(d, MixtureSpec):
            return d
        return cls(d["corpora"])


def validate_weights(weights, names=None):
    """Validate a ``{corpus: weight}`` reload payload (shared by the
    dispatcher handler and the trainer helper): non-negative floats with
    a positive sum, and — when ``names`` is given — only known corpora."""
    if not isinstance(weights, dict) or not weights:
        raise ValueError("weights must be a non-empty {corpus: weight} map")
    out = {}
    for name, weight in weights.items():
        weight = float(weight)
        if weight < 0:
            raise ValueError(
                f"weight for corpus {name!r} is negative ({weight})")
        out[str(name)] = weight
    if sum(out.values()) <= 0:
        raise ValueError("weights must sum to a positive value")
    if names is not None:
        unknown = sorted(set(out) - set(names))
        if unknown:
            raise ValueError(
                f"unknown corpora in weights: {unknown} (mixture has "
                f"{sorted(names)})")
    return out


class MixtureSampler:
    """Seed-tree corpus sampler: deterministic, checkpointable, policy-
    aware.

    Draw ``i`` of epoch ``e`` maps to the unit interval via
    ``fold_in(fold_in(fold_in(seed, ("mixture",)), ("epoch", e)),
    ("draw", i))`` and walks the cumulative weights in canonical corpus
    order — a pure function of ``(seed, epoch, ordinal, weights)``. The
    weight map in force may change between draws only through
    :meth:`set_weights` (a journaled reload, applied at a deterministic
    boundary) or the exhaustion policy; both are recorded in
    :meth:`state_dict`'s applied-log, so a resumed sampler replays the
    exact sequence.

    :param seed: REQUIRED explicit seed (``None`` raises — the service's
        determinism lint bans hidden RNG state in the data path).
    :param weights: ``{corpus: weight}`` in canonical order (dict order
        is the draw order).
    :param epoch: the epoch folded into every draw key.
    :param exhaustion: one of :data:`EXHAUSTION_POLICIES`.
    """

    def __init__(self, seed, weights, epoch=0, exhaustion="stop"):
        if seed is None:
            raise ValueError(
                "MixtureSampler requires an explicit seed: deterministic "
                "mixing is the contract (an unseeded mix cannot be "
                "checkpointed, resumed, or reproduced — see "
                "docs/guides/llm.md#mixtures)")
        if exhaustion not in EXHAUSTION_POLICIES:
            raise ValueError(
                f"exhaustion must be one of {EXHAUSTION_POLICIES}, got "
                f"{exhaustion!r}")
        self.seed = int(seed)
        self.exhaustion = exhaustion
        self._names = [str(n) for n in weights]
        self._weights = validate_weights(dict(weights), self._names)
        self._epoch = int(epoch)
        self._epoch_key = fold_in(fold_in(self.seed, ("mixture",)),
                                  ("epoch", self._epoch))
        self._ordinal = 0
        self._exhausted = set()
        self._draw_counts = {n: 0 for n in self._names}
        #: applied weight-change events: (ordinal, {corpus: weight}, why)
        self._applied = []
        for name in self._names:
            MIXTURE_WEIGHT.labels(name).set(self._weights[name])

    # -- draws ------------------------------------------------------------

    @property
    def ordinal(self):
        """The next draw's ordinal."""
        return self._ordinal

    @property
    def epoch(self):
        return self._epoch

    def weights(self):
        return dict(self._weights)

    def live_names(self):
        return [n for n in self._names if n not in self._exhausted
                and self._weights[n] > 0]

    def _pick(self, key):
        names = self.live_names()
        if not names:
            raise MixtureExhausted("every corpus is exhausted")
        total = sum(self._weights[n] for n in names)
        u = (key / _U64) * total
        acc = 0.0
        for name in names:
            acc += self._weights[name]
            if u < acc:
                return name
        return names[-1]  # fp rounding guard at the top of the interval

    def draw(self):
        """The corpus of the next draw; advances the ordinal. Raises
        :class:`MixtureExhausted` when the policy says the mix is over."""
        if not self.live_names():
            raise MixtureExhausted("every corpus is exhausted")
        key = fold_in(self._epoch_key, ("draw", self._ordinal))
        name = self._pick(key)
        self._ordinal += 1
        self._draw_counts[name] += 1
        MIXTURE_DRAWS.labels(name).inc()
        return name

    def mark_exhausted(self, name):
        """The named corpus has no next batch. Applies the exhaustion
        policy; returns the corpus to RE-DRAW from for this same slot
        (``exhaust``/``reweight``), or raises :class:`MixtureExhausted`
        (``stop``, or nothing left). The re-draw derives from the
        original draw's key with a retry fold-in — deterministic, and no
        new ordinal is consumed."""
        name = str(name)
        if name not in self._names:
            raise ValueError(f"unknown corpus {name!r}")
        if name not in self._exhausted:
            self._exhausted.add(name)
            MIXTURE_EXHAUSTED.labels(name).inc()
            logger.info("mixture: corpus %r exhausted at draw %d "
                        "(policy=%s)", name, self._ordinal - 1,
                        self.exhaustion)
        if self.exhaustion == "stop":
            raise MixtureExhausted(
                f"corpus {name!r} exhausted at draw {self._ordinal - 1} "
                f"(policy 'stop' ends the mix at the first exhaustion)")
        if self.exhaustion == "reweight":
            new_weights = dict(self._weights)
            new_weights[name] = 0.0
            if any(w > 0 for w in new_weights.values()):
                self._record_weights(new_weights, why=f"exhausted:{name}")
            else:
                # The LAST live corpus drained: there is nothing left to
                # reweight toward — this is the clean end of the mix,
                # not an invalid weight map.
                raise MixtureExhausted("every corpus is exhausted")
        if not self.live_names():
            raise MixtureExhausted("every corpus is exhausted")
        # Deterministic re-roll of the SAME slot: retry indices fold into
        # the failed draw's key, so the substitution is reproducible.
        base = fold_in(self._epoch_key, ("draw", self._ordinal - 1))
        for attempt in range(1, len(self._names) + 2):
            candidate = self._pick(fold_in(base, ("retry", attempt)))
            if candidate not in self._exhausted:
                self._draw_counts[candidate] += 1
                MIXTURE_DRAWS.labels(candidate).inc()
                return candidate
        # _pick over live_names() cannot return an exhausted corpus; the
        # loop bound is sheer paranoia.
        raise MixtureExhausted("every corpus is exhausted")

    # -- weight changes ----------------------------------------------------

    def _record_weights(self, weights, why):
        self._weights = validate_weights(weights, self._names)
        self._applied.append((self._ordinal, dict(self._weights), why))
        for name in self._names:
            MIXTURE_WEIGHT.labels(name).set(self._weights[name])

    def set_weights(self, weights, why="reload"):
        """Apply a weight change at the CURRENT draw boundary (callers —
        :class:`MixedBatchSource` — invoke this only at deterministic
        boundaries; the applied-log records the exact ordinal so a
        resume replays it)."""
        self._record_weights(weights, why)
        MIXTURE_WEIGHT_RELOADS.inc()
        logger.info("mixture: weights now %s (at draw %d, %s)",
                    self._weights, self._ordinal, why)

    # -- checkpointing -----------------------------------------------------

    def state_dict(self):
        return {
            "version": 1,
            "seed": self.seed,
            "epoch": self._epoch,
            "exhaustion": self.exhaustion,
            "names": list(self._names),
            "weights": dict(self._weights),
            "ordinal": self._ordinal,
            "exhausted": sorted(self._exhausted),
            "draw_counts": dict(self._draw_counts),
            "applied": [[o, dict(w), why] for o, w, why in self._applied],
        }

    def load_state_dict(self, state):
        if state.get("version") != 1:
            raise ValueError(
                f"unsupported sampler state version "
                f"{state.get('version')!r}")
        if int(state["seed"]) != self.seed:
            raise ValueError(
                f"sampler state was saved under seed {state['seed']!r}; "
                f"this sampler runs {self.seed!r}")
        if list(state["names"]) != self._names:
            raise ValueError(
                f"sampler state names {state['names']} != {self._names} "
                f"(corpus order is part of the determinism contract)")
        self._epoch = int(state["epoch"])
        self._epoch_key = fold_in(fold_in(self.seed, ("mixture",)),
                                  ("epoch", self._epoch))
        self._weights = validate_weights(state["weights"], self._names)
        self._ordinal = int(state["ordinal"])
        self._exhausted = set(state.get("exhausted") or ())
        self._draw_counts = {n: int(state["draw_counts"].get(n, 0))
                             for n in self._names}
        self._applied = [(int(o), dict(w), why)
                         for o, w, why in state.get("applied") or ()]
        for name in self._names:
            MIXTURE_WEIGHT.labels(name).set(self._weights[name])


def set_mixture_weights(dispatcher_address, weights, job_id="default",
                        effective_epoch=None, rpc_deadline_s=30.0):
    """Journal a mixture weight change at the dispatcher — the hot-reload
    lever: every :class:`MixedBatchSource` of ``job_id`` applies it at
    the ``effective_epoch`` boundary (default: the next epoch any source
    starts after the change lands), WITHOUT restarting the fleet or the
    trainer. The change is a WAL op: a dispatcher restart replays it
    byte-identically, so the served mix remains a pure function of
    ``(seed, weight-change log)``.

    Returns the dispatcher's reply (carries the change's ``seq`` and the
    job's full weight log).
    """
    import uuid

    from petastorm_tpu_torch.service.fleet import _job_rpc

    payload = validate_weights(weights)
    header = {"type": "set_mixture_weights", "job_id": str(job_id),
              "weights": payload,
              # Per-request idempotency id: a retry after a dropped reply
              # answers for the already-journaled entry instead of
              # appending a duplicate weight change.
              "token": uuid.uuid4().hex}
    if effective_epoch is not None:
        header["effective_epoch"] = int(effective_epoch)
    return _job_rpc(dispatcher_address, header,
                    rpc_deadline_s=rpc_deadline_s)


def get_mixture_weights(dispatcher_address, job_id="default",
                        rpc_deadline_s=30.0):
    """Fetch the job's journaled weight-change log (``entries`` +
    ``seq``)."""
    from petastorm_tpu_torch.service.fleet import _job_rpc

    return _job_rpc(dispatcher_address,
                    {"type": "get_mixture", "job_id": str(job_id)},
                    rpc_deadline_s=rpc_deadline_s)


def _call_factory(factory, epoch):
    """Invoke a per-pass source factory with the pass index when its
    signature takes one (decided by inspection, NOT by catching
    TypeError — a genuine TypeError inside the factory must surface as
    itself, and the factory must never run twice)."""
    import inspect

    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):  # builtins, C callables
        params = {}
    takes_arg = any(
        p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                   inspect.Parameter.POSITIONAL_OR_KEYWORD,
                   inspect.Parameter.VAR_POSITIONAL)
        for p in params.values())
    return factory(epoch) if takes_arg else factory()


class _MixtureIterator:
    """Iterator shell carrying the batch-source ``prefetched`` marker.
    ``close()`` always runs the pass's cleanup — even when the generator
    was never started (a bare ``gen.close()`` would skip its
    ``finally``, leaking every per-corpus inner iterator)."""

    def __init__(self, gen, prefetched, cleanup):
        self._gen = gen
        self._cleanup = cleanup
        self.prefetched = prefetched

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        try:
            self._gen.close()
        finally:
            self._cleanup()


class MixedBatchSource:
    """Deterministic multi-corpus batch source with hot-reloadable
    weights.

    :param sources: ordered ``{corpus_name: batch_source}`` — one source
        per corpus (typically :class:`~petastorm_tpu_torch.service.client.
        ServiceBatchSource` instances sharing one dispatcher, each with
        ``corpus=`` naming its registered worker group). Dict order is
        the canonical corpus order. With ``factories=True`` the values
        are zero-arg (or ``pass_index``-arg) callables returning a FRESH
        source per pass — required for multi-pass mixing over service
        sources, whose ``num_epochs`` budget one pass consumes.
    :param weights: initial ``{corpus_name: weight}``.
    :param seed: REQUIRED mixture seed (independent of the dispatcher's
        shuffle seed; fold both from one run seed if you want a single
        knob).
    :param exhaustion: :data:`EXHAUSTION_POLICIES` member.
    :param dispatcher_address: arm hot reloads — each pass start fetches
        the job's journaled weight log and applies entries whose
        ``effective_epoch`` has arrived. ``None`` = static weights.
    :param job_id: the job whose weight log to follow.

    Each ``__call__`` is one mixture *pass* (epoch): every inner source
    is opened once and batches are drawn per the sampler until the
    exhaustion policy ends the pass. ``state_dict(yielded_batches=n)``
    resolves the consumer's true position to per-corpus inner positions
    plus the sampler's ordinal — resume by rebuilding the inner sources
    with their ``resume_state`` slices and passing the snapshot back as
    ``resume_state=``.
    """

    def __init__(self, sources, weights, seed, exhaustion="stop",
                 dispatcher_address=None, job_id="default",
                 resume_state=None, factories=False):
        if not sources:
            raise ValueError("a mixture needs at least one source")
        self._factories = bool(factories)
        if self._factories:
            self._source_factories = dict(sources)
            self._sources = {}
        else:
            self._source_factories = None
            self._sources = dict(sources)
        self._names = list(sources)
        self._weights = validate_weights(dict(weights), self._names)
        if seed is None:
            raise ValueError(
                "MixedBatchSource requires an explicit seed (see "
                "MixtureSampler)")
        self.seed = int(seed)
        if exhaustion not in EXHAUSTION_POLICIES:
            raise ValueError(
                f"exhaustion must be one of {EXHAUSTION_POLICIES}, got "
                f"{exhaustion!r}")
        self.exhaustion = exhaustion
        self._dispatcher_address = (tuple(dispatcher_address)
                                    if dispatcher_address else None)
        self.job_id = str(job_id)
        self._lock = threading.Lock()
        self._pass_index = 0
        self._applied_seq = 0      # highest weight-log seq applied
        self._pending_entries = []
        self._draw_log = []        # corpus name per yielded batch (pass)
        self._yielded = 0          # yields this pass
        #: Exact sampler snapshots keyed by yield count (bounded ring):
        #: a state_dict(yielded_batches=n) taken while the producer is
        #: mid-draw for batch n+1 must restore the sampler AS OF yield n
        #: — ordinal, exhaustion set, and applied weights included —
        #: never a live view racing the next draw.
        self._sampler_ring = []
        self._sampler_ring_depth = 256
        self._pass_live = set(self._names)
        self._sampler = None
        self._resume = None
        if resume_state is not None:
            if resume_state.get("kind") != "mixture_v1":
                raise ValueError(
                    f"resume_state is not a MixedBatchSource snapshot "
                    f"(kind={resume_state.get('kind')!r})")
            if list(resume_state["names"]) != self._names:
                raise ValueError(
                    f"resume_state corpora {resume_state['names']} != "
                    f"{self._names}")
            self._resume = resume_state
            self._pass_index = int(resume_state["pass"])
            self._applied_seq = int(resume_state.get("applied_seq", 0))
            # Carry the weights in force at the snapshot (reloads the
            # original run had applied are NOT pending — their seqs are
            # below applied_seq — so they must ride the snapshot).
            if resume_state.get("weights"):
                self._weights = validate_weights(
                    dict(resume_state["weights"]), self._names)

    # -- hot reload --------------------------------------------------------

    def refresh_weights(self):
        """Fetch the dispatcher's journaled weight log; stage unapplied
        entries. Called automatically at each pass start; harmless to
        call any time (entries only ever APPLY at pass boundaries, so
        the stream stays a pure function of the log)."""
        if self._dispatcher_address is None:
            return
        reply = get_mixture_weights(self._dispatcher_address, self.job_id)
        with self._lock:
            for entry in reply.get("entries", ()):
                if int(entry["seq"]) > self._applied_seq and not any(
                        int(entry["seq"]) == int(e["seq"])
                        for e in self._pending_entries):
                    self._pending_entries.append(dict(entry))
            self._pending_entries.sort(key=lambda e: int(e["seq"]))

    def _apply_due_entries(self, sampler):
        """Apply staged entries whose effective epoch has arrived — the
        deterministic boundary: entry N applies at the START of pass
        ``effective_epoch`` (or the first pass to start after it
        landed), before any draw of that pass.

        A malformed journaled entry (an operator typo naming an unknown
        corpus — the dispatcher cannot validate names, it has no corpus
        list for the job) must never wedge training: unknown corpora are
        dropped with a loud warning, and an entry with nothing usable
        left is skipped — its seq still advances so a later corrected
        entry is reachable."""
        with self._lock:
            due = [e for e in self._pending_entries
                   if int(e.get("effective_epoch", -1)) <= self._pass_index]
            self._pending_entries = [
                e for e in self._pending_entries if e not in due]
        for entry in due:
            seq = int(entry["seq"])
            self._applied_seq = max(self._applied_seq, seq)
            raw = dict(entry["weights"])
            unknown = sorted(set(raw) - set(self._names))
            if unknown:
                logger.warning(
                    "mixture: weight-log entry seq=%d names unknown "
                    "corpora %s (mixture has %s) — dropping them; fix "
                    "with a corrected set_mixture_weights", seq, unknown,
                    self._names)
                raw = {k: v for k, v in raw.items() if k in self._names}
            merged = dict(sampler.weights())
            merged.update(raw)
            try:
                validate_weights(merged, self._names)
            except ValueError as exc:
                logger.warning(
                    "mixture: skipping unusable weight-log entry seq=%d "
                    "(%s) — weights unchanged", seq, exc)
                continue
            sampler.set_weights(merged, why=f"reload:seq={seq}")
            self._weights = dict(merged)

    # -- the batch_source contract ----------------------------------------

    def __call__(self):
        self.refresh_weights()
        epoch = self._pass_index
        sampler = MixtureSampler(self.seed, dict(self._weights),
                                 epoch=epoch, exhaustion=self.exhaustion)
        resume, self._resume = self._resume, None
        if resume is not None and resume.get("sampler") is not None:
            sampler.load_state_dict(resume["sampler"])
        self._sampler = sampler
        if resume is None:
            # Pass-START boundary: apply due weight entries. A mid-pass
            # RESUME must not — the restored sampler already carries
            # everything the uninterrupted run had applied at this
            # pass's start, and applying a newly-staged entry here would
            # change the remaining draws of a pass the uninterrupted run
            # finishes under the old weights (the resumed stream must
            # stay byte-identical to it). Staged entries apply at the
            # next pass boundary, exactly like the uninterrupted run.
            self._apply_due_entries(sampler)
        with self._lock:
            self._sampler_ring = [(0, sampler.state_dict())]
        # Corpora with no live weight (reloaded to 0, reweight-policy
        # drop-outs, already exhausted) can never be drawn this pass:
        # skip opening their sources entirely — each one is a fleet's
        # worth of streams, heartbeats, and reader construction.
        live = set(sampler.live_names())
        skipped = [n for n in self._names if n not in live]
        if skipped:
            logger.info("mixture: not opening zero-weight/exhausted "
                        "corpora %s this pass", sorted(skipped))
        if self._factories:
            built = {}
            for name in self._names:
                if name not in live:
                    continue
                built[name] = _call_factory(
                    self._source_factories[name], epoch)
            self._sources = built
        self._pass_live = live
        iters = {name: iter(self._sources[name]())
                 for name in self._names if name in live}
        prefetched = all(bool(getattr(it, "prefetched", False))
                         for it in iters.values())
        self._draw_log = []
        self._yielded = 0
        _note_pass(1)
        done = [False]

        def cleanup():
            if done[0]:
                return
            done[0] = True
            _note_pass(-1)
            self._pass_index += 1
            for it in iters.values():
                close = getattr(it, "close", None)
                if callable(close):
                    close()

        return _MixtureIterator(self._mix(sampler, iters, cleanup),
                                prefetched, cleanup)

    def _mix(self, sampler, iters, cleanup):
        try:
            while True:
                try:
                    name = sampler.draw()
                except MixtureExhausted:
                    return
                while True:
                    try:
                        batch = next(iters[name])
                        break
                    except StopIteration:
                        try:
                            name = sampler.mark_exhausted(name)
                        except MixtureExhausted:
                            return
                with self._lock:
                    self._draw_log.append(name)
                    self._yielded += 1
                    self._sampler_ring.append(
                        (self._yielded, sampler.state_dict()))
                    while len(self._sampler_ring) > \
                            self._sampler_ring_depth:
                        self._sampler_ring.pop(0)
                yield batch
        finally:
            cleanup()

    # -- checkpointing -----------------------------------------------------

    def state_dict(self, yielded_batches=None):
        """Resumable position at the consumer's true batch count: the
        sampler snapshot plus each inner source's ``state_dict`` taken
        at that corpus's batch count among the first ``n`` yields."""
        sampler = self._sampler
        if sampler is None:
            raise ValueError(
                "state_dict before the first iteration has no position — "
                "start iterating first")
        with self._lock:
            n = (self._yielded if yielded_batches is None
                 else min(int(yielded_batches), self._yielded))
            log = list(self._draw_log[:n])
            # The exact sampler snapshot AS OF yield n (captured
            # atomically with the yield): a live sampler view could be
            # mid-draw for n+1, or carry an exhaustion/reweight event
            # the consumer has not reached.
            sampler_state = None
            for count, snap in self._sampler_ring:
                if count == n:
                    sampler_state = dict(snap)
                    break
            if sampler_state is None:
                raise ValueError(
                    f"no sampler snapshot at yield {n} (the ring keeps "
                    f"{self._sampler_ring_depth}; the consumer's "
                    f"prefetch lag exceeded it)")
        per_corpus = {name: 0 for name in self._names}
        for name in log:
            per_corpus[name] += 1
        inner = {}
        for name, source in self._sources.items():
            if name not in self._pass_live:
                # Never opened this pass (zero weight / exhausted): no
                # position to record — a resume rebuilds it fresh if a
                # reload revives it.
                continue
            state_fn = getattr(source, "state_dict", None)
            if callable(state_fn):
                try:
                    inner[name] = state_fn(
                        yielded_batches=per_corpus[name])
                except TypeError:
                    inner[name] = state_fn()
        return {
            "kind": "mixture_v1",
            "pass": self._pass_index,
            "names": list(self._names),
            "weights": dict(self._weights),
            "applied_seq": self._applied_seq,
            "sampler": sampler_state,
            "per_corpus_batches": per_corpus,
            "inner": inner,
        }

    @property
    def diagnostics(self):
        with self._lock:
            counts = {}
            for name in self._draw_log:
                counts[name] = counts.get(name, 0) + 1
        out = {"mixture": {"weights": dict(self._weights),
                           "pass": self._pass_index,
                           "applied_seq": self._applied_seq,
                           "draws": counts}}
        for name, source in self._sources.items():
            diag = getattr(source, "diagnostics", None)
            if isinstance(diag, dict):
                out.setdefault("per_corpus", {})[name] = diag
        return out
