"""The fleet: multi-tenant jobs, fair shares and the autoscaler (the port's
own copy of ``petastorm_tpu/service/fleet.py``).

One data service feeds many training jobs from one pool of workers. The
pure pieces:

- :func:`plan_fair_shares`: weighted max-min (water-filling) allocation of
  the serving capacity across jobs from their weights and quotas. The
  dispatcher turns the shares into per-job ``credit_scale`` factors
  (:func:`credit_scales`): a job's streams open with their flow-control
  window scaled by its share. One job, or equal weights, gives 1.0 to
  every job: the single-tenant behaviour.
- :class:`AutoscalePlanner`: the admit / drain / retire planner over one
  ``Dispatcher.fleet_signals()`` snapshot, with streak hysteresis and a
  cooldown after each decision.

:class:`AutoscaleController` is the dispatcher's thread (its name starts
with ``fleet-autoscale``) that runs a planner each interval and applies
its decisions through the dispatcher's journaled mutations. The trainer
side registers jobs with :func:`register_job` / :func:`end_job` (or
:class:`JobHandle`); every open registration is tracked per process
(:func:`open_job_registrations`), so a test that leaves one open fails.

Imports neither torch nor JAX: a worker host loads it.
"""

from __future__ import annotations

import logging
import threading

logger = logging.getLogger(__name__)

#: The job of every client that names none; it needs no registration and
#: is not tracked by the open-registration guard.
DEFAULT_JOB = "default"

#: The worker lifecycle states: ``serving`` workers receive grants,
#: ``standby`` workers are registered pool capacity awaiting admission,
#: ``draining`` workers finish what they were granted and receive nothing
#: new until the autoscaler retires them to standby.
WORKER_STATES = ("serving", "standby", "draining")


def plan_fair_shares(capacity, demands, weights=None, quotas=None):
    """Weighted max-min fair allocation of ``capacity`` across jobs.

    Water-filling: the capacity is poured across the jobs in proportion to
    their weights; a job whose demand (or quota) is met drops out and its
    unused share is poured over the rest, so no job is starved below its
    weighted share and no capacity idles while a job still wants some.
    Pure; the jobs iterate sorted.

    :param capacity: the capacity to allocate (the dispatcher uses the
        serving-worker count).
    :param demands: ``{job: demand}``; a job never receives more.
    :param weights: ``{job: weight}`` (1.0 by default).
    :param quotas: ``{job: cap}`` optional hard caps in the capacity's unit.
    :returns: ``{job: allocation}``, summing to at most ``capacity``, each
        at most ``min(demand, quota)``.
    """
    weights = dict(weights or {})
    quotas = dict(quotas or {})
    jobs = sorted(demands)
    limit = {}
    for job in jobs:
        cap = float(demands[job])
        if quotas.get(job) is not None:
            cap = min(cap, float(quotas[job]))
        limit[job] = max(0.0, cap)
    alloc = {job: 0.0 for job in jobs}
    active = [job for job in jobs if limit[job] > 0]
    remaining = float(capacity)
    while active and remaining > 1e-12:
        wsum = sum(weights.get(job, 1.0) for job in active)
        unit = remaining / wsum
        capped = [job for job in active
                  if limit[job] - alloc[job] <= unit * weights.get(job, 1.0) + 1e-12]
        if not capped:
            for job in active:
                alloc[job] += unit * weights.get(job, 1.0)
            break
        for job in capped:
            remaining -= limit[job] - alloc[job]
            alloc[job] = limit[job]
        active = [job for job in active if job not in capped]
    return alloc


def credit_scales(shares, brownout_level=0, brownout_factor=0.5):
    """Fair shares → per-job flow-control scale factors in ``(0, 1]``.

    The largest share maps to 1.0 (its job keeps the full credit window),
    every other in proportion; equal shares give 1.0 to all. Under brownout
    (``brownout_level >= 1``) each job below the top share is further
    scaled by ``brownout_factor ** level``, applied to this pure output and
    never accumulated, so recovery restores the exact earlier scales. The
    floor is 1e-3.
    """
    top = max(shares.values(), default=0.0)
    if top <= 0:
        return {job: 1.0 for job in shares}
    shed = float(brownout_factor) ** max(0, int(brownout_level))
    return {job: max((share / top) * (1.0 if share >= top else shed), 1e-3)
            for job, share in shares.items()}


class AutoscaleConfig:
    """The autoscaler's knobs (windows count controller ticks).

    :param interval_s: the controller's tick.
    :param scale_up_backlog: admit a standby worker once the mean backlog
        per serving worker has exceeded this for ``up_windows`` ticks.
    :param scale_down_backlog: drain the least-loaded serving worker once
        the mean backlog has been below this for ``down_windows`` ticks.
    :param up_windows, down_windows: the hysteresis streaks.
    :param cooldown_windows: ticks after an admit or drain in which no other
        admit or drain is planned (retires still happen).
    :param min_serving: never drain below this many serving workers.
    :param planner: ``"streak"`` (:class:`AutoscalePlanner`) or ``"model"``
        (:class:`~petastorm_tpu_torch.service.fleet_model.ModelPlanner`:
        decisions from a fitted throughput model, checked by what-if replay
        and journaled as ``fleet_plan`` records).
    """

    def __init__(self, interval_s=1.0, scale_up_backlog=4.0, scale_down_backlog=0.5,
                 up_windows=2, down_windows=3, cooldown_windows=2, min_serving=1,
                 planner="streak"):
        if min_serving < 1:
            raise ValueError("min_serving must be >= 1")
        if scale_down_backlog >= scale_up_backlog:
            raise ValueError(
                "scale_down_backlog must be < scale_up_backlog (equal/inverted thresholds "
                "would flap admit against drain on every window)")
        if planner not in ("streak", "model"):
            raise ValueError(f"planner must be 'streak' or 'model', got {planner!r}")
        self.interval_s = float(interval_s)
        self.scale_up_backlog = float(scale_up_backlog)
        self.scale_down_backlog = float(scale_down_backlog)
        self.up_windows = int(up_windows)
        self.down_windows = int(down_windows)
        self.cooldown_windows = int(cooldown_windows)
        self.min_serving = int(min_serving)
        self.planner = str(planner)

    @classmethod
    def coerce(cls, value):
        """``True``, a dict of arguments or a config → an :class:`AutoscaleConfig`."""
        if isinstance(value, cls):
            return value
        if value is True:
            return cls()
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"autoscale must be True, a dict of AutoscaleConfig kwargs, or an "
                        f"AutoscaleConfig — got {value!r}")


class AutoscalePlanner:
    """The pure admit / drain / retire planner.

    ``plan(signals)`` takes the dict ``Dispatcher.fleet_signals()`` returns
    (``serving``, ``standby``, ``draining`` worker lists, ``backlog``
    ``{wid: pending pieces}``, ``backlog_known``, ``rates``) and returns
    ``[{"action", "worker_id", "reason"}, ...]``. Its only state is the
    hysteresis streaks and the cooldown. In order:

    - **retire**: a draining worker with no backlog goes back to standby;
    - no serving worker at all: admit the first draining or standby worker
      at once (before the cooldown and without a backlog signal);
    - ``backlog_known=False`` (static and fcfs track no per-worker
      progress): retires only;
    - **admit**: mean backlog per serving worker above ``scale_up_backlog``
      for ``up_windows`` windows with a draining or standby worker: the
      first of them, a draining one first (it is warm);
    - **drain**: mean backlog below ``scale_down_backlog`` for
      ``down_windows`` windows with more than ``min_serving`` serving: the
      least backlogged serving worker, ties to the lowest delivery rate,
      then the id;
    - a window that meets neither trigger resets both streaks; an admit or
      drain starts ``cooldown_windows`` windows in which neither counts.
    """

    def __init__(self, config=None):
        self.config = config or AutoscaleConfig()
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0

    def plan(self, signals):
        cfg = self.config
        serving = sorted(signals.get("serving") or [])
        standby = sorted(signals.get("standby") or [])
        draining = sorted(signals.get("draining") or [])
        backlog = dict(signals.get("backlog") or {})
        decisions = [{"action": "retire", "worker_id": wid,
                      "reason": "drain complete (backlog 0)"}
                     for wid in draining if not backlog.get(wid, 0)]
        if not serving:
            pool = draining + standby
            if pool:
                decisions.append({"action": "admit", "worker_id": pool[0],
                                  "reason": "no serving workers"})
                self._cooldown = cfg.cooldown_windows
            return decisions
        if not signals.get("backlog_known", True):
            return decisions
        if self._cooldown > 0:
            self._cooldown -= 1
            return decisions
        rates = dict(signals.get("rates") or {})
        mean_backlog = sum(backlog.get(wid, 0) for wid in serving) / len(serving)
        if mean_backlog > cfg.scale_up_backlog and (standby or draining):
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= cfg.up_windows:
                decisions.append({
                    "action": "admit", "worker_id": (draining + standby)[0],
                    "reason": (f"backlog {mean_backlog:.1f}/worker > "
                               f"{cfg.scale_up_backlog:g} for {self._up_streak} windows")})
                self._up_streak = 0
                self._cooldown = cfg.cooldown_windows
        elif mean_backlog < cfg.scale_down_backlog and len(serving) > cfg.min_serving:
            self._down_streak += 1
            self._up_streak = 0
            if self._down_streak >= cfg.down_windows:
                victim = min(serving,
                             key=lambda wid: (backlog.get(wid, 0), rates.get(wid, 0.0), wid))
                decisions.append({
                    "action": "drain", "worker_id": victim,
                    "reason": (f"backlog {mean_backlog:.1f}/worker < "
                               f"{cfg.scale_down_backlog:g} for {self._down_streak} windows")})
                self._down_streak = 0
                self._cooldown = cfg.cooldown_windows
        else:
            self._up_streak = 0
            self._down_streak = 0
        return decisions


class AutoscaleController:
    """The dispatcher's autoscaler thread: each tick takes
    ``Dispatcher.fleet_signals()``, runs the planner and applies each
    decision through ``Dispatcher.apply_autoscale`` (journaled, so a
    restarted dispatcher replays the fleet's history). A model-planner
    decision is journaled as a ``fleet_plan`` record first. The thread's
    name starts with ``fleet-autoscale``, which the test suite's leak guard
    watches."""

    def __init__(self, dispatcher, config=None):
        self._dispatcher = dispatcher
        config = config or AutoscaleConfig()
        if getattr(config, "planner", "streak") == "model":
            from petastorm_tpu_torch.service.fleet_model import ModelPlanner

            self.planner = ModelPlanner(config)
        else:
            self.planner = AutoscalePlanner(config)
        self._config = config
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-autoscale-controller")
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def tick(self):
        """One planning round (the test seam: no clock involved)."""
        signals = self._dispatcher.fleet_signals()
        decisions = self.planner.plan(signals)
        for decision in decisions:
            if "model" in decision:
                # Cause before effect in the journal.
                self._dispatcher.record_fleet_plan(decision)
            self._dispatcher.apply_autoscale(decision["action"], decision["worker_id"],
                                             reason=decision.get("reason"))
        self._sync_model_gauges(signals)
        return decisions

    def _sync_model_gauges(self, signals):
        """Export the model planner's latest fit (nothing under streak)."""
        model = getattr(self.planner, "last_model", None)
        if model is None:
            return
        from petastorm_tpu_torch.telemetry.metrics import (
            FLEET_MODEL_PREDICTED_ROWS,
            FLEET_MODEL_WHATIF_ERROR,
        )

        FLEET_MODEL_PREDICTED_ROWS.set(model.predict(len(signals.get("serving", ()))))
        error = getattr(self.planner, "last_whatif_error", None)
        if error is not None:
            FLEET_MODEL_WHATIF_ERROR.set(100.0 * error)

    def _run(self):
        while not self._stop.wait(self._config.interval_s):
            try:
                self.tick()
            except Exception:
                # The next tick plans again (the dispatcher may be stopping).
                logger.exception("autoscale tick failed")


# -- the trainer's job API ------------------------------------------------------

#: ``(address, job_id)`` of this process's registrations not yet ended.
_OPEN_JOBS = set()
_OPEN_JOBS_LOCK = threading.Lock()


def open_job_registrations():
    """This process's job registrations not yet ended (the tests' leak
    guard reads it around each test)."""
    with _OPEN_JOBS_LOCK:
        return set(_OPEN_JOBS)


def _job_rpc(dispatcher_address, header, rpc_deadline_s=30.0):
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
    from petastorm_tpu_torch.service.client import ServiceError
    from petastorm_tpu_torch.utils import retry_with_backoff

    def once():
        with FramedConnection.connect(tuple(dispatcher_address), timeout=10.0) as conn:
            reply, _ = conn.request(header)
        if reply.get("type") == "error":
            raise ServiceError(reply.get("error", "dispatcher error"))
        return reply

    return retry_with_backoff(once, retries=3, base_delay=0.1, retry_on=(OSError,),
                              no_retry_on=(ServiceError,), deadline_s=rpc_deadline_s,
                              description=f"job request {header.get('type')!r}")


def register_job(dispatcher_address, job_id, weight=1.0, quota=None, rpc_deadline_s=30.0):
    """Register a trainer job with the dispatcher.

    :param job_id: the job's identity; every
        :class:`~petastorm_tpu_torch.service.client.ServiceBatchSource` of
        the trainer passes the same ``job_id=``.
    :param weight: its fair-share weight (:func:`plan_fair_shares`).
    :param quota: an optional cap on its share, in serving workers.
    :returns: the dispatcher's reply (with the job's ``fencing_epoch``).

    Registering a live job again restarts it: its own fencing epoch bumps,
    so its stale clients resync, and no other job's moves. Pair it with
    :func:`end_job` (or use :class:`JobHandle`).
    """
    reply = _job_rpc(dispatcher_address,
                     {"type": "register_job", "job_id": str(job_id), "weight": float(weight),
                      "quota": float(quota) if quota is not None else None},
                     rpc_deadline_s=rpc_deadline_s)
    with _OPEN_JOBS_LOCK:
        _OPEN_JOBS.add((tuple(dispatcher_address), str(job_id)))
    return reply


def end_job(dispatcher_address, job_id, rpc_deadline_s=30.0):
    """End a job: the dispatcher releases its clients, piece books and
    quota, and journals it. Ending an unknown job is a no-op; an unreachable
    dispatcher is logged and ``None`` returned, so a ``JobHandle`` exit
    never masks the body's own exception."""
    with _OPEN_JOBS_LOCK:
        _OPEN_JOBS.discard((tuple(dispatcher_address), str(job_id)))
    try:
        return _job_rpc(dispatcher_address, {"type": "end_job", "job_id": str(job_id)},
                        rpc_deadline_s=rpc_deadline_s)
    except OSError as exc:
        logger.warning("end_job(%r) could not reach the dispatcher at %s (%s) — nothing left "
                       "to release", job_id, tuple(dispatcher_address), exc)
        return None


class JobHandle:
    """A job registration as a context manager::

        with JobHandle(dispatcher.address, "exp-17", weight=2.0):
            source = ServiceBatchSource(dispatcher.address, job_id="exp-17")
            ...

    The exit ends the job, on error too."""

    def __init__(self, dispatcher_address, job_id, weight=1.0, quota=None):
        self.dispatcher_address = tuple(dispatcher_address)
        self.job_id = str(job_id)
        self.weight = weight
        self.quota = quota

    def __enter__(self):
        register_job(self.dispatcher_address, self.job_id, weight=self.weight,
                     quota=self.quota)
        return self

    def end(self):
        end_job(self.dispatcher_address, self.job_id)

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.end()
