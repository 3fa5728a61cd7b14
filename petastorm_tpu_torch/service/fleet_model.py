"""The model-based fleet planner: a fitted throughput model and what-if
replay (the port's own copy of ``petastorm_tpu/service/fleet_model.py``).

In place of the streak heuristics of
:class:`~petastorm_tpu_torch.service.fleet.AutoscalePlanner`, fit a
per-worker throughput model from observed ``(serving count, fleet rows/s)``
samples and the journaled ``stage_profile`` records, predict the marginal
rows/s of the next admit or drain, and apply a decision only after a
what-if replay over the samples validates the model. Every decision is
journaled as a ``fleet_plan`` record by the controller.

Pure: no threads, clocks or sockets, and no torch.
"""

from petastorm_tpu_torch.service.fleet import AutoscaleConfig

#: Throughput samples kept for fitting and replay: the model tracks the
#: current workload, not old history.
SAMPLES_KEPT = 64

#: A decision must change the predicted fleet rate by at least this
#: fraction of one worker's modelled rate, else the planner holds.
MIN_MARGINAL_FRACTION = 0.5

#: The what-if gate: the median relative error of ``predict(n)`` against
#: the measured samples must stay under this before any decision.
WHATIF_TOLERANCE = 0.25


def fit_throughput_model(samples, stage_profiles=()):
    """Fit ``predict(n) = min(n * per_worker, ceiling)``.

    ``samples`` are ``(serving_count, fleet_rows_per_s)``. The per-worker
    rate comes from the smallest fleet size observed (the linear regime);
    the ceiling is the best measured rate once the largest fleet fell
    clearly short of linear scaling. Without samples the stage profiles
    give a prior: one over the heaviest stage's mean span time. ``None``
    when neither gives a positive rate.
    """
    by_n = {}
    for n, rows_s in samples:
        n = int(n)
        if n <= 0 or rows_s is None or rows_s <= 0:
            continue
        by_n.setdefault(n, []).append(float(rows_s))
    means = {n: sum(v) / len(v) for n, v in by_n.items()}
    per_worker = None
    if means:
        n_min = min(means)
        per_worker = means[n_min] / n_min
    if per_worker is None:
        per_worker = _profile_rate_prior(stage_profiles)
    if per_worker is None or per_worker <= 0:
        return None
    ceiling = None
    if means:
        n_max = max(means)
        if n_max > min(means) and means[n_max] < 0.9 * n_max * per_worker:
            ceiling = max(means.values())
    return ThroughputModel(per_worker, ceiling)


def _profile_rate_prior(stage_profiles):
    """Rows/s prior from journaled stage profiles: one over the largest
    mean span time (a coarse order of magnitude, spans are per batch)."""
    worst_mean_us = 0.0
    for record in stage_profiles or ():
        profile = (record or {}).get("profile") or {}
        for stats in profile.values():
            mean_us = (stats or {}).get("mean_us")
            if mean_us and mean_us > worst_mean_us:
                worst_mean_us = float(mean_us)
    if worst_mean_us <= 0:
        return None
    return 1e6 / worst_mean_us


class ThroughputModel:
    """``predict(n) = min(n * per_worker, ceiling)`` and its marginals."""

    def __init__(self, per_worker_rows_s, ceiling_rows_s=None):
        self.per_worker_rows_s = float(per_worker_rows_s)
        self.ceiling_rows_s = None if ceiling_rows_s is None else float(ceiling_rows_s)

    def predict(self, n):
        """The modelled fleet rows/s with ``n`` serving workers."""
        if n <= 0:
            return 0.0
        linear = n * self.per_worker_rows_s
        if self.ceiling_rows_s is not None:
            return min(linear, self.ceiling_rows_s)
        return linear

    def marginal(self, n):
        """The rows/s admitting worker ``n + 1`` is predicted to add."""
        return self.predict(n + 1) - self.predict(n)

    def to_dict(self):
        return {"per_worker_rows_s": self.per_worker_rows_s,
                "ceiling_rows_s": self.ceiling_rows_s}


def whatif_replay(model, samples):
    """``(error, ok)``: the median relative error of ``predict(n)`` against
    each ``(n, rows_s)`` sample (``(None, False)`` with nothing to replay),
    and whether it is within :data:`WHATIF_TOLERANCE`."""
    errors = sorted(abs(model.predict(n) - rows_s) / rows_s
                    for n, rows_s in samples
                    if n > 0 and rows_s is not None and rows_s > 0)
    if not errors:
        return None, False
    mid = len(errors) // 2
    error = errors[mid] if len(errors) % 2 else (errors[mid - 1] + errors[mid]) / 2.0
    return error, error <= WHATIF_TOLERANCE


class ModelPlanner:
    """The model's planner, with :class:`~petastorm_tpu_torch.service.fleet.
    AutoscalePlanner`'s ``plan(signals) -> [decision]`` contract.

    Each tick sums ``signals["rates"]`` into one throughput sample;
    ``signals["stage_profiles"]`` is the prior when samples are sparse.
    A decision carries ``model``, ``predicted_rows_s`` and ``whatif_error``
    (the controller journals it as a ``fleet_plan`` record). Every admit or
    drain is a probe: ``probe_windows`` ticks later, an admit whose measured
    rate missed its prediction by more than the tolerance is reverted (a
    drain of the same worker) and the measurement re-anchors the model.
    """

    def __init__(self, config=None, probe_windows=3):
        self._config = AutoscaleConfig() if config is None else AutoscaleConfig.coerce(config)
        self._probe_windows = max(1, int(probe_windows))
        self._samples = []  # [(n_serving, fleet_rows_s)]
        self._cooldown = 0
        self._probe = None  # {"action", "worker_id", "predicted", "age", "n_target"}
        self.last_model = None
        self.last_whatif_error = None

    @property
    def config(self):
        """The coerced :class:`AutoscaleConfig`."""
        return self._config

    def observe(self, n_serving, rows_s):
        """Record one throughput sample (``plan`` does it from the signals)."""
        if n_serving > 0 and rows_s and rows_s > 0:
            self._samples.append((int(n_serving), float(rows_s)))
            del self._samples[:-SAMPLES_KEPT]

    @property
    def samples(self):
        return list(self._samples)

    def plan(self, signals):
        serving = list(signals.get("serving", ()))
        standby = list(signals.get("standby", ()))
        draining = list(signals.get("draining", ()))
        rates = signals.get("rates") or {}
        n = len(serving)
        fleet_rows_s = sum(r for r in rates.values() if r and r > 0)
        self.observe(n, fleet_rows_s)
        backlog = signals.get("backlog") or {}
        decisions = [{"action": "retire", "worker_id": wid, "reason": "drain complete"}
                     for wid in draining if not backlog.get(wid)]
        model = fit_throughput_model(self._samples, signals.get("stage_profiles") or ())
        self.last_model = model
        if model is None or n == 0:
            return decisions
        error, ok = whatif_replay(model, self._samples)
        self.last_whatif_error = error
        if self._probe is not None:
            decision = self._check_probe(model, fleet_rows_s, n)
            if decision is not None:
                decisions.append(decision)
            return decisions
        if self._cooldown > 0:
            self._cooldown -= 1
            return decisions
        if not ok:
            return decisions  # the replay did not validate the model
        threshold = MIN_MARGINAL_FRACTION * model.per_worker_rows_s
        if standby and model.marginal(n) >= threshold:
            decisions.append(self._probe_decision(
                "admit", sorted(standby)[0], model, error, predicted=model.predict(n + 1),
                n_target=n + 1,
                reason="marginal %.1f rows/s >= %.1f" % (model.marginal(n), threshold)))
        elif n > self._config.min_serving and model.marginal(n - 1) < threshold:
            decisions.append(self._probe_decision(
                "drain", self._drain_candidate(serving, rates), model, error,
                predicted=model.predict(n - 1), n_target=n - 1,
                reason="marginal %.1f rows/s < %.1f" % (model.marginal(n - 1), threshold)))
        return decisions

    @staticmethod
    def _drain_candidate(serving, rates):
        """The slowest serving worker, ties by id."""
        return sorted(serving, key=lambda w: (rates.get(w) or 0.0, w))[0]

    def _probe_decision(self, action, worker_id, model, error, predicted, n_target, reason):
        self._probe = {"action": action, "worker_id": worker_id, "predicted": predicted,
                       "age": 0, "n_target": n_target}
        self._cooldown = self._config.cooldown_windows
        return {"action": action, "worker_id": worker_id, "reason": reason,
                "model": model.to_dict(), "predicted_rows_s": predicted,
                "whatif_error": error, "probe": True}

    def _check_probe(self, model, fleet_rows_s, n):
        """Age the open probe; once mature, revert an admit whose measured
        rate missed its prediction by more than the tolerance. A fleet that
        moved under the probe (an operator, a death) drops it unjudged."""
        probe = self._probe
        probe["age"] += 1
        if probe["age"] < self._probe_windows:
            return None
        self._probe = None
        predicted = probe["predicted"]
        if n != probe["n_target"]:
            return None
        if predicted > 0 and fleet_rows_s > 0:
            miss = abs(fleet_rows_s - predicted) / predicted
            if miss > WHATIF_TOLERANCE and probe["action"] == "admit":
                self._samples.append((n, fleet_rows_s))
                del self._samples[:-SAMPLES_KEPT]
                self._cooldown = self._config.cooldown_windows
                return {"action": "drain", "worker_id": probe["worker_id"],
                        "reason": "probe revert: measured %.1f vs predicted %.1f rows/s"
                                  % (fleet_rows_s, predicted),
                        "model": model.to_dict(), "predicted_rows_s": model.predict(n - 1),
                        "whatif_error": miss, "probe": True}
        return None
