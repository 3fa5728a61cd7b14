"""The chaos harness of the data service (the port's own copy of
``petastorm_tpu/service/chaos.py``).

Injects the failures the service claims to survive (a dispatcher crash and
restart, a worker killed mid-stream, dropped connections, a corrupt cache
entry, a job registered and cancelled, a worker drained and re-admitted)
while a real fleet serves, so the delivery invariants (no lost rows; no
duplicates when only the control plane was perturbed) are checked against
behaviour. Each injected event is recorded as ``(elapsed_s, label)``.

:class:`StreamDigest` is the byte-identity check of a delivered stream: its
digest of a batch of numpy arrays or torch tensors equals the JAX
harness's for the same values. Imports neither torch nor JAX.
"""

from __future__ import annotations

import hashlib
import logging
import os
import sys
import threading
import time

logger = logging.getLogger(__name__)

CHAOS_KINDS = ("dispatcher-restart", "worker-kill", "conn-drop", "cache-corrupt", "job-cancel",
               "worker-drain", "failpoints")


class ChaosInjector:
    """Run ``actions`` on a thread (``service-chaos``): round-robin, or with
    ``seed`` seed-derived (the action and the jitter of each interval), so
    the n-th event is the same action at the same nominal offset in every
    run of the seed.

    :param actions: ``[(label, callable)]``; each call injects one fault
        and must tolerate a fleet still recovering from the last one.
    :param interval_s: the nominal pause between events.
    :param initial_delay_s: the pause before the first (streams start).
    :param max_events: stop after this many (``None``: until :meth:`stop`).
    :param seed: derive the event sequence from it (the seed tree's
        ``fold_in``, no hidden RNG); ``None``: round-robin at the interval.
    """

    def __init__(self, actions, interval_s=1.5, initial_delay_s=0.4, max_events=None,
                 seed=None):
        if not actions:
            raise ValueError("chaos needs at least one (label, action)")
        self._actions = list(actions)
        self._interval_s = interval_s
        self._initial_delay_s = initial_delay_s
        self._max_events = max_events
        self._seed = int(seed) if seed is not None else None
        self._stop = threading.Event()
        self._thread = None
        self._start_time = None
        self.events = []  # (elapsed_s, label) of each injected fault
        self.errors = []  # (label, repr(exc)): an injection must not die

    def start(self):
        self._start_time = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True, name="service-chaos")
        self._thread.start()
        return self

    def stop(self, timeout=30):
        """Signal and join; the budget covers an in-flight dispatcher
        restart, so no action installs a node behind the caller's
        teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.error("chaos injector thread still alive after %.0fs stop budget — a "
                             "node it installs now may leak", timeout)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()

    def _event_plan(self, count):
        """``(label, action, interval)`` of event ``count``: pure in
        ``(seed, count)`` with a seed, else round-robin at the interval."""
        if self._seed is None:
            label, action = self._actions[count % len(self._actions)]
            return label, action, self._interval_s
        from petastorm_tpu_torch.service.seedtree import fold_in

        key = fold_in(self._seed, ("chaos-event", count))
        label, action = self._actions[key % len(self._actions)]
        # The interval's jitter in [0.5, 1.5) of the nominal, derived.
        interval = self._interval_s * (0.5 + (fold_in(key, "interval") % 1000) / 1000.0)
        return label, action, interval

    def _run(self):
        if self._stop.wait(self._initial_delay_s):
            return
        count = 0
        while not self._stop.is_set():
            label, action, interval = self._event_plan(count)
            elapsed = time.perf_counter() - self._start_time
            logger.warning("chaos: injecting %s at t=%.2fs", label, elapsed)
            try:
                action()
                self.events.append((round(elapsed, 3), label))
            except Exception as exc:
                logger.exception("chaos action %s failed", label)
                self.errors.append((label, repr(exc)))
            count += 1
            if self._max_events is not None and count >= self._max_events:
                return
            if self._stop.wait(interval):
                return


def dispatcher_restart_action(holder, dispatcher_factory, downtime_s=0.15):
    """Crash and restart the dispatcher in ``holder[0]`` (a one-element
    list, so the caller's teardown stops the current one): stopped without
    a final snapshot, then after ``downtime_s`` replaced by
    ``dispatcher_factory(host, port)`` on the same address. With a journal
    the invariant is zero lost and zero duplicated rows."""
    def action():
        old = holder[0]
        host, port = old.address
        old.stop()
        time.sleep(downtime_s)
        holder[0] = dispatcher_factory(host, port).start()
    return action


def worker_kill_action(fleet, min_survivors=1):
    """Kill the next live worker of ``fleet`` (connections dropped mid-stream,
    no ``end``), never below ``min_survivors``: at least once delivery (no
    loss, duplicates allowed)."""
    state = {"killed": set()}

    def action():
        alive = [w for w in fleet if id(w) not in state["killed"]]
        if len(alive) <= min_survivors:
            logger.warning("chaos: only %d worker(s) left — not killing", len(alive))
            return
        victim = alive[0]
        state["killed"].add(id(victim))
        victim.kill()
    return action


def connection_drop_action(nodes_fn):
    """Drop every open connection of every node ``nodes_fn()`` returns (called
    per event, so it follows a restarted dispatcher), servers kept up."""
    def action():
        for node in nodes_fn():
            node.drop_connections()
    return action


def cache_corrupt_action(cache_dir):
    """Corrupt one disk-tier entry per event, truncating it to half and
    flipping a payload byte in turn: the load must detect either, count it,
    delete it and decode afresh. Victims cycle through the sorted listing."""
    state = {"count": 0}

    def action():
        from petastorm_tpu_torch.cache_impl.batch_cache import ENTRY_SUFFIX

        entries = sorted(os.path.join(cache_dir, name) for name in os.listdir(cache_dir)
                         if name.endswith(ENTRY_SUFFIX))
        if not entries:
            logger.warning("chaos: no disk-tier entries under %s yet — nothing to corrupt",
                           cache_dir)
            return
        victim = entries[state["count"] % len(entries)]
        truncate = state["count"] % 2 == 0
        state["count"] += 1
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            if truncate or size < 2:
                f.truncate(size // 2)
                logger.warning("chaos: truncated cache entry %s (%d -> %d bytes)", victim,
                               size, size // 2)
            else:
                f.seek(size // 2)
                original = f.read(1)
                f.seek(size // 2)
                f.write(bytes([original[0] ^ 0x40]))
                logger.warning("chaos: bit-flipped cache entry %s at offset %d", victim,
                               size // 2)
    return action


def job_cancel_action(dispatcher_address_fn, weight=0.5):
    """Register a sacrificial job and end it at once, per event: the other
    jobs' streams must flow untouched (its fencing fences no peer)."""
    state = {"count": 0}

    def action():
        from petastorm_tpu_torch.service.fleet import end_job, register_job

        job = f"chaos-job-{state['count']}"
        state["count"] += 1
        address = dispatcher_address_fn()
        register_job(address, job, weight=weight)
        end_job(address, job)
    return action


def worker_drain_action(dispatcher_fn, min_serving=1):
    """Drain a serving worker and re-admit it, in turn: a drain mid-epoch
    must hand its unstarted pieces to serving peers exactly once while its
    started ones finish. Never below ``min_serving``; victims cycle in
    sorted order."""
    state = {"drained": [], "count": 0}

    def action():
        dispatcher = dispatcher_fn()
        if state["drained"]:
            dispatcher.admit_worker(state["drained"].pop(0), reason="chaos re-admit")
            return
        serving = dispatcher.fleet_signals()["serving"]
        if len(serving) <= min_serving:
            logger.warning("chaos: only %d serving worker(s) — not draining", len(serving))
            return
        wid = serving[state["count"] % len(serving)]
        state["count"] += 1
        if dispatcher.drain_worker(wid, reason="chaos drain"):
            state["drained"].append(wid)
    return action


def _as_numpy(value):
    """``value`` as a numpy array: a torch tensor through its CPU numpy
    view (bf16, which numpy lacks, raises: its digest could not equal
    JAX's), anything else through ``np.asarray``."""
    import numpy as np

    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            raise TypeError("StreamDigest cannot hash a bfloat16 tensor: numpy has no "
                            "bfloat16, so the digest could not equal the JAX harness's")
        return value.detach().cpu().numpy()
    return np.asarray(value)


class StreamDigest:
    """Order-sensitive hash of a delivered batch stream: each batch folds in
    every field's name, dtype, shape and bytes, in sorted field order, so a
    reordered, dropped, duplicated or flipped row changes the digest."""

    def __init__(self):
        self._hash = hashlib.blake2b(digest_size=16)
        self.batches = 0

    def update(self, batch):
        import numpy as np

        for name in sorted(batch):
            arr = _as_numpy(batch[name])
            self._hash.update(name.encode("utf-8"))
            self._hash.update(str(arr.dtype).encode("utf-8"))
            self._hash.update(repr(arr.shape).encode("utf-8"))
            if arr.dtype == object:
                # Element by element, length-prefixed: bare concatenation
                # would let [b"ab", b"c"] and [b"a", b"bc"] collide.
                for item in arr.ravel():
                    data = item if isinstance(item, bytes) else repr(item).encode("utf-8")
                    self._hash.update(len(data).to_bytes(8, "big"))
                    self._hash.update(data)
            else:
                self._hash.update(np.ascontiguousarray(arr).tobytes())
        self.batches += 1
        return self

    def hexdigest(self):
        return self._hash.hexdigest()


def delivery_invariants(expected_ids, got_ids, allow_duplicates):
    """The row-delivery invariants of a chaos run.

    :param expected_ids: the sample keys one clean run delivers.
    :param got_ids: every sample key received.
    :param allow_duplicates: True under data-plane faults (at least once),
        False when only the control plane was perturbed.
    :returns: ``{"lost_rows", "duplicate_rows", "ok"}``.
    """
    from collections import Counter

    expected = Counter(expected_ids)
    got = Counter(got_ids)
    lost = sum((expected - got).values())
    duplicates = sum((got - expected).values())
    return {"lost_rows": lost, "duplicate_rows": duplicates,
            "ok": lost == 0 and (allow_duplicates or duplicates == 0)}
