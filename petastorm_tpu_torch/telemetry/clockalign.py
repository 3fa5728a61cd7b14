"""NTP-style per-peer clock alignment for fleet trace assembly (the port's
own copy of ``petastorm_tpu/telemetry/clockalign.py``).

Each process's :class:`~petastorm_tpu_torch.telemetry.tracing.TraceCollector`
anchors its ``perf_counter`` timestamps to that process's wall clock —
good enough for eyeballing a loopback run, wrong across hosts (and even
across processes on one host, NTP steps and anchor jitter move the axes
apart). The fix is the classic NTP midpoint estimate, piggybacked on
traffic the service already sends:

- a peer (worker or client) wraps one control RPC with two local
  ``perf_counter`` readings ``t0``/``t1`` and converts their midpoint
  into its trace timebase;
- the dispatcher's reply carries ``dispatcher_time_us`` — its own trace
  timebase read while handling the request;
- assuming symmetric network delay, the dispatcher's reading corresponds
  to the peer's midpoint, so ``offset = dispatcher_time - midpoint``
  maps the peer's axis onto the dispatcher's. The estimate's error is
  bounded by ±RTT/2, so the estimator keeps the samples with the
  SMALLEST round-trips (least queueing noise) and takes the median of
  their offsets — jitter-robust without any clock-discipline loop.

At merge time every shipped peer event gets ``ts += offset`` and the
dispatcher's own events pass through unshifted: one Perfetto-loadable
fleet trace on the dispatcher's axis. Asymmetric paths (one congested
direction) bias the midpoint by the asymmetry/2.

Everything here is pure arithmetic over caller-provided readings: no
clock reads, no I/O — unit-testable with fabricated skew and jitter.
"""

from __future__ import annotations

#: Keep this many lowest-RTT samples for the median; more buys little
#: (the low-RTT population is already the low-noise one) and a small k
#: converges within a handful of heartbeats.
DEFAULT_BEST_K = 5

#: Ring bound on retained samples: heartbeats arrive forever, the
#: estimate only ever needs the recent low-RTT population (retaining
#: everything would let one ancient pre-NTP-step sample pin the median).
DEFAULT_MAX_SAMPLES = 64


class OffsetEstimator:
    """Streaming per-peer offset estimate from RPC round-trip samples.

    ``add(local_mid_us, remote_us, rtt_us)`` feeds one wrapped RPC:
    the local midpoint and the remote reading both already converted to
    their respective trace timebases (microseconds), plus the measured
    round-trip. ``offset_us()`` is the median offset of the ``best_k``
    lowest-RTT samples — ``None`` until the first sample lands.
    """

    def __init__(self, max_samples=DEFAULT_MAX_SAMPLES,
                 best_k=DEFAULT_BEST_K):
        self._max_samples = int(max_samples)
        self._best_k = int(best_k)
        self._samples = []  # (rtt_us, offset_us), insertion-ordered

    def add(self, local_mid_us, remote_us, rtt_us):
        self._samples.append((float(rtt_us),
                              float(remote_us) - float(local_mid_us)))
        if len(self._samples) > self._max_samples:
            self._samples.pop(0)

    def __len__(self):
        return len(self._samples)

    def offset_us(self):
        if not self._samples:
            return None
        best = sorted(self._samples)[:self._best_k]
        offsets = sorted(offset for _, offset in best)
        mid = len(offsets) // 2
        if len(offsets) % 2:
            return offsets[mid]
        return (offsets[mid - 1] + offsets[mid]) / 2.0

    def min_rtt_us(self):
        """The tightest round-trip seen — the ±RTT/2 error bound on the
        current estimate (reported alongside the offset so trace readers
        know how much to trust sub-millisecond alignment)."""
        if not self._samples:
            return None
        return min(rtt for rtt, _ in self._samples)


def shift_events(events, offset_us):
    """Copy ``events`` with ``ts`` moved by ``offset_us`` (a no-op pass
    for offset 0/None — the dispatcher's own events)."""
    if not offset_us:
        return list(events)
    shifted = []
    for event in events:
        event = dict(event)
        if "ts" in event:
            event["ts"] = event["ts"] + offset_us
        shifted.append(event)
    return shifted


def process_name_metadata(events, name):
    """Chrome ``M``-phase ``process_name`` records for every pid seen in
    ``events`` — Perfetto then shows the peer's name (worker id, client
    id) instead of a bare pid on each process track."""
    pids = []
    for event in events:
        pid = event.get("pid")
        if pid is not None and pid not in pids:
            pids.append(pid)
    return [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": name}} for pid in pids]


def assemble_fleet_trace(local_events, peers, local_name="dispatcher",
                         local_dropped=0):
    """Merge the dispatcher's own ring with every peer's shipped buffer
    into one Perfetto-loadable trace document.

    :param peers: ``{peer_name: {"events": [...], "offset_us": x|None,
        "dropped": n}}`` — buffers as shipped (peer timebase); each is
        shifted onto the local axis by its offset at merge.
    :return: the trace-JSON document dict (``traceEvents`` sorted by
        ``ts`` so offline consumers can stream it).
    """
    merged = list(local_events)
    merged.extend(process_name_metadata(local_events, local_name))
    dropped = int(local_dropped)
    alignment = {}
    for name in sorted(peers):
        buf = peers[name]
        offset = buf.get("offset_us")
        shifted = shift_events(buf.get("events") or [], offset)
        merged.extend(shifted)
        merged.extend(process_name_metadata(shifted, name))
        dropped += int(buf.get("dropped") or 0)
        alignment[name] = {"offset_us": offset,
                           "min_rtt_us": buf.get("min_rtt_us")}
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "otherData": {"producer": "petastorm_tpu_torch.telemetry",
                          "dropped_events": dropped,
                          "clock_alignment": alignment}}
