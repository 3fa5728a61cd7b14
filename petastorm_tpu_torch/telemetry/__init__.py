"""Telemetry: the metrics registry, per-batch tracing, exposition and the
flight recorder (the port's own copy of ``petastorm_tpu/telemetry``).

- **metrics**: a process-wide, thread-safe, label-aware registry
  (:mod:`.registry`) with the families of :mod:`.metrics`; the reader's
  pools and ventilator, the loader and the decoded-batch cache publish
  into it, and their ``diagnostics`` / ``stats()`` agree with it;
- **tracing**: per-batch loader spans as Chrome ``trace_event`` JSON
  (:mod:`.tracing`);
- **exposition**: Prometheus text over a standard-library HTTP endpoint
  (:mod:`.http`), and a :class:`~.registry.SnapshotRing` for in-process
  ``rate()``;
- the flight recorder (:mod:`.flight`) and the structured logger
  (:mod:`.log`);
- fleet tracing of the data service: NTP-style clock alignment and the
  merged trace (:mod:`.clockalign`), and critical-path stall attribution
  over it (:mod:`.critical_path`).
"""

from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.telemetry.http import MetricsServer, start_metrics_server
from petastorm_tpu_torch.telemetry.log import StructuredLogger, service_logger
from petastorm_tpu_torch.telemetry.registry import (
    REGISTRY,
    MetricsRegistry,
    SnapshotRing,
    expose_prometheus,
)
from petastorm_tpu_torch.telemetry.tracing import COLLECTOR, TraceCollector

__all__ = [
    "REGISTRY",
    "COLLECTOR",
    "MetricsRegistry",
    "MetricsServer",
    "SnapshotRing",
    "StructuredLogger",
    "TraceCollector",
    "expose_prometheus",
    "service_logger",
    "start_metrics_server",
    "tracing",
]
