"""Scrapeable metrics over a small standard-library HTTP endpoint (the
port's own copy of ``petastorm_tpu/telemetry/http.py``).

``MetricsServer`` serves the process-default registry (or any registry):

- ``GET /metrics``      → Prometheus text exposition (0.0.4)
- ``GET /metrics.json`` → the registry snapshot as JSON
- ``GET /rates``        → per-second deltas of every counter over the
  snapshot ring's window (in-process ``rate()``: rows/s, evictions/min)
- ``GET /healthz``      → ``ok`` (liveness probe)

It is ``http.server.ThreadingHTTPServer`` on a daemon thread: nothing
listens unless a trainer asks (:func:`start_metrics_server`), and nothing
is shared with the data path.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from petastorm_tpu_torch.telemetry.registry import (
    REGISTRY,
    SnapshotRing,
    expose_prometheus,
)


class _Handler(BaseHTTPRequestHandler):
    # The registry/ring are attached to the *server* by MetricsServer.

    def _send(self, status, content_type, body):
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        registry = self.server.telemetry_registry
        if path in ("/metrics", "/"):
            self._send(200, "text/plain; version=0.0.4; charset=utf-8",
                       expose_prometheus(registry))
        elif path == "/metrics.json":
            self._send(200, "application/json",
                       json.dumps(registry.snapshot()))
        elif path == "/rates":
            ring = self.server.telemetry_ring
            rates = {}
            if ring is not None:
                snap = registry.snapshot()
                for name, family in snap.items():
                    if family["type"] not in ("counter", "histogram"):
                        continue
                    rate = ring.rate(name)
                    if rate is not None:
                        rates[name] = round(rate, 6)
            self._send(200, "application/json", json.dumps({
                "window_s": (None if ring is None else
                             ring.interval_s * max(1, len(ring.snapshots())
                                                   - 1)),
                "per_second": rates,
            }))
        elif path == "/healthz":
            self._send(200, "text/plain", "ok\n")
        else:
            self._send(404, "text/plain", "not found\n")

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # scrapes must not spam the logs


class MetricsServer:
    """Serve a registry until :meth:`stop` (context manager supported)."""

    def __init__(self, registry=None, host="127.0.0.1", port=0,
                 snapshot_interval_s=5.0):
        self._registry = registry if registry is not None else REGISTRY
        self._host = host
        self._port = port
        self._snapshot_interval_s = snapshot_interval_s
        self._httpd = None
        self._thread = None
        self._ring = None

    def start(self):
        self._httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.telemetry_registry = self._registry
        if self._snapshot_interval_s:
            self._ring = SnapshotRing(
                self._registry, interval_s=self._snapshot_interval_s)
            self._ring.start()
        self._httpd.telemetry_ring = self._ring
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="telemetry-metrics-http")
        self._thread.start()
        return self

    @property
    def address(self):
        return (self._host, self._port)

    @property
    def ring(self):
        return self._ring

    def stop(self):
        if self._ring is not None:
            self._ring.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()


def start_metrics_server(port, host="127.0.0.1", registry=None,
                         snapshot_interval_s=5.0):
    """Trainer-side opt-in exposition: start serving ``registry`` (default:
    the process registry) on ``(host, port)`` and return the server (call
    ``.stop()`` at teardown; ``port=0`` picks a free port)."""
    return MetricsServer(registry=registry, host=host, port=port,
                         snapshot_interval_s=snapshot_interval_s).start()
