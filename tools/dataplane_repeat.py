#!/usr/bin/env python3
"""Repeats ``chip_smoke.py`` phase 17 (a)'s run with the two cached workers
in processes of their own (``python -m petastorm_tpu_torch.service worker
--cache mem``), the transports in turns (tcp, shm, shm, tcp, ...), and
counts the runs in which the client re-opened a broken stream on its
worker: for each run the streams the workers served, their cache hits and
misses, and the pieces that re-opened streams named again. A broken
stream's exception is printed as the client meets it (a retry that
succeeds logs nothing of its own).

Run from the root of a checkout: ``python3 tools/dataplane_repeat.py
[--runs N] [--device cuda|cpu]``. ``--device cpu`` shrinks the store and
the CNN for a dry run on a host without a card. Prints one line a run and
a last JSON line with the totals; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _log_broken_streams():
    """Prints every ``broken`` or ``error`` event a stream reader posts."""
    from petastorm_tpu_torch.service import client

    put = client._StreamReader._put

    def logging_put(self, event):
        if event[0] in ("broken", "error"):
            print(f"stream {event[0]}: worker {self._stream.worker_id} pieces "
                  f"{getattr(self._stream, 'pieces', None)}: {event[2]!r}", flush=True)
        return put(self, event)

    client._StreamReader._put = logging_put


def _one_run(service, url, cfg, img, device, transport, tag, local):
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    mode = "tcp" if transport == "tcp" else "auto"
    disp = service.Dispatcher(num_epochs=cfg["a_epochs"]).start()
    children = []
    try:
        for i in range(cfg["workers"]):
            children.append(cs._cli_node(
                ["worker", "--dispatcher", f"127.0.0.1:{disp.address[1]}", "--dataset-url",
                 url, "--reader", "row", "--batch-size", str(img["batch"]),
                 "--workers-count", str(cfg["workers_count"]), "--worker-id", f"{tag}-{i}",
                 "--cache", "mem", "--cache-mem-mb", str(cfg["cache_mb"]),
                 "--transport", mode]))
        for child in children:
            json.loads(child.stdout.readline() or "{}")
        source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                            transport=mode)
        requested = cs._StreamRequests(source)
        cs._image_run(source, img, device, cfg["a_epochs"], local, f"repeat {tag}",
                      phase="dataplane")
        with FramedConnection.connect(disp.address, timeout=10.0) as conn:
            _, diagnostics = conn.request({"type": "worker_diagnostics"})
    finally:
        cs._stop_children(children)
        disp.stop()
    metrics = [(diagnostics.get(f"{tag}-{i}") or {}).get("metrics") or {}
               for i in range(cfg["workers"])]
    shm, tcp, hits, misses = cs._plane_fleet_counts(metrics, ())[:4]
    return shm + tcp, hits, misses, requested.pieces


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import torch

    from petastorm_tpu_torch import service
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec

    device = torch.device(args.device)
    cfg, img = dict(cs.DATAPLANE), cs.DATAPLANE["image"]
    if device.type == "cpu":
        img = dict(img, rows=256, rows_per_row_group=32, image_shape=(16, 16, 3), batch=32,
                   crop=(12, 12), hidden=64, conv_features=8)
        cfg = dict(cfg, image=img, a_epochs=4, workers_count=2)
    pieces, epochs = -(-img["rows"] // img["rows_per_row_group"]), cfg["a_epochs"]
    _log_broken_streams()
    url = f"file://{tempfile.mkdtemp(prefix='dataplane_repeat_')}/images"
    ic.generate_image_dataset(url, CompressedImageCodec(cs.IMAGE_CODEC), rows=img["rows"],
                              image_shape=img["image_shape"], num_classes=img["classes"],
                              rows_per_row_group=img["rows_per_row_group"])
    with make_reader(url, schema_fields=["image", "label"], num_epochs=1,
                     shuffle_row_groups=False, workers_count=1) as reader:
        local = collections.Counter(cs._image_digest(r.image, r.label) for r in reader)
    reopened = collections.Counter()
    for k in range(args.runs):
        transport = "shm" if k % 4 in (1, 2) else "tcp"
        t0 = time.perf_counter()
        streams, hits, misses, requested = _one_run(service, url, cfg, img, device,
                                                    transport, f"r{k}-{transport}", local)
        again = requested - pieces * epochs
        reopened[transport] += again > 0
        print(f"run {k} {transport} {time.perf_counter() - t0:.1f}s streams={streams} "
              f"hits={hits} misses={misses} named_again={again}", flush=True)
    print(json.dumps({"runs": args.runs, "device": str(device), "pieces": pieces,
                      "epochs": epochs, "runs_with_reopened_streams": dict(reopened)}))


if __name__ == "__main__":
    main()
