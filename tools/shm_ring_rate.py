#!/usr/bin/env python3
"""Messages per second of the data service's transports in one process:
framed TCP over a socketpair, the shared-memory ring with inline records,
and the ring with frames mapped from a frame pool (a warm cache hit), each
carrying the same collated batch (by default phase 14's image batch: 128
png-decoded 64x64x3 images and their labels, 1.5 MiB), one producer thread
and the consuming thread, as a worker and its client in one process.

Run from the root of a checkout: ``python3 tools/shm_ring_rate.py
[--messages N] [--rounds R] [--images B]``. Prints one JSON line a round
(the transports in turns: tcp, inline, mapped, then the reverse) and the
host's CPU count; it needs no card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _batch(images):
    import numpy as np

    rng = np.random.default_rng(0)
    return {"image": rng.integers(0, 255, (images, 64, 64, 3), dtype=np.uint8),
            "label": np.arange(images, dtype=np.int64)}


def _pump(send, recv, messages):
    """Messages a second: ``send(i)`` on a producer thread, ``recv()`` here."""
    thread = threading.Thread(target=lambda: [send(i) for i in range(messages)])
    t0 = time.perf_counter()
    thread.start()
    for _ in range(messages):
        recv()
    elapsed = time.perf_counter() - t0
    thread.join()
    return messages / elapsed


def tcp_rate(fmt, frames, messages):
    from petastorm_tpu_torch.reader_impl import framed_socket as fs

    a, b = socket.socketpair()
    try:
        reader = fs.FramedReader(b)
        return _pump(lambda i: fs.send_framed_frames(a, {"type": "batch", "i": i}, fmt, frames),
                     reader.recv, messages)
    finally:
        a.close()
        b.close()


def ring_rate(fmt, frames, messages, mapped):
    from petastorm_tpu_torch.reader_impl import framed_socket as fs
    from petastorm_tpu_torch.service import shm_ring as sr

    a, b = socket.socketpair()
    pool = sr.FramePool(size=64 << 20) if mapped else None
    producer = sr.RingProducer(a, pool=pool)
    consumer = sr.RingConsumer(producer.descriptor(), b, fs.FramedReader(b))
    attached = None
    try:
        payload = frames
        if mapped:
            attached = sr.FramePool.attach(pool.descriptor())
            consumer.attach_pool(attached)
            parts = [bytes(memoryview(f).cast("B")) for f in frames]
            buf = pool.allocate(sum(len(p) for p in parts))
            buf[:] = b"".join(parts)
            payload, off = [], 0
            for part in parts:
                payload.append(buf[off:off + len(part)])
                off += len(part)
            del buf
        rate = _pump(lambda i: producer.send_frames({"type": "batch", "i": i}, fmt, payload),
                     lambda: consumer.recv(timeout=30), messages)
        del payload
        return rate
    finally:
        producer.close()
        consumer.close()
        for p in (attached, pool):
            if p is not None:
                p.close()
        a.close()
        b.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--messages", type=int, default=400)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--images", type=int, default=128)
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.reader_impl.framed_socket import encode_payload

    fmt, frames = encode_payload(_batch(args.images))
    size = sum(memoryview(f).nbytes for f in frames)
    runs = {"tcp": lambda: tcp_rate(fmt, frames, args.messages),
            "inline": lambda: ring_rate(fmt, frames, args.messages, mapped=False),
            "mapped": lambda: ring_rate(fmt, frames, args.messages, mapped=True)}
    order = list(runs) + list(reversed(runs))
    print(json.dumps({"cpus": os.cpu_count(), "message_bytes": size,
                      "messages": args.messages}), flush=True)
    for r in range(args.rounds):
        rates = {}
        for name in order:
            rates.setdefault(name, []).append(round(runs[name](), 1))
        print(json.dumps({"round": r, "messages_per_s": rates}), flush=True)


if __name__ == "__main__":
    main()
