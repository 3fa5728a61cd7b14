"""The loader's staging thread, trace, knobs and diagnostics on the CPU
(``device="cpu"``), against the JAX loader (``stage_to_device=False``)
where the JAX package has the same behaviour, on stores the port writes
from seeded numpy data (each test writes its own):

- ``stage_in_producer`` yields the batches of consumer-side staging bit
  for bit, with and without a ``DeviceStage``, at ``device_prefetch`` 1
  and 3 (the stage's draws follow the production ordinal);
- re-iterating stops and joins both threads;
- ``host_prefetch`` / ``device_prefetch`` resize the running queues;
- ``trace_path`` writes Chrome trace JSON with the JAX loader's span
  names, one wait and one device_put span per batch;
- ``exclude_stall_so_far`` re-bases ``stall_s``; ``diagnostics`` keeps the
  JAX key set; ``autotune`` raises NotImplementedError naming it.

Tolerance: none; everything is compared exactly.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import petastorm_tpu.reader.reader as jax_reader_mod
import petastorm_tpu_torch.reader.reader as port_reader_mod
from petastorm_tpu.jax_utils.loader import make_jax_dataloader
from petastorm_tpu_torch.cache_impl import BatchCache
from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

ROWS, GROUP, BATCH = 96, 16, 12  # 6 row groups, 8 batches


def write_store(tmp_path):
    """id, label, image (png 10x10x3); 6 row groups of 16."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("StageSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, (10, 10, 3), CompressedImageCodec("png"), False),
    ])
    rng = np.random.RandomState(5)
    url = f"file://{tmp_path}/store"
    materialize_rows(url, schema, ({
        "id": i, "label": i % 10,
        "image": rng.randint(0, 256, (10, 10, 3), dtype=np.uint8)} for i in range(ROWS)),
        rows_per_row_group=GROUP)
    return url


def _reader(url, module=port_reader_mod, **kwargs):
    return module.make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                              **kwargs)


def loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("torch-loader-producer", "torch-loader-stager"))
            and t.is_alive()]


@pytest.mark.parametrize("device_prefetch", [1, 3])
@pytest.mark.parametrize("stage", [None, "crop_flip"])
def test_stage_in_producer_yields_the_same_batches(tmp_path, stage, device_prefetch):
    url = write_store(tmp_path)

    def run(stage_in_producer, prefetch):
        device_stage = (DeviceStage(normalize=(127.5, 127.5), crop=(8, 8), flip=True)
                        if stage else None)
        loader = make_torch_dataloader(_reader(url, num_epochs=2), BATCH, device="cpu",
                                       device_stage=device_stage, device_prefetch=prefetch,
                                       stage_in_producer=stage_in_producer)
        with loader:
            return [{k: v.clone() for k, v in b.items()} for b in loader]

    want = run(False, 1)
    got = run(True, device_prefetch)
    assert len(got) == len(want) == 2 * ROWS // BATCH
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype
            assert torch.equal(g[name], w[name]), name
    if stage:
        assert got[0]["image"].shape == (BATCH, 8, 8, 3)
    assert loader_threads() == []


@pytest.mark.parametrize("stage_in_producer", [False, True])
def test_reiteration_stops_and_joins_both_threads(tmp_path, stage_in_producer):
    url = write_store(tmp_path)
    cache = BatchCache(1 << 24)
    loader = make_torch_dataloader(_reader(url), BATCH, device="cpu", host_prefetch=1,
                                   device_prefetch=1, batch_cache=cache,
                                   stage_in_producer=stage_in_producer)
    with loader:
        first = iter(loader)
        next(first)
        old = [t for t in (loader._producer, loader._stager) if t is not None]
        assert len(old) == (2 if stage_in_producer else 1)
        assert all(t.is_alive() for t in old)
        second = iter(loader)  # abandons the first iteration
        assert not any(t.is_alive() for t in old)
        assert len(list(second)) < 8  # the reader's tail, uncached
        first.close()
    assert loader_threads() == []
    cache.cleanup()


@pytest.mark.parametrize("stage_in_producer", [False, True])
def test_prefetch_depths_resize_while_running(tmp_path, stage_in_producer):
    url = write_store(tmp_path)
    loader = make_torch_dataloader(_reader(url), BATCH, device="cpu", host_prefetch=2,
                                   device_prefetch=1, stage_in_producer=stage_in_producer)
    with loader:
        iterator = iter(loader)
        batches = [next(iterator)]
        host_queue = loader._host_queue if stage_in_producer else loader._queue
        loader.host_prefetch = 5
        loader.device_prefetch = 3
        assert (loader.host_prefetch, loader.device_prefetch) == (5, 3)
        assert host_queue.maxsize == 5
        if stage_in_producer:
            assert loader._queue.maxsize == 3
        batches.extend(iterator)
        for bad in ("host_prefetch", "device_prefetch"):
            with pytest.raises(ValueError, match=bad):
                setattr(loader, bad, 0)
    assert [int(b["id"][0]) for b in batches] == list(range(0, ROWS, BATCH))


def _span_counts(path):
    with open(path) as f:
        doc = json.load(f)
    counts = {}
    for event in doc["traceEvents"]:
        if event["ph"] == "B":
            counts[event["name"]] = counts.get(event["name"], 0) + 1
    ends = sum(1 for e in doc["traceEvents"] if e["ph"] == "E")
    assert ends == sum(counts.values())
    return counts


@pytest.mark.parametrize("stage_in_producer", [False, True])
def test_trace_has_the_jax_span_names(tmp_path, stage_in_producer):
    url = write_store(tmp_path)
    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    with make_torch_dataloader(_reader(url), BATCH, device="cpu", trace_path=str(port_path),
                               stage_in_producer=stage_in_producer) as loader:
        assert len(list(loader)) == 8
    with make_jax_dataloader(_reader(url, jax_reader_mod), BATCH, stage_to_device=False,
                             trace_path=str(jax_path)) as loader:
        assert len(list(loader)) == 8
    got, want = _span_counts(port_path), _span_counts(jax_path)
    assert set(got) == set(want) == {"loader.decode", "loader.wait", "loader.device_put",
                                     "loader.consumer"}
    assert got == want == {"loader.decode": 8, "loader.wait": 8, "loader.device_put": 8,
                           "loader.consumer": 8}
    from petastorm_tpu_torch.telemetry import tracing

    assert not tracing.COLLECTOR.enabled  # released at the end of the iteration


def test_trace_collector_bounds_its_buffer(tmp_path):
    from petastorm_tpu_torch.telemetry.tracing import TraceCollector

    collector = TraceCollector(max_events=5)
    collector.record_span("off", 0.0, 1.0)  # not armed: nothing recorded
    collector.acquire()
    for i in range(3):
        collector.record_span("span", i, i + 0.5, bid=f"b{i}")
    collector.instant("mark", 3.0)
    assert len(collector.events()) == 5 and collector.dropped == 2
    collector.acquire()  # a second armer joins without clearing
    assert len(collector.events()) == 5
    collector.release()
    assert collector.enabled
    collector.release()
    assert not collector.enabled
    path = tmp_path / "t.json"
    assert collector.export(str(path)) == 5
    doc = json.loads(path.read_text())
    assert doc["otherData"]["dropped_events"] == 2
    assert doc["traceEvents"][0]["args"] == {"bid": "b0"}


def test_exclude_stall_so_far_rebases_stall(tmp_path):
    url = write_store(tmp_path)
    with make_torch_dataloader(_reader(url), BATCH, device="cpu") as loader:
        iterator = iter(loader)
        next(iterator)
        assert loader.diagnostics["stall_s"] > 0  # the first batch's wait
        loader.exclude_stall_so_far()
        assert loader.diagnostics["stall_s"] == 0.0
        time.sleep(0.01)
        assert loader.diagnostics["wall_s"] > 0.01
        list(iterator)
        assert loader.diagnostics["stall_s"] >= 0.0


@pytest.mark.parametrize("stage_in_producer", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_diagnostics_keep_the_jax_key_set(tmp_path, stage_in_producer, cached):
    url = write_store(tmp_path)
    cache = BatchCache(1 << 24) if cached else None
    with make_torch_dataloader(_reader(url), BATCH, device="cpu", batch_cache=cache,
                               stage_in_producer=stage_in_producer) as loader:
        list(loader)
        diag = loader.diagnostics
    with make_jax_dataloader(_reader(url, jax_reader_mod), BATCH,
                             stage_to_device=False) as loader:
        list(loader)
        jax_diag = loader.diagnostics
    assert set(diag) == set(jax_diag)
    assert (diag["batches"], diag["rows"]) == (jax_diag["batches"], jax_diag["rows"]) == (8, ROWS)
    if cache is not None:
        cache.cleanup()


@pytest.mark.parametrize("autotune", [True, {"interval_s": 1.0}, False])
def test_autotune_is_not_ported(tmp_path, autotune):
    url = write_store(tmp_path)
    with _reader(url) as reader:
        with pytest.raises(NotImplementedError, match="autotune"):
            make_torch_dataloader(reader, BATCH, device="cpu", autotune=autotune)
