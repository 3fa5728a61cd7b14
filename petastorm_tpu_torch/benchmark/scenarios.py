"""Named benchmark scenarios from BASELINE.md's config list.

The port's own copy of ``petastorm_tpu/benchmark/scenarios.py``: the
reference's headline workload shapes, runnable on synthetic data via
``python -m petastorm_tpu_torch.benchmark scenario <name>``:

- ``tabular`` — config #3 (Criteo-DLRM-like): a wide Arrow schema (dense
  floats + integer categoricals) read through ``make_batch_reader``,
  measuring the row-group predicate-pushdown win: ``filters`` prune row
  groups from Parquet statistics before any byte of data is read.
- ``ngram`` — config #4 (multi-frame video/lidar): timestamped
  ``NdarrayCodec`` frames windowed by :class:`~petastorm_tpu_torch.ngram.NGram`
  with a ``delta_threshold``, measuring windows/sec through ``make_reader``.
- ``image`` — config #2 (ImageNet-shaped ``CompressedImageCodec``): row vs
  columnar decode images/sec plus the loader's input-stall %, and
  optionally the :class:`DeviceStage` leg on the card.
- ``weighted`` — config #5 (multi-corpus shuffle): throughput and empirical
  mix ratio through ``WeightedSamplingReader``.
- ``converter_mixing`` — config #5 end-to-end: ``make_spark_converter``
  materialization -> per-corpus batch readers -> weighted mix ->
  ``make_torch_dataloader`` (the whole pipeline, not just the sampler).
- ``packed`` — ragged-sequence delivery: ``make_packed_torch_dataloader``
  tokens/sec plus packed-vs-padded slot utilization (the attention-FLOP
  waste packing removes).
- ``service`` — the data service on loopback (dispatcher + batch workers +
  one client), against a local reader, with its chaos and failpoint
  harness.

Each scenario materializes its own synthetic dataset (unless given a url),
runs the measurement, and returns a flat dict of numbers (the CLI prints it
as one JSON line). Only the image scenario's device-stage leg touches a
device (``device``, ``"cuda"`` by default); every other leg, the service's
loader included, stays on the host (``device="cpu"``, the port's spelling
of the JAX loader's ``stage_to_device=False``).
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

DEFAULT_TABULAR_ROWS = 40_000
DEFAULT_TABULAR_DAYS = 8
DEFAULT_NGRAM_FRAMES = 2_000


def _invariant_failure(message):
    """Build the chaos-invariant RuntimeError AND dump the flight
    recorder first (telemetry/flight.py): the violation's postmortem —
    the ring of control-plane events right up to the failed check — is
    written to disk and its path appended to the error, so a red chaos
    run (or the fuzzer's shrunk reproducer) always ships its own
    evidence."""
    from petastorm_tpu_torch.telemetry.flight import RECORDER

    RECORDER.note("scenario.invariant_violation", error=message[:200])
    path = RECORDER.dump("invariant-violation")
    if path:
        message += f"; flight recorder dump: {path}"
    return RuntimeError(message)


# ---------------------------------------------------------------------------
# Scenario: wide-schema tabular with predicate pushdown (config #3)
# ---------------------------------------------------------------------------

def make_tabular_dataset(dataset_url, rows=DEFAULT_TABULAR_ROWS,
                         dense_cols=13, sparse_cols=26,
                         days=DEFAULT_TABULAR_DAYS):
    """Materialize a Criteo-shaped plain-Parquet dataset, byte for byte the
    JAX scenario's (also the DLRM trainer's store,
    :mod:`petastorm_tpu_torch.models.tabular_dlrm`): ``day`` (int32),
    ``sample_index`` (int64, unique per row), ``label`` (int32),
    ``dense_<i>`` (float32) and ``cat_<i>`` (int64 ids below 10,000) from
    ``RandomState(7)``. Returns the rows written (``rows`` cut to a
    multiple of ``days``).

    Rows are written clustered by ``day`` (one row group per day chunk), so a
    ``filters=[("day", "=", k)]`` scan can prune (days-1)/days of the file
    from statistics alone — the property the scenario measures.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.fs_utils import FilesystemResolver

    resolver = FilesystemResolver(dataset_url)
    fs = resolver.filesystem()
    path = resolver.get_dataset_path()
    fs.create_dir(path, recursive=True)

    rng = np.random.RandomState(7)
    day = np.repeat(np.arange(days, dtype=np.int32), rows // days)
    rows = len(day)  # trim to an exact multiple
    columns = {"day": day,
               # Unique per-row key: lets the service/chaos scenarios check
               # delivery invariants (no lost rows, no duplicates) instead
               # of trusting row counts.
               "sample_index": np.arange(rows, dtype=np.int64),
               "label": rng.randint(0, 2, rows).astype(np.int32)}
    for i in range(dense_cols):
        columns[f"dense_{i}"] = rng.rand(rows).astype(np.float32)
    for i in range(sparse_cols):
        columns[f"cat_{i}"] = rng.randint(0, 10_000, rows).astype(np.int64)
    table = pa.table(columns)
    with fs.open_output_stream(path.rstrip("/") + "/part-00000.parquet") as f:
        # One row group per day: clustering is what makes stats selective.
        pq.write_table(table, f, row_group_size=rows // days)
    return rows


def tabular_predicate_scenario(dataset_url=None, rows=DEFAULT_TABULAR_ROWS,
                               days=DEFAULT_TABULAR_DAYS, workers=3):
    """Full scan vs predicate-pushdown scan over the wide tabular dataset."""
    from petastorm_tpu_torch.reader.reader import make_batch_reader

    tmpdir = None
    if dataset_url is None:
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_tabular_")
        dataset_url = f"file://{tmpdir}/ds"
        rows = make_tabular_dataset(dataset_url, rows=rows, days=days)

    def scan(**kwargs):
        seen = 0
        t0 = time.perf_counter()
        with make_batch_reader(dataset_url, reader_pool_type="thread",
                               workers_count=workers, num_epochs=1,
                               shuffle_row_groups=False, **kwargs) as reader:
            rowgroups = reader.diagnostics["rowgroups_total"]
            for batch in reader:
                # column-batch namedtuple: every field is an equal-length array
                seen += len(batch[0])
        return seen, time.perf_counter() - t0, rowgroups

    try:
        full_rows, full_s, full_rg = scan()
        sel_rows, sel_s, sel_rg = scan(filters=[("day", "=", 1)])
        return {
            "scenario": "tabular_predicate_pushdown",
            "rows": full_rows,
            "full_scan_rows_per_sec": round(full_rows / full_s, 1),
            "pushdown_rows_per_sec": round(sel_rows / sel_s, 1),
            "full_scan_rowgroups": full_rg,
            "pushdown_rowgroups": sel_rg,
            "rowgroups_pruned_pct": round(100.0 * (1 - sel_rg / full_rg), 1),
            "pushdown_wall_speedup": round(full_s / sel_s, 2),
        }
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Scenario: NGram multi-frame windows (config #4)
# ---------------------------------------------------------------------------

def make_ngram_dataset(dataset_url, frames=DEFAULT_NGRAM_FRAMES,
                       frame_shape=(32, 32, 3)):
    """Materialize a timestamped frame sequence (video/lidar stand-in)."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("FrameSchema", [
        UnischemaField("ts", np.int64, (), ScalarCodec(), False),
        UnischemaField("frame", np.float32, frame_shape, NdarrayCodec(), False),
        UnischemaField("ego_speed", np.float32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(11)

    def rows():
        for t in range(frames):
            yield {"ts": np.int64(t),
                   "frame": rng.rand(*frame_shape).astype(np.float32),
                   "ego_speed": np.float32(rng.rand())}

    materialize_rows(dataset_url, schema, rows(), rows_per_row_group=256)
    return schema


def ngram_window_scenario(dataset_url=None, frames=DEFAULT_NGRAM_FRAMES,
                          window=5, workers=3):
    """Windows/sec through make_reader + NGram (sort + delta_threshold)."""
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.reader.reader import make_reader

    tmpdir = None
    if dataset_url is None:
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_ngram_")
        dataset_url = f"file://{tmpdir}/ds"
        make_ngram_dataset(dataset_url, frames=frames)

    fields = {i: ["ts", "frame", "ego_speed"] for i in range(window)}
    ngram = NGram(fields, delta_threshold=1, timestamp_field="ts")
    try:
        windows = 0
        t0 = time.perf_counter()
        with make_reader(dataset_url, schema_fields=ngram, num_epochs=1,
                         reader_pool_type="thread", workers_count=workers,
                         shuffle_row_groups=False) as reader:
            for w in reader:
                windows += 1
                assert len(w) == window
        wall = time.perf_counter() - t0
        return {
            "scenario": "ngram_windows",
            "frames": frames,
            "window_length": window,
            "windows": windows,
            "windows_per_sec": round(windows / wall, 1),
            "frames_per_sec": round(windows * window / wall, 1),
        }
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Scenario: image classification input pipeline (config #2)
# ---------------------------------------------------------------------------

def make_image_dataset(dataset_url, rows=1024, image_shape=(64, 64, 3),
                       num_classes=10):
    """Materialize an ImageNet-shaped dataset (CompressedImageCodec)."""
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("ImageSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, image_shape,
                       CompressedImageCodec("jpeg"), False),
        UnischemaField("label", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(3)

    def rows_gen():
        for i in range(rows):
            yield {"id": i,
                   "image": rng.randint(0, 255, image_shape, dtype=np.uint8),
                   "label": np.int32(i % num_classes)}

    materialize_rows(dataset_url, schema, rows_gen(),
                     rows_per_row_group=128)


def image_pipeline_scenario(dataset_url=None, rows=1024, workers=3,
                            batch_size=128, device_stage="off",
                            device_prefetch=2, json_out=None, device="cuda"):
    """Row vs columnar decode throughput + loader stall on an image schema.

    The config-#2 shape (ImageNet + CompressedImageCodec): the number that
    matters is images/sec through the full delivery path and the columnar
    path's decode advantage over the reference's per-row architecture.

    ``device_stage="on"`` adds the on-card decode leg: the same columnar
    stream through ``make_torch_dataloader`` onto ``device`` (``"cuda"`` by
    default; raises without a card) with a :class:`DeviceStage` — raw uint8
    staged, cast + normalize on the device, ``device_prefetch`` batches in
    flight — reporting its images/sec, measured ``h2d_bytes_per_image``
    (bytes copied to a CUDA device: 0 on the CPU), and dispatch overlap.
    The decode legs and the plain loader leg stay on the host.
    ``json_out`` appends the result (knobs included) as one JSON line,
    BENCH-style.
    """
    import torch

    from petastorm_tpu_torch.ops.flash_attention import resolve_device
    from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
    from petastorm_tpu_torch.torch_utils import DeviceStage, make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator

    if device_stage not in ("on", "off"):
        raise ValueError(f"device_stage must be on|off, got {device_stage!r}")
    if device_stage == "on":
        device = resolve_device(device)  # before minutes of decode legs
    tmpdir = None
    if dataset_url is None:
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_image_")
        dataset_url = f"file://{tmpdir}/ds"
        make_image_dataset(dataset_url, rows=rows)

    def columnar_reader():
        return make_columnar_reader(dataset_url, num_epochs=1,
                                    shuffle_row_groups=False,
                                    reader_pool_type="thread",
                                    workers_count=workers,
                                    schema_fields=["image", "label"])

    def decode_leg(factory):
        reader = factory(dataset_url, num_epochs=1, shuffle_row_groups=False,
                         reader_pool_type="thread", workers_count=workers,
                         schema_fields=["image", "label"])
        n, t0 = 0, time.perf_counter()
        with reader:
            for batch in batch_iterator(reader, batch_size,
                                        last_batch="drop"):
                n += batch_size
        return n, n / (time.perf_counter() - t0)

    try:
        measured_rows, row_ips = decode_leg(make_reader)
        if measured_rows == 0:
            raise ValueError(
                f"Dataset at {dataset_url} yields no full batch of "
                f"{batch_size} rows — pass a smaller batch size")
        _, col_ips = decode_leg(make_columnar_reader)
        with make_torch_dataloader(columnar_reader(), batch_size,
                                   device="cpu") as loader:
            n = sum(1 for _ in loader)
            stall = loader.diagnostics["input_stall_pct"]
        result = {
            "scenario": "image_pipeline",
            "rows": measured_rows,  # full batches measured (drop policy)
            "row_decode_images_per_sec": round(row_ips, 1),
            "columnar_decode_images_per_sec": round(col_ips, 1),
            "columnar_vs_row": round(col_ips / row_ips, 2),
            "loader_batches": n,
            "loader_input_stall_pct": stall,
            "device_stage": device_stage,
            "device_prefetch": device_prefetch,
        }
        if device_stage == "on":
            stage = DeviceStage(normalize=(127.5, 127.5))

            def device_stage_pass():
                loader = make_torch_dataloader(columnar_reader(), batch_size,
                                               last_batch="drop",
                                               non_tensor_policy="drop",
                                               device_prefetch=device_prefetch,
                                               device_stage=stage,
                                               device=device)
                rows_seen, t0 = 0, time.perf_counter()
                with loader:
                    for batch in loader:
                        rows_seen += batch_size
                    if device.type == "cuda":
                        # The pass ends when the last batch's stage ran,
                        # not when it was queued.
                        torch.cuda.synchronize(device)
                return rows_seen, time.perf_counter() - t0, loader

            # Warm pass first: the allocator, the pinned buffers and the
            # page cache would otherwise ride inside the one timed window.
            device_stage_pass()
            n_rows, wall, loader = device_stage_pass()
            diag = loader.diagnostics
            result.update({
                "device_stage_images_per_sec": round(n_rows / wall, 1),
                "device_stage_input_stall_pct": diag["input_stall_pct"],
                "dispatch_overlap_pct": diag["dispatch_overlap_pct"],
                "h2d_bytes_per_image": round(
                    diag["h2d_bytes"] / max(1, diag["rows"]), 1),
            })
        if json_out:
            import json

            with open(json_out, "a", encoding="utf-8") as f:
                f.write(json.dumps(result) + "\n")
        return result
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Scenario: weighted multi-corpus mixing (config #5)
# ---------------------------------------------------------------------------

def weighted_mixing_scenario(dataset_url=None, rows=8_192, workers=2,
                             weights=(0.8, 0.2)):
    """Throughput + empirical mix ratio through WeightedSamplingReader.

    The config-#5 shape: several corpora mixed by sampling probability, each
    corpus row-group-sharded per host (here: two synthetic corpora tagged by
    a ``corpus`` column; the reported ratio should track ``weights``).
    ``dataset_url``: optional base url; corpora are written under it.
    """
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.schema.codecs import ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    schema = Unischema("MixSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("corpus", np.int32, (), ScalarCodec(), False),
        UnischemaField("value", np.float32, (32,), None, False),
    ])

    urls = [f"{dataset_url.rstrip('/')}/corpus_{c}"
            for c in range(len(weights))] if dataset_url else None
    tmpdir = None
    if dataset_url is None:
        # Synthesize only when no url is given (a provided url must already
        # hold corpus_<i> datasets — never overwritten).
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_mix_")
        rng = np.random.RandomState(13)
        urls = []
        per_corpus = rows // len(weights)
        for corpus in range(len(weights)):
            url = f"file://{tmpdir}/corpus_{corpus}"
            rows_gen = ({"id": i, "corpus": np.int32(corpus),
                         "value": rng.rand(32).astype(np.float32)}
                        for i in range(per_corpus))
            materialize_rows(url, schema, rows_gen, rows_per_row_group=256)
            urls.append(url)

    try:
        readers = [make_reader(u, num_epochs=None, reader_pool_type="thread",
                               workers_count=workers) for u in urls]
        draws = min(rows, 4_096)
        counts = np.zeros(len(weights), np.int64)
        with WeightedSamplingReader(readers, list(weights),
                                    random_seed=17) as mixed:
            t0 = time.perf_counter()
            for _ in range(draws):
                counts[int(next(mixed).corpus)] += 1
            wall = time.perf_counter() - t0
        ratio = (counts / counts.sum()).round(3).tolist()
        return {
            "scenario": "weighted_mixing",
            "rows_drawn": int(counts.sum()),
            "rows_per_sec": round(counts.sum() / wall, 1),
            "target_weights": list(weights),
            "empirical_mix": ratio,
        }
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Scenario: converter-driven multi-corpus mixing (config #5, full pipeline)
# ---------------------------------------------------------------------------

def converter_mixing_scenario(dataset_url=None, rows=8_192,
                              weights=(0.8, 0.2), batch_size=256,
                              batches=24, workers=2):
    """Config #5 measured END-TO-END through the converter: N in-memory
    Arrow tables -> ``make_spark_converter`` (content-hash
    materialization) -> ``make_batch_reader`` per corpus ->
    ``WeightedSamplingReader`` mix -> ``make_torch_dataloader`` on the host
    — throughput and empirical mix ratio of what the training loop actually
    receives (``weighted_mixing_scenario`` benches the sampler alone; this
    one pays the whole pipeline). The JAX scenario builds pandas frames of
    the same columns; the tables here need no pandas (a GPU host may lack
    it), and the converter writes the same rows (its content hash
    differs: pandas adds schema metadata to the table it hands over).

    ``dataset_url``: optional parent cache directory for the converter's
    materialization (default: a fresh tmpdir, removed afterwards).
    """
    import pyarrow as pa

    import petastorm_tpu_torch.spark.dataset_converter as dc
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.spark.dataset_converter import (
        make_spark_converter, set_parent_cache_dir_url)
    from petastorm_tpu_torch.torch_utils import make_torch_dataloader
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    prev_cache_dir = dc._parent_cache_dir_url
    tmpdir = None
    if dataset_url is None:
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_convmix_")
        set_parent_cache_dir_url(f"file://{tmpdir}")
    else:
        set_parent_cache_dir_url(dataset_url)
    rng = np.random.RandomState(29)
    per_corpus = rows // len(weights)
    converters, readers = [], []
    try:
        for corpus in range(len(weights)):
            frame = pa.table({
                "id": np.arange(per_corpus, dtype=np.int64),
                "corpus": np.full(per_corpus, corpus, np.int32),
                "value": rng.rand(per_corpus).astype(np.float32),
            })
            converters.append(make_spark_converter(
                frame, parquet_row_group_size_bytes=4096))
        readers = [make_batch_reader(c.cache_dir_url, num_epochs=None,
                                     reader_pool_type="thread",
                                     workers_count=workers)
                   for c in converters]
        counts = np.zeros(len(weights), np.int64)
        n_batches = 0
        with WeightedSamplingReader(readers, list(weights),
                                    random_seed=31) as mixed:
            loader = make_torch_dataloader(mixed, batch_size,
                                           max_batches=batches,
                                           device="cpu")
            t0 = time.perf_counter()
            with loader:
                for batch in loader:
                    tags, tag_counts = np.unique(batch["corpus"].numpy(),
                                                 return_counts=True)
                    counts[tags] += tag_counts
                    n_batches += 1
            wall = time.perf_counter() - t0
        ratio = (counts / counts.sum()).round(3).tolist()
        return {
            "scenario": "converter_mixing",
            "batches": n_batches,
            "rows_drawn": int(counts.sum()),
            "rows_per_sec": round(counts.sum() / wall, 1),
            "target_weights": list(weights),
            "empirical_mix": ratio,
        }
    finally:
        for c in converters:
            c.delete()
        set_parent_cache_dir_url(prev_cache_dir)  # restore the global
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Scenario: packed sequence delivery (ragged docs -> pack_ragged -> loader)
# ---------------------------------------------------------------------------

def packed_delivery_scenario(dataset_url=None, docs=2_048, max_len=48,
                             slot_len=96, slots=8, feature_dim=8,
                             workers=3):
    """Packed vs padded delivery of a ragged-sequence corpus: tokens/sec
    through ``make_packed_torch_dataloader`` on the host and the slot
    utilization of each layout — the FLOP-waste number packing exists to
    fix (every padding slot burns tensor-core cycles at train time).

    ``dataset_url``: optional location for the generated corpus (default:
    a fresh tmpdir, removed afterwards).
    """
    from petastorm_tpu_torch import make_columnar_reader
    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.torch_utils import (PACK_POSITION_KEY,
                                                 PACK_SEGMENT_KEY,
                                                 make_packed_torch_dataloader,
                                                 packed_valid_mask)
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

    schema = Unischema("PackedBench", [
        UnischemaField("seq", np.float32, (max_len, feature_dim),
                       NdarrayCodec(), False),
        UnischemaField("length", np.int32, (), ScalarCodec(), False),
    ])
    rng = np.random.RandomState(41)

    def rows():
        for _ in range(docs):
            n = int(rng.randint(4, max_len + 1))
            seq = np.zeros((max_len, feature_dim), np.float32)
            seq[:n] = rng.rand(n, feature_dim)
            yield {"seq": seq, "length": np.int32(n)}

    tmpdir = None
    if dataset_url is None:
        # Synthesize only when no dataset was supplied — --dataset-url
        # reuses an existing ragged corpus (seq + length columns), like
        # every other scenario.
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_packed_")
        dataset_url = f"file://{tmpdir}/ds"
        materialize_rows(dataset_url, schema, rows(),
                         rows_per_row_group=256)
    try:
        reader = make_columnar_reader(dataset_url, num_epochs=1,
                                      shuffle_row_groups=False,
                                      workers_count=workers)
        loader = make_packed_torch_dataloader(
            reader, slot_len=slot_len, slots=slots,
            sequence_fields=["seq"], length_field="length",
            device="cpu")
        valid = total = batches = doc_count = observed_max = 0
        t0 = time.perf_counter()
        with loader:
            for batch in loader:
                seg = batch[PACK_SEGMENT_KEY].numpy()
                pos = batch[PACK_POSITION_KEY].numpy()
                mask = packed_valid_mask(seg)
                valid += int(mask.sum())
                total += seg.size
                batches += 1
                # Positions encode the doc structure for free: each doc
                # contributes exactly one valid position-0 token, and the
                # longest doc is max(position) + 1 (vectorized — keeps the
                # timed region free of per-segment Python loops).
                doc_count += int(((pos == 0) & mask).sum())
                if mask.any():
                    observed_max = max(observed_max, int(pos.max()) + 1)
        wall = time.perf_counter() - t0
        # The padded alternative pads every doc to the dataset's STATIC
        # on-disk max length (the sequence field's schema shape) — the
        # run-invariant baseline; longest-observed-length is the fallback
        # only when the schema leaves the length dimension open.
        field = reader.schema.fields["seq"]
        static_max = (field.shape[0]
                      if field.shape and field.shape[0] is not None
                      else None)
        pad_len = static_max if static_max is not None else observed_max
        return {
            "scenario": "packed_delivery",
            "docs": doc_count,
            "batches": batches,
            "tokens_per_sec": round(valid / wall, 1),
            "packed_utilization": round(valid / max(total, 1), 3),
            "padded_utilization": round(
                valid / max(doc_count * pad_len, 1), 3),
            "padded_baseline": ("static_schema_max_len"
                                if static_max is not None
                                else "longest_observed_doc"),
        }
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)


def _parse_predicate(spec):
    """``FIELD:OP:VALUE[:MODULUS]`` (or a ColumnPredicate / wire dict) →
    :class:`~petastorm_tpu_torch.predicates.ColumnPredicate`. VALUE parses as
    int, then float, then string; ``in``/``not-in`` take a
    comma-separated VALUE list."""
    if spec is None:
        return None
    from petastorm_tpu_torch.predicates import ColumnPredicate

    if isinstance(spec, ColumnPredicate):
        return spec
    if isinstance(spec, dict):
        return ColumnPredicate.from_wire(spec)

    def scalar(text):
        for cast in (int, float):
            try:
                return cast(text)
            except ValueError:
                continue
        return text

    parts = str(spec).split(":")
    if len(parts) not in (3, 4):
        raise ValueError(
            f"--predicate must be FIELD:OP:VALUE[:MODULUS], got {spec!r}")
    field, op, value = parts[0], parts[1], parts[2]
    parsed = ([scalar(v) for v in value.split(",")]
              if op in ("in", "not-in") else scalar(value))
    modulus = int(parts[3]) if len(parts) == 4 else None
    return ColumnPredicate(field, op, parsed, modulus=modulus)


# ---------------------------------------------------------------------------
# Scenario: disaggregated data service, loopback (dispatcher + workers +
# client all on 127.0.0.1 — the serving tier's overhead vs a local reader)
# ---------------------------------------------------------------------------

def service_loopback_scenario(dataset_url=None, rows=DEFAULT_TABULAR_ROWS,
                              days=DEFAULT_TABULAR_DAYS, workers=2,
                              batch_size=512, mode="static", skew_ms=0.0,
                              credits=8, json_out=None, chaos=None,
                              chaos_interval_s=1.5, chaos_max_events=4,
                              chaos_seed=None, failpoint_points=None,
                              failpoint_window=None,
                              failpoint_delay_s=None,
                              failpoint_targets=None,
                              failpoint_max_fires=None,
                              journal_dir=None,
                              metrics_port=None,
                              trace_out=None, epochs=1, cache="off",
                              cache_mem_mb=256.0, cache_dir=None,
                              fleet_cache=False,
                              fleet_cache_drain_after=None,
                              sharding=None, shuffle_seed=None,
                              ordered=False, predicate=None,
                              filter_placement="client", transport=None,
                              hedging=False, hedge_floor_s=0.25,
                              hedge_min_samples=16, hedge_quantile=0.99,
                              hedge_multiplier=4.0, brownout=None):
    """Rows/sec through the full disaggregated path: dispatcher + ``workers``
    batch workers + one client, all over loopback TCP, streamed into a
    host ``TorchDataLoader`` (``device="cpu"``: this measures the serving
    tier, as the JAX scenario's ``stage_to_device=False`` loader does) via
    ``ServiceBatchSource`` — against the same dataset
    read by a local ``make_batch_reader`` pipeline, so the number reported
    is the serving tier's overhead (serialize → TCP → deserialize) at
    one-machine scale. ``workers`` is the number of batch workers; each runs
    a 2-thread reader pool.

    ``skew_ms`` is fault injection for the head-of-line question: the FIRST
    worker sleeps that long before every batch send. Under the multiplexed
    drain the client's throughput stays bounded by the fast workers'
    buffered output (the slow worker's stall shows up in
    ``per_worker_stall_s``, not in delivery); a blocking round-robin drain
    would serialize every fast batch behind the slow one. ``credits`` is
    the per-worker flow-control window handed to the client.

    ``transport`` pins the delivery tier for both ends of the fleet:
    ``"tcp"`` forces the framed sockets everywhere, ``"shm"``/``"auto"``
    negotiate the shared-memory ring per stream (always granted on
    loopback; ``docs/guides/service.md#transport-tiers``). Delivery
    semantics are identical across tiers, so two same-seed ``ordered``
    runs that differ only in ``transport`` must report equal
    ``stream_digest`` values — the scenario's cheap invariance check.

    ``chaos`` arms the fault-injection harness
    (:mod:`petastorm_tpu_torch.service.chaos`): ``"dispatcher-restart"`` (crash +
    journal-replay restart on the same port), ``"worker-kill"``,
    ``"conn-drop"``, or a comma-separated mix, injected every
    ``chaos_interval_s`` while the epoch streams, at most
    ``chaos_max_events`` times (``None`` = unbounded — note that repeated
    ``conn-drop`` restarts every in-flight piece set, so an unbounded
    drop rate faster than a piece set streams never converges).
    ``"failpoints"`` is different in kind: instead of timed external
    events it arms the process-wide **seeded failpoint schedule**
    (:mod:`petastorm_tpu_torch.failpoints`) for the run — torn frames and
    connection resets inside the framed transport, dropped dispatcher
    replies AFTER the state mutation applied, WAL append/fsync ENOSPC,
    damaged cache-entry writes — each fired at call indices derived from
    ``chaos_seed``, so two runs of one seed inject the identical fault
    sequence (the injection log lands in the result as
    ``failpoint_injections``). ``chaos_seed`` also drives the TIMED
    kinds' event sequence (action choice + interval jitter via the seed
    tree), making every chaos run reproducible from its ``--json-out``
    line. The scenario then checks
    delivery invariants on the dataset's unique ``sample_index`` — zero
    lost rows always; zero duplicates too when only the control plane was
    perturbed (dispatcher restarts) — and RAISES if they are violated, so
    a chaos run doubles as an acceptance check. All workers are paced
    ~30 ms/batch under chaos so the epoch outlasts the injections.
    Recovery counters land in the result (``dispatcher_recovery``,
    ``client_recovery``, ``chaos_events``).

    The result is BENCH-style (``metric``/``value``/``unit``/
    ``vs_baseline`` + detail keys, one JSON object); ``json_out`` appends
    it as one JSON line to that path so skew/loopback numbers land in the
    perf trajectory instead of stdout only. The ``telemetry`` key carries
    the final metrics-registry snapshot plus per-stage p50/p99 latency
    quantiles from the loader histograms — distributions, not just means.

    ``metrics_port`` serves the process's metrics registry in Prometheus
    text format for the run's duration (0 picks a free port; the bound
    address lands in the result as ``metrics_address``). ``trace_out``
    arms batch-lifecycle tracing and writes Perfetto-loadable Chrome
    ``trace_event`` JSON there: every batch id carries contiguous spans
    from worker decode through client queue to device dispatch
    (``docs/guides/diagnostics.md#metrics-and-tracing``).

    ``epochs`` streams the dataset that many times through ONE loader
    iteration (dispatcher-owned epoch tracking), and the result carries a
    per-epoch breakdown (``epochs_detail``: rows, wall, rows/s, and the
    fleet's cache hit rate within each epoch) — the cold-vs-warm epoch
    trajectory. ``cache`` arms the workers' decoded-batch cache
    (``off`` | ``mem`` | ``mem+disk``; ``docs/guides/caching.md``) with
    ``cache_mem_mb`` of host RAM per worker; under ``mem+disk`` every
    worker shares ``cache_dir`` (default: a scenario-owned tempdir), so a
    takeover after ``--chaos worker-kill`` re-serves the victim's pieces
    from the disk tier instead of re-decoding them. The ``cache-corrupt``
    chaos kind (requires ``mem+disk`` and ``epochs >= 2``; clamps the
    memory tier to ~0 so warm loads actually read the damaged disk files)
    truncates / bit-flips disk-tier entry files mid-run and asserts the
    fleet counted at least one ``cache_corrupt_entries`` while delivery
    stayed intact — corrupt entries degrade to fresh decode, never to bad
    bytes.

    ``hedging`` arms the client's hedged watermark re-serves
    (``docs/guides/service.md#failure-model-and-recovery``): a stream
    silent past the fitted inter-batch-gap threshold gets its in-flight
    piece re-granted at its watermark from a peer worker, first
    ``piece_done`` wins, duplicates drop through the exactly-once dedup
    — so a hedged run's ``stream_digest`` must equal the unhedged
    same-seed run's. ``hedge_floor_s``/``hedge_min_samples``/``hedge_quantile``/
    ``hedge_multiplier`` tune the trigger for short benchmark epochs
    (with a few dozen gap samples the p99 IS the injected stall —
    fitting ``quantile=0.5`` keeps the threshold anchored to the
    healthy gap scale); the race tallies land in the result as
    ``hedge_counts``. ``brownout`` arms the dispatcher's
    journaled overload-shedding state machine (``True`` for defaults or
    a config dict — see :class:`petastorm_tpu_torch.service.resilience.\
BrownoutConfig`).

    ``shuffle_seed`` arms the dispatcher's seed-tree deterministic
    shuffle; ``ordered`` re-sequences client delivery into the canonical
    piece order. The result always carries ``stream_digest`` — an
    order-sensitive blake2b of every delivered batch's bytes — so two
    ``--json-out`` lines assert run-to-run determinism by string
    equality (byte-identity needs ``ordered``; without it the digest
    still certifies WHAT arrived, not the interleaving; the loader's tensors
    hash as the numpy arrays they view, so a same-seed ordered digest equals
    the JAX scenario's). Chaos delivery
    invariants are exactly-once on every path: zero lost rows AND zero
    duplicates under dispatcher restarts, worker kills, and connection
    drops alike (per-piece watermarks re-grant at the delivery cursor;
    ``docs/guides/service.md#delivery-semantics``).
    """
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.service import (BatchWorker, Dispatcher,
                                             ServiceBatchSource)
    from petastorm_tpu_torch.service.chaos import (CHAOS_KINDS, ChaosInjector,
                                                   StreamDigest,
                                                   cache_corrupt_action,
                                                   connection_drop_action,
                                                   delivery_invariants,
                                                   dispatcher_restart_action,
                                                   job_cancel_action,
                                                   worker_drain_action,
                                                   worker_kill_action)
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    # --sharding is the canonical knob name (static|fcfs|dynamic); `mode`
    # stays as the original spelling.
    mode = sharding or mode
    if mode not in ("static", "fcfs", "dynamic"):
        raise ValueError(
            f"sharding must be static|fcfs|dynamic, got {mode!r}")
    # --predicate FIELD:OP:VALUE[:MODULUS] — a declared row filter
    # (docs/guides/pipeline.md#graph-rewrites). --filter-placement picks
    # the topology: "client" masks received batches trainer-side (the
    # baseline), "worker" hoists the filter below the workers' decode.
    predicate_obj = _parse_predicate(predicate)
    if filter_placement not in ("client", "worker"):
        raise ValueError(
            f"filter-placement must be client|worker, got "
            f"{filter_placement!r}")
    # --transport auto|tcp|shm pins the delivery tier for BOTH ends of
    # the loopback fleet (docs/guides/service.md#transport-tiers);
    # delivery semantics are byte-identical across tiers, so same-seed
    # ordered digests must compare equal between tcp and shm runs.
    from petastorm_tpu_torch.service.transport import resolve_mode

    transport = resolve_mode(transport)
    chaos_kinds = ([k.strip() for k in chaos.split(",") if k.strip()]
                   if isinstance(chaos, str) else list(chaos or []))
    if predicate_obj is not None and chaos:
        raise ValueError(
            "--predicate cannot combine with --chaos: the chaos delivery "
            "invariants assert the FULL row multiset, which a row filter "
            "deliberately thins")
    for kind in chaos_kinds:
        if kind not in CHAOS_KINDS:
            raise ValueError(
                f"unknown chaos kind {kind!r}; choose from {CHAOS_KINDS}")
    if chaos_kinds and mode == "fcfs":
        raise ValueError("chaos invariants need static or dynamic sharding "
                         "(fcfs has no per-client delivery contract to "
                         "check)")
    if chaos_kinds and dataset_url is not None:
        raise ValueError(
            "chaos delivery invariants are checked against the scenario's "
            "own synthesized dataset (unique sample_index per row, known "
            "row count) — omit --dataset-url when --chaos is armed")
    if "cache-corrupt" in chaos_kinds:
        if cache != "mem+disk":
            raise ValueError(
                "--chaos cache-corrupt damages disk-tier entry files: it "
                "needs --cache mem+disk")
        if epochs < 2:
            raise ValueError(
                "--chaos cache-corrupt needs --epochs >= 2: entries fill "
                "during epoch 1 and only a warm epoch LOADS them, which "
                "is where corruption detection (and the degrade-to-fresh-"
                "decode path) runs")
        if cache_mem_mb > 1.0:
            # A roomy memory tier answers every warm lookup from RAM, so
            # the damaged disk files are never loaded and the run fails
            # its own >=1-corrupt-entry-detected assertion despite
            # nothing being wrong. This leg exists to exercise the disk
            # load path — force it.
            import logging

            logging.getLogger(__name__).warning(
                "cache-corrupt: clamping cache_mem_mb %s -> 0.001 so "
                "warm loads hit the disk tier (memory hits would never "
                "read the damaged files)", cache_mem_mb)
            cache_mem_mb = 0.001

    from petastorm_tpu_torch.cache_impl import CacheConfig

    # Fleet cache tier (docs/guides/caching.md#fleet-cache-tier): every
    # worker joins the consistent-hash ring; --fleet-cache-drain-after N
    # drains the first worker after the client has consumed N batches —
    # a call-count trigger (not a timer), so the drain (and the warm
    # handoff it kicks off) lands at the same stream position on every
    # run of a seeded schedule.
    if fleet_cache and cache == "off":
        raise ValueError(
            "--fleet-cache places decoded-batch cache entries on the "
            "peer ring: it needs --cache mem or mem+disk")
    if fleet_cache_drain_after is not None and not fleet_cache:
        raise ValueError(
            "--fleet-cache-drain-after drives the warm-handoff path: "
            "arm --fleet-cache with it")
    if fleet_cache_drain_after is not None and workers < 2:
        raise ValueError(
            "--fleet-cache-drain-after needs >= 2 workers: a drained "
            "worker's entries must have a surviving peer to land on")

    if epochs < 1:
        raise ValueError("epochs must be >= 1")
    if epochs > 1 and mode == "fcfs":
        raise ValueError(
            "--epochs > 1 requires static or dynamic sharding: fcfs "
            "clients report no per-client epoch boundaries, so the "
            "per-epoch breakdown would silently lump every epoch into one "
            "row. fcfs is also single-tenant by construction — its one "
            "shared queue has no per-job assignment, so the dispatcher "
            "rejects register_job under it. Use --sharding dynamic for "
            "multi-epoch streams, work-stealing rebalancing, and "
            "multi-job fleets (--sharding static also supports both)")
    cache_tmp = None
    if cache == "mem+disk" and cache_dir is None:
        # One SHARED disk tier for the whole fleet (atomic-rename writes
        # make that safe): a worker-kill takeover re-serves the victim's
        # warm pieces from disk instead of re-decoding.
        cache_tmp = tempfile.mkdtemp(prefix="petastorm_tpu_torch_batchcache_")
        cache_dir = cache_tmp
    # Constructed with the FINAL directory so CacheConfig's own
    # validation runs (e.g. --cache-dir without mem+disk is rejected).
    cache_config = CacheConfig(mode=cache, mem_mb=cache_mem_mb,
                               cache_dir=cache_dir)

    tmpdir = None
    if dataset_url is None:
        tmpdir = tempfile.mkdtemp(prefix="petastorm_tpu_torch_service_")
        dataset_url = f"file://{tmpdir}/ds"
        rows = make_tabular_dataset(dataset_url, rows=rows, days=days)
    journal_tmp = None
    if chaos_kinds and journal_dir is None:
        journal_tmp = tempfile.mkdtemp(prefix="petastorm_tpu_torch_journal_")
        journal_dir = journal_tmp

    # "failpoints" is the seeded in-process schedule, not a timed external
    # event — only the TIMED kinds need an injector thread and the pacing
    # that makes the epoch span its intervals (failpoints fire on call
    # counts, so the epoch needs no minimum wall time).
    timed_kinds = [k for k in chaos_kinds if k != "failpoints"]
    chaos_pace_s = 0.03 if timed_kinds else 0.0
    lease_timeout_s = 2.0 if chaos_kinds else 30.0

    # Flight-recorder breadcrumb (telemetry/flight.py): a chaos run that
    # dies mid-flight dumps a ring whose FIRST useful entry says what
    # configuration was running.
    from petastorm_tpu_torch.telemetry.flight import RECORDER as _FLIGHT

    _FLIGHT.note("scenario.start", scenario="service", sharding=mode,
                 chaos=",".join(chaos_kinds) or None,
                 chaos_seed=chaos_seed, epochs=epochs)

    def make_dispatcher(host="127.0.0.1", port=0):
        # The restart factory passes the SAME shuffle_seed: the journal
        # guard refuses a seed change mid-run (it would silently shift
        # the piece order and break the determinism contract).
        return Dispatcher(host=host, port=port, mode=mode,
                          num_epochs=epochs, journal_dir=journal_dir,
                          lease_timeout_s=lease_timeout_s,
                          shuffle_seed=shuffle_seed,
                          brownout=brownout)

    # Telemetry arming and every node start happen INSIDE the try: a
    # failing dispatcher/worker start must still stop the HTTP server +
    # snapshot-ring threads and disarm the trace collector (the tier-1
    # leak guard would otherwise cascade one failure into many).
    metrics_server = None
    trace_armed = False
    dispatcher_holder = []
    fleet = []
    injector = None
    failpoint_schedule = None
    try:
        if metrics_port is not None:
            from petastorm_tpu_torch.telemetry.http import MetricsServer

            metrics_server = MetricsServer(port=metrics_port,
                                           snapshot_interval_s=1.0).start()
        if trace_out:
            from petastorm_tpu_torch.telemetry import tracing

            tracing.COLLECTOR.acquire()
            trace_armed = True
        dispatcher_holder.append(make_dispatcher().start())
        for i in range(workers):
            # Appended one by one so a failing start() mid-fleet still
            # leaves the already-started workers in `fleet` for teardown.
            fleet.append(BatchWorker(
                dataset_url,
                dispatcher_address=dispatcher_holder[0].address,
                batch_size=batch_size, reader_factory="batch",
                worker_id=f"bench-worker-{i}",
                batch_delay_s=max(skew_ms / 1000.0 if i == 0 else 0.0,
                                  chaos_pace_s),
                # Fleet-cache runs need snappy heartbeats too: the peer
                # ring and the drain-edge handoff both ride them.
                heartbeat_interval_s=(0.5 if (chaos_kinds or fleet_cache)
                                      else 5.0),
                batch_cache=cache_config.build(),
                fleet_cache=fleet_cache,
                transport=transport,
                reader_kwargs={"workers_count": 2}).start())
        if fleet_cache:
            # Stream only after every worker's placement ring converged
            # on the full fleet: registration seeds each joiner's ring,
            # but earlier joiners learn of later ones via heartbeat — a
            # short run racing that first tick would fill every entry
            # against a partial ring and never exercise the warm paths.
            expected = {w.worker_id for w in fleet}
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if all(set(w._fleet_tier.ring_peers()) == expected
                       for w in fleet):
                    break
                time.sleep(0.02)
            else:
                raise RuntimeError(
                    "fleet cache ring did not converge on "
                    f"{sorted(expected)} within 10s")
        source = ServiceBatchSource(
            dispatcher_holder[0].address, credits=credits, ordered=ordered,
            heartbeat_interval_s=0.3 if chaos_kinds else 2.0,
            predicate=predicate_obj,
            filter_placement=(filter_placement if predicate_obj is not None
                              else "client"),
            # Snappy rebalance loop: steal latency is what the dynamic
            # skew leg measures, and the sync RPC is a tiny control
            # message (drained workers poke the loop anyway). Every 50 ms
            # the straggler commits to ~1 more batch it could have shed.
            dynamic_sync_interval_s=0.05,
            transport=transport,
            hedging=hedging, hedge_floor_s=hedge_floor_s,
            hedge_min_samples=hedge_min_samples,
            hedge_quantile=hedge_quantile,
            hedge_multiplier=hedge_multiplier)
        loader = TorchDataLoader(None, source, device="cpu",
                                 trace_path=trace_out or None)
        if "failpoints" in chaos_kinds:
            from petastorm_tpu_torch import failpoints as failpoints_mod

            # Armed AFTER bring-up so the schedule's budget lands on the
            # streaming epoch, not on registration; derived entirely from
            # the seed, so the same --chaos-seed replays byte-identically.
            # ``failpoint_points`` restricts the armed vocabulary (the
            # fuzzer's shrinker; a comma string from the CLI); a replay
            # PIN uses ``failpoint_window`` well below every armed
            # point's call count, so both runs reach every scheduled
            # fire and the logs compare equal.
            if isinstance(failpoint_points, str):
                failpoint_points = tuple(
                    p.strip() for p in failpoint_points.split(",")
                    if p.strip())
            schedule_kwargs = {"points": failpoint_points}
            if failpoint_window is not None:
                schedule_kwargs["window"] = int(failpoint_window)
            # Straggler shaping (the overload_tail leg + hedge tests):
            # a bigger delay makes "delay" actions real stalls, targets
            # pin a point to ONE site's key (e.g. one worker id) so the
            # straggler is deterministic, max_fires sets how often.
            if failpoint_delay_s is not None:
                schedule_kwargs["delay_s"] = float(failpoint_delay_s)
            if failpoint_targets is not None:
                schedule_kwargs["targets"] = dict(failpoint_targets)
            if failpoint_max_fires is not None:
                schedule_kwargs["max_fires_per_point"] = int(
                    failpoint_max_fires)
            failpoint_schedule = failpoints_mod.arm(
                failpoints_mod.FaultSchedule(
                    chaos_seed if chaos_seed is not None else 0,
                    **schedule_kwargs))
        if timed_kinds:
            actions = []
            for kind in timed_kinds:
                if kind == "dispatcher-restart":
                    actions.append((kind, dispatcher_restart_action(
                        dispatcher_holder, make_dispatcher)))
                elif kind == "worker-kill":
                    actions.append((kind, worker_kill_action(fleet)))
                elif kind == "cache-corrupt":
                    actions.append((kind, cache_corrupt_action(cache_dir)))
                elif kind == "job-cancel":
                    actions.append((kind, job_cancel_action(
                        lambda: dispatcher_holder[0].address)))
                elif kind == "worker-drain":
                    actions.append((kind, worker_drain_action(
                        lambda: dispatcher_holder[0])))
                else:
                    actions.append((kind, connection_drop_action(
                        lambda: [dispatcher_holder[0]] + fleet)))
            injector = ChaosInjector(actions,
                                     interval_s=chaos_interval_s,
                                     max_events=(chaos_max_events
                                                 or None),
                                     seed=chaos_seed).start()
        def fleet_cache_totals():
            """Summed (hits, misses) across the fleet's batch caches, or
            ``None`` when caching is off."""
            hits = misses = 0
            armed = False
            for worker in fleet:
                stats = worker.cache_stats()
                if stats is not None:
                    armed = True
                    hits += stats["hits"]
                    misses += stats["misses"]
            return (hits, misses) if armed else None

        served_rows = batches = 0
        got_ids = []
        arrivals = []  # (elapsed_s, cumulative rows) per batch
        digest = StreamDigest()
        t0 = time.perf_counter()
        with loader:
            for batch in loader:
                batches += 1
                served_rows += len(next(iter(batch.values())))
                digest.update(batch)
                if chaos_kinds and "sample_index" in batch:
                    got_ids.extend(int(i) for i in batch["sample_index"])
                arrivals.append((time.perf_counter() - t0, served_rows))
                if fleet_cache_drain_after is not None \
                        and batches == int(fleet_cache_drain_after):
                    # Deterministic mid-stream drain: triggered by the
                    # consumed-batch count, so seeded replays drain at
                    # the identical stream position. The worker's next
                    # heartbeat sees "draining" and ships its warm
                    # entries to the peers inheriting its ring segments.
                    dispatcher_holder[0].drain_worker(
                        "bench-worker-0",
                        reason="fleet-cache scenario drain")
                    # Post-drain barrier: the handoff launches on the
                    # drained worker's next heartbeat and journals its
                    # cache_handoff record AFTER the entries shipped —
                    # waiting for the record means everything consumed
                    # from here on measures the handed-off (warm)
                    # fleet, not a race against the shipping thread.
                    # Bounded and best-effort: a handoff that never
                    # reports just leaves the rest of the stream to
                    # cold-fill, which the per-run counters expose.
                    barrier = time.monotonic() + 10.0
                    while time.monotonic() < barrier \
                            and not dispatcher_holder[0].cache_handoffs():
                        time.sleep(0.02)
        service_wall = time.perf_counter() - t0
        epoch_starts = [(int(count), int(epoch_num)) for count, epoch_num
                        in source.diagnostics["epoch_starts"]]
        # Exact per-epoch cache attribution: workers bucket every lookup
        # by the requesting stream's epoch (the stream header carries it),
        # so prefetch-ahead lookups never smear into the previous epoch.
        cache_by_epoch = {}
        for worker in fleet:
            for worker_epoch, bucket in worker.cache_stats_by_epoch().items():
                totals = cache_by_epoch.setdefault(worker_epoch,
                                                   {"hits": 0, "misses": 0})
                totals["hits"] += bucket["hits"]
                totals["misses"] += bucket["misses"]
        if injector is not None:
            injector.stop()
        # Delivery timeline: when half the rows had reached the trainer.
        # Under skew this is the head-of-line number — a blocking drain
        # paces EVERY delivery at the slow worker's rate (half at ~half the
        # wall), the multiplexed drain front-loads the fast workers'
        # batches (half at roughly the fast workers' production time).
        time_to_half = next((t for t, n in arrivals
                             if n >= served_rows / 2), service_wall)
        stall_pct = loader.diagnostics["input_stall_pct"]
        source_diag = source.diagnostics

        # Per-epoch breakdown: the client's epoch_starts give exact batch
        # boundaries in production order (= consumption order, FIFO), so
        # each epoch's rows and wall fall straight out of the arrivals
        # timeline — cold-vs-warm throughput becomes visible in BENCH
        # trajectories instead of being averaged away.
        epochs_detail = []
        # Keep the client-reported epoch NUMBER with each boundary (a
        # resumed client starts past 0; an empty epoch shares its start
        # count with the next) — the worker cache buckets are keyed by
        # that same number via the stream header, so the join is exact.
        for index, (first, epoch_num) in enumerate(epoch_starts):
            last = (epoch_starts[index + 1][0]
                    if index + 1 < len(epoch_starts) else len(arrivals))
            if first >= last:
                continue
            prev_t, prev_rows = ((0.0, 0) if first == 0
                                 else arrivals[first - 1])
            end_t, end_rows = arrivals[last - 1]
            epoch_wall = max(1e-9, end_t - prev_t)
            epoch_rows = end_rows - prev_rows
            detail = {
                "epoch": epoch_num,
                "rows": epoch_rows,
                "wall_s": round(epoch_wall, 3),
                "rows_per_s": round(epoch_rows / epoch_wall, 1),
            }
            bucket = cache_by_epoch.get(epoch_num)
            if bucket is not None:
                lookups = bucket["hits"] + bucket["misses"]
                detail["cache_hits"] = bucket["hits"]
                detail["cache_misses"] = bucket["misses"]
                detail["cache_hit_rate"] = round(
                    bucket["hits"] / lookups, 4) if lookups else None
            epochs_detail.append(detail)

        # Local baseline: the same dataset through the same collation,
        # no network tier.
        local_rows = 0
        t0 = time.perf_counter()
        with make_batch_reader(dataset_url, reader_pool_type="thread",
                               workers_count=2, num_epochs=1,
                               shuffle_row_groups=False) as reader:
            for b in batch_iterator(reader, batch_size, last_batch="keep"):
                local_rows += len(next(iter(b.values())))
        local_wall = time.perf_counter() - t0
        service_rps = round(served_rows / service_wall, 1)
        result = {
            "scenario": "service_loopback",
            # BENCH-style envelope: the headline number, named.
            "metric": "service_rows_per_sec",
            "value": service_rps,
            "unit": "rows/sec",
            "vs_baseline": round(
                (served_rows / service_wall) / (local_rows / local_wall), 2),
            "mode": mode,
            "workers": workers,
            "transport": transport,
            "skew_ms": skew_ms,
            "credits": credits,
            "epochs": epochs,
            # Determinism surface: equal digests (same seed, ordered) =
            # byte-identical delivered streams — the cheap A/B assert.
            "shuffle_seed": shuffle_seed,
            "ordered": ordered,
            "stream_digest": digest.hexdigest(),
            # Declared row filter in force (None when unfiltered):
            # placement + the delivered row count make selectivity and
            # hoist economics readable from the json line.
            "filter": ({"predicate": predicate_obj.to_wire(),
                        "placement": filter_placement,
                        "rows_delivered": served_rows}
                       if predicate_obj is not None else None),
            "duplicates_dropped":
                source_diag["recovery"]["duplicates_dropped"],
            # Hedged re-serve race tallies (all zero when hedging is off
            # or no stream ever went silent past the fitted threshold).
            "hedging": hedging,
            "hedge_counts": dict(
                source_diag["resilience"]["hedge_counts"]),
            "epochs_detail": epochs_detail,
            "rows": served_rows,
            "batches": batches,
            "service_rows_per_sec": service_rps,
            "service_wall_s": round(service_wall, 3),
            "time_to_half_rows_s": round(time_to_half, 3),
            "local_rows_per_sec": round(local_rows / local_wall, 1),
            "service_vs_local": round(
                (served_rows / service_wall) / (local_rows / local_wall), 2),
            "loader_input_stall_pct": stall_pct,
            "per_worker_batches": {
                wid: counters["batches"]
                for wid, counters in source_diag["per_worker"].items()},
            "per_worker_stall_s": {
                wid: counters["stall_s"]
                for wid, counters in source_diag["per_worker"].items()},
            "per_worker_pieces": {
                wid: counters.get("pieces", 0)
                for wid, counters in source_diag["per_worker"].items()},
        }
        if mode == "dynamic":
            recovery = source_diag.get("recovery", {})
            result["steals_applied"] = recovery.get("steals_applied", 0)
            result["steals_failed"] = recovery.get("steals_failed", 0)
            result["dedup_dropped"] = recovery.get("dedup_dropped", 0)
        if cache != "off":
            totals = fleet_cache_totals() or (0, 0)
            per_worker_stats = [w.cache_stats() for w in fleet]
            result["cache"] = {
                "mode": cache,
                "mem_mb": cache_mem_mb,
                "dir": cache_dir,
                "hits": totals[0],
                "misses": totals[1],
                "hit_rate": round(totals[0] / max(1, sum(totals)), 4),
                "bytes_mem": sum(s["bytes_mem"]
                                 for s in per_worker_stats if s),
                "evictions_mem": sum(s["evictions_mem"]
                                     for s in per_worker_stats if s),
                "evictions_disk": sum(s["evictions_disk"]
                                      for s in per_worker_stats if s),
                "corrupt_entries": sum(s.get("corrupt_entries", 0)
                                       for s in per_worker_stats if s),
                # Shuffle-compatible serving: entries that went out
                # through a seed-tree serve-time permutation (nonzero iff
                # --shuffle-seed and a warm tier met), and old-format
                # entries evicted by the version check.
                "permuted_serves": sum(s.get("permuted_serves", 0)
                                       for s in per_worker_stats if s),
                "version_evicted": sum(s.get("version_evicted", 0)
                                       for s in per_worker_stats if s),
            }
            if fleet_cache:
                # Fleet-tier attribution: remote warmth movement (peer
                # fetches, placement pushes, drain handoffs) summed
                # across the fleet — cold re-decodes avoided by the
                # ring show up here, not in the local hit counters.
                result["cache"]["fleet"] = {
                    "remote_hits": sum(s.get("remote_hits", 0)
                                       for s in per_worker_stats if s),
                    "remote_misses": sum(s.get("remote_misses", 0)
                                         for s in per_worker_stats if s),
                    "remote_errors": sum(s.get("remote_errors", 0)
                                         for s in per_worker_stats if s),
                    "breaker_skips": sum(s.get("breaker_skips", 0)
                                         for s in per_worker_stats if s),
                    "pushes_sent": sum(s.get("pushes_sent", 0)
                                       for s in per_worker_stats if s),
                    "handoff_entries_sent": sum(
                        s.get("handoff_entries_sent", 0)
                        for s in per_worker_stats if s),
                    "handoff_entries_received": sum(
                        s.get("handoff_entries_received", 0)
                        for s in per_worker_stats if s),
                    "drained_after_batches": fleet_cache_drain_after,
                }
        # Final registry snapshot + per-stage latency quantiles: BENCH
        # artifacts capture distributions (p50/p99), not just means.
        from petastorm_tpu_torch.telemetry import REGISTRY as _registry

        result["telemetry"] = {
            "stage_quantiles_s": loader.stage_quantiles(),
            "registry": _registry.snapshot(),
        }
        if metrics_server is not None:
            result["metrics_address"] = list(metrics_server.address)
        if trace_out:
            result["trace_out"] = trace_out
        if chaos_kinds:
            # Exactly-once on EVERY path: per-piece watermarks re-grant a
            # re-served piece at the delivery cursor (worker-kill
            # takeover, conn-drop retry) and journal replay restores the
            # control plane (dispatcher restart), so zero lost rows AND
            # zero duplicates is the contract under all chaos kinds — the
            # pre-watermark harness only promised at-least-once off the
            # steal path.
            allow_duplicates = False
            # Every epoch delivers the full id set once: the expected
            # multiset scales with the epoch count.
            invariants = delivery_invariants(
                list(range(rows)) * epochs, got_ids, allow_duplicates)
            status = source.dispatcher_status()
            recovery = status.get("recovery", {})
            chaos_events = injector.events if injector is not None else []
            injection_log = (failpoint_schedule.log_snapshot()
                             if failpoint_schedule is not None else [])
            result.update({
                "chaos": ",".join(chaos_kinds),
                "chaos_seed": chaos_seed,
                "chaos_events": chaos_events,
                "chaos_errors": (injector.errors
                                 if injector is not None else []),
                "chaos_pace_s": chaos_pace_s,
                "failpoint_injections": injection_log,
                "lost_rows": invariants["lost_rows"],
                "duplicate_rows": invariants["duplicate_rows"],
                "fencing_epoch": status.get("fencing_epoch"),
                "dispatcher_recovery": recovery,
                "client_recovery": source.diagnostics.get("recovery", {}),
            })
            if not invariants["ok"]:
                raise _invariant_failure(
                    f"chaos run violated delivery invariants: "
                    f"{invariants['lost_rows']} lost rows, "
                    f"{invariants['duplicate_rows']} duplicates "
                    f"(allow_duplicates={allow_duplicates}); seed: "
                    f"{chaos_seed}; events: {chaos_events}; "
                    f"failpoints: {injection_log}")
            if "failpoints" in chaos_kinds and failpoint_points is None \
                    and not injection_log:
                raise _invariant_failure(
                    "failpoints chaos ran but the schedule fired nothing "
                    "— the run proved no robustness (too-short epoch "
                    "never reached the seeded fire indices, or the "
                    "failpoints were compiled out)")
            if "dispatcher-restart" in chaos_kinds and (
                    recovery.get("journal_replays", 0) < 1
                    or recovery.get("fencing_bumps", 0) < 1):
                raise _invariant_failure(
                    f"dispatcher-restart chaos recorded no recovery: "
                    f"{recovery} (events: {chaos_events})")
            if "cache-corrupt" in chaos_kinds and (
                    result["cache"]["corrupt_entries"] < 1):
                raise _invariant_failure(
                    "cache-corrupt chaos ran but no worker counted a "
                    "corrupt entry: either no injection landed on an "
                    "entry a warm epoch later loaded, or — the bug this "
                    "guard exists for — a damaged entry was served "
                    f"without detection (events: {chaos_events})")
        if json_out:
            import json

            with open(json_out, "a", encoding="utf-8") as f:
                f.write(json.dumps(result) + "\n")
        return result
    finally:
        if injector is not None:
            injector.stop()
        if failpoint_schedule is not None:
            from petastorm_tpu_torch import failpoints as failpoints_mod

            failpoints_mod.disarm()
        for worker in fleet:
            worker.stop()
        if dispatcher_holder:
            dispatcher_holder[0].stop()
        if metrics_server is not None:
            metrics_server.stop()
        if trace_armed:
            from petastorm_tpu_torch.telemetry import tracing

            tracing.COLLECTOR.release()
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)
        if journal_tmp:
            shutil.rmtree(journal_tmp, ignore_errors=True)
        if cache_tmp:
            shutil.rmtree(cache_tmp, ignore_errors=True)


SCENARIOS = {
    "tabular": tabular_predicate_scenario,
    "ngram": ngram_window_scenario,
    "image": image_pipeline_scenario,
    "weighted": weighted_mixing_scenario,
    "converter_mixing": converter_mixing_scenario,
    "packed": packed_delivery_scenario,
    "service": service_loopback_scenario,
}
