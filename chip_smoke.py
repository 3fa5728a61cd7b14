#!/usr/bin/env python3
"""Smoke test of petastorm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and nothing else
of the network or disk beyond the checkout and a temporary directory.

Phases, one line of output each (a phase that fails stops the run with a
non-zero exit code):

1. ``env``: the card's name and power limit, torch / CUDA / nvcc versions,
   whether Triton and CUTLASS headers are present, the pyzmq and
   cloudpickle versions (the process pool's transport), the tensorflow and
   pyspark versions (each ``absent`` where not installed; read from the
   installed distributions, not imported); then the build of the
   three flash-attention kernels (``petastorm_tpu_torch/ops/csrc``), and of
   the counting builds of the forward (``PTT_FWD_COUNT_TILES``), dQ
   (``PTT_DQ_COUNT_TILES``) and dK/dV (``PTT_DKV_COUNT_TILES``) kernels, all
   in parallel, and its seconds.
2. ``kernels``: every kernel against its plain PyTorch version on the card,
   at the attention benchmark's shape (B=2, H=4, D=128, T=4096: causal +
   segment ids f32, causal bf16, causal GQA with 2 K/V heads, kv_lengths),
   at the LM's shape (B=4, T=128, H=4, D=16), on segment ids built to trip
   a tile-skipping kernel (``segment_layouts``: unsorted, -1 padded tails,
   single-token segments, one segment over all of T, edges inside tiles) in
   f32 and bf16, at head dims 16, 32 and 64, at head dim 8 (run as 16,
   zero-padded), under strict causal (``causal_offset`` -1, the striped
   ring's blocks) and with an lse cotangent through the dQ kernel (at the
   ring's block shapes, D=16 and D=8, f32 and bf16; delta must equal
   ``rowsum(dout * o) - dlse`` on the kernel's own o), and at the shapes
   and dtypes the sequence trainers of phases 5 and 6 give the kernels
   (``trainer_cases``: 5-frame windows, ragged ``kv_lengths``, packed
   segment ids, and the sp = 2 ring's blocks of the last two). Head dims
   the kernels are not instantiated for are laid out as the autograd
   functions lay them out (``kernel_layout``). In every case the counting
   builds count on the card the K tiles the forward's and the dQ kernel's
   blocks load and the tiles their warps compute, and the Q tiles the dK/dV
   kernel's blocks load and the tiles its warps compute; these must equal
   ``visited_k_tiles``'s (with each kernel's tiles) and ``visited_q_tiles``'s
   (the plain mirrors of the skip rules), and each counting build's output
   must equal its kernel's bit for bit. Two launches of the dQ kernel must
   give bit-identical dq/delta, and two of the dK/dV kernel bit-identical
   dk/dv. Then, on causal +
   segment ids f32 cases at both shapes, each kernel's device time (CUDA
   events around calls queued back to back behind a spin kernel, so the card
   never waits on the host; see ``cuda_ms``) and the host time of its
   wrapper, its plain version's time, the bound (the larger of bytes over
   3.35 TB/s and the visible-pair operations over the card's f32-grade
   tensor-core rate, ``F32_TC_FLOPS``), the (query, key) pairs each kernel
   computed and the tiles it loaded (counted) beside the visible pairs, and
   ``torch.nn.functional.scaled_dot_product_attention`` on the same inputs
   as a yardstick (the port never calls it): its forward beside the
   forward, its backward beside dQ + dK/dV together. Last, the DLRM's
   sparse SGD update (``ops/sparse_sgd.py``, ``csrc/sparse_sgd.cu``) at
   ``SPARSE_SGD``'s shape (the Criteo Terabyte tables, 26 x 1,000,000 x 128
   f32, and 8,192 x 26 Zipf(1.1) ids; ``sparse_sgd_case``): the tables and
   the count of touched rows equal the plain version's bit for bit; its
   device ms and wrapper host ms, the plain version's ms, the bound, and
   the kernel on the longest run of one row alone.
3. ``train``: the packed long-context LM at its full configuration (d_model
   64, 4 heads, 2 layers, vocab 64, slot_len 128, 4 slots, f32) for
   ``TRAIN_STEPS`` SGD steps from a generated Parquet corpus: every batch
   arrives on the card, the loss is finite and falls, all three kernels
   were launched on this path, and flash logits match the dense oracle on
   the last batch. Reported: steps/s over every step, warm steps/s (from a
   sync at step 3 to a sync at the end) and the median host interval
   between warm steps, and the card's busy share in the warm window of a
   second, identical run traced by ``torch.profiler``.
4. ``image``: the row/image path at ``bench.py``'s image configuration
   (``IMAGE``: 1,536 rows of 64x64x3 uint8 png images with the benchmark's
   schema, row groups of 128, batch 128, 10 classes, conv 64, hidden 2048,
   SGD at lr 0.01, bf16 compute), labels made learnable (pixel mean set by
   the label plus seeded noise): ``make_reader`` (thread pool) →
   ``make_torch_dataloader(last_batch="pad", device_stage=DeviceStage(
   normalize=(127.5, 127.5), crop=(56, 56), flip=True))`` →
   ``train_image_classifier`` for 6 epochs, the first a warm-up (the
   reader may decode up to one epoch ahead of the loader, so the timed
   window is long enough to hold the decode rate, not that buffer). The crop
   makes the model's input 56x56, so dense1 takes 28*28*64 = 50,176
   features. Checked: the stage's card output for a fixed raw batch and
   step equals its CPU output bit for bit (f32 and bf16) and the numpy
   selection of its recorded draws; f32 logits on the card match the CPU
   module with the same weights within ``LOGIT_REL`` of the largest logit
   (TF32 off); every batch lands on ``cuda:0``; the loss is finite and its
   last epoch's mean is below its first's; the H2D bytes per row are the
   raw image's 12,288 plus the label's 4. Reported on the ``image:`` line:
   steady-state images/s and step ms (after the warm-up epoch), the model
   step alone on a resident batch (device ms and host ms per step, by
   ``cuda_ms``), the host's decode ceiling (the same reader and collation
   with no device, timed the same way), the stage's device ms per batch,
   the training loop's ms per step between batches (``consumer_s``), the
   card's busy share in the timed window of a second, identical run traced
   by ``torch.profiler`` (``device_busy_pct``) and that run's images/s,
   input stall, dispatch overlap, H2D bytes per image, peak memory and the
   codec.

5. ``seq``: the sequence-model family's three trainers
   (``models/sequence_training.py``: NGram windows of 5 frames, ragged
   causal with ``lengths``, packed causal with ``segment_ids``; d_model 32,
   4 heads, so head dim 8) for ``SEQ_STEPS`` steps each through the
   kernels: losses finite, the ragged and packed losses' last-quarter mean
   below their first-quarter mean, every kernel launched.
6. ``sp``: ``SP`` = 2 spawned ranks on the one card, in a gloo group over a
   ``FileStore``; the collectives stage CUDA tensors through pinned host
   memory (gloo takes host tensors only, and NCCL refuses two ranks on one
   device); the kernels run on the card in both ranks, built by the parent
   beforehand. Each rank checks, and fails the run on a miss: ring
   (striped and contiguous) and Ulysses attention with flash local blocks
   and segment ids against the dense oracle (outputs and q/k/v
   gradients, D=16 and D=8); the LM at its full configuration for 12
   steps at sp = 2 (loss falls, ring-vs-dense logit parity within
   ``PARITY_TOL``, parameter gradients equal to one process's); the
   sequence encoder at sp = 2, ring and Ulysses (gradients equal to one
   process's, then ragged training), and the packed trainer over the ring,
   the trainers with their default local attention (``"auto"``: the kernels
   for CUDA tensors), each run launching every kernel. The second line
   reports step times of this transport, not claims.

7. ``tabular``: the DLRM tabular path (``models/tabular_dlrm.py``) at the
   repo's own widths: the JAX tabular scenario's Criteo-shaped store
   (``TABULAR``: 40,000 rows, 8 day row groups of 5,000, 41 columns) →
   ``make_batch_reader`` → ``make_torch_dataloader`` → the DLRM at
   ``init_dlrm_params``' defaults (13 dense, 26 tables of 1024 x 16, hidden
   64, bf16 compute), batch 256, ``last_batch="drop"``, 2 epochs (312
   steps), SGD at lr 0.05. (a) A full scan and a ``filters=[("day", "=",
   3)]`` scan plan 8 and 1 row groups and read 40,000 and 5,000 rows. (b)
   The uninterrupted run: losses finite, the last quarter's mean below the
   first's, every batch on ``cuda:0``, every row trained twice bar the 128
   the final partial batch drops; warm steps/s and rows/s (steps 10 to the
   end), stall, peak memory, and the busy share of a traced second run.
   (c) Preempted at step 100 and checkpointed (``save_training_state``);
   every object dropped; ``restore_training_state`` gives the parameters
   bit for bit, and a fresh reader with ``resume_state`` finishes the run:
   every row trained at least twice over the two runs bar under 256 rows;
   re-read rows and the save and restore ms. (d) ``DP`` = 2 ranks on card 0
   (gloo, as phase 6), each reading its shard: the loader's derived
   ``max_batches`` equals ``global_step_count``, both ranks take exactly
   that many steps and end with bit-equal parameters; at f32 compute the
   first step's all-reduced gradients equal the mean of the two batches'
   one-process gradients within ``DP_GRAD_REL``; ``agree_max_batches``
   gives the minimum of two unequal counts; each rank's steps/s (transport
   on one card, not a claim). No flash kernel runs on this path, and
   (b)'s run launches the sparse SGD kernel once a step (both counted).
8. ``reader``: the petastorm reader API at the MNIST example's size
   (``READER``; see ``reader_phase``): a row-group index and a selector,
   the example's predicate / drop-partition / local-disk-cache path into
   its ``DataLoader`` and MLP for two epochs (the second all cache hits),
   the batch loaders on phase 7's store, and a seeded
   ``WeightedSamplingReader`` against its host replay.
9. ``loader``: the loader's own features on phase 4's store (``IMAGE``),
   after phase 8 in the same process. (a) ``bench.py``'s
   ``leg_cached_epochs`` on the card: ``make_columnar_reader`` (one
   worker) → ``make_torch_dataloader(batch_cache=BatchCache(1 GiB))``,
   two passes, unseeded and at ``shuffle_seed`` 7: the same rows both
   passes, every warm lookup a hit, the unseeded replay bit-equal in order,
   each seeded pass the canonical batches in the order
   ``permutation(fold_in(7, ("cache-epoch", k)), 12)`` by per-batch image
   digests; cold and warm images/s, the warm hit rate, the cache's bytes.
   (b) Phase 4's image path on a cached, producer-staged loader
   (``make_reader`` → ``make_torch_dataloader(last_batch="pad",
   device_stage, batch_cache=CacheConfig("mem+disk", 256 MiB, a directory),
   shuffle_seed=7, stage_in_producer=True, trace_path)``) training the
   full-width CNN for 6 passes, the first filling the cache: every batch
   on ``cuda:0``, losses finite and falling, 1 fill then 5 hits, the same
   labels every pass, a ``loader.device_put`` and a ``loader.wait`` span
   per batch of the last pass in the trace file; pass 1 and warm images/s,
   stall, dispatch overlap, consumer ms per step, the cache's ``stats()``,
   and the card's busy share in the warm passes of a second, identical run
   under ``torch.profiler``, beside phase 4's images/s from this call. (c)
   The first 12 batches with and without ``stage_in_producer``, at
   ``device_prefetch`` 1 and 4: bit-equal card tensors. (d) The seeded
   loader of (b) without the model, with one decode worker (so an
   uninterrupted run fills the same canonical order), and with a stage that draws nothing
   (normalize only: a resumed loader restarts the production ordinal the
   crop and flip draws follow), stopped after 5 batches of pass 3: a
   ``cache_replay`` state at cache epoch 2; a fresh cache on the same
   directory and a fresh reader with ``cache_resume`` serve the rest of
   pass 3 bit-equal to an uninterrupted run, from the disk tier, with no
   fill. No flash kernel runs on this path (counted).
10. ``etl``: the dataset writer, its CLIs and ``Reader.reset()``, after
   phase 9 in the same process (``ETL``; see ``etl_phase``). (a) The
   ImageNet example's store (``models/imagenet.py``: 512 synthetic rows of
   375x500x3 png from one ``RandomState(0)`` stream) written through
   ``materialize_dataset(None, url, schema, row_group_size_mb=64)`` and
   ``write_rows(..., row_group_size_mb=64)`` at 1 and 8 encode workers: the
   two stores byte-equal, the row groups those the probe rule gives
   (computed here from the first 64 encoded rows), ``python -m
   petastorm_tpu_torch.etl.metadata_util --schema`` listing the three
   fields; read back through ``make_reader`` (thread pool) and
   ``make_torch_dataloader(32)`` onto ``cuda:0``: every image bit-equal to
   the row written (per-row digests taken at generation), 562,500 H2D bytes
   a row (the string labels stay on the host), nonzero ``items_ventilated``
   and ``items_processed`` in ``Reader.diagnostics`` mid-pass, then
   ``reader.reset()`` and a second pass with the same ids and images.
   Printed: write rows/s and MB/s at each worker count, rows per group,
   read-back rows/s. (b) ``generate_corpus``'s 512 documents (as plain
   int32 columns, which a schema inferred from the files decodes) through
   ``write_rows(compression="zstd", rows_per_file=128, encode_workers=4,
   basename_template="lm-{:03d}.parquet")``; ``_common_metadata`` deleted and
   regenerated by ``python -m
   petastorm_tpu_torch.etl.petastorm_generate_metadata`` (inference);
   ``count_packed_batches`` on a one-epoch counting reader equal to the
   batches ``make_packed_torch_dataloader`` delivers to the card from the
   same reader arguments, ``unpack`` of them (on the host) the written
   documents as a multiset, and ``train_lm`` 12 steps on the store: losses
   finite and falling, all three kernels launched (counted). (c) ``python
   -m petastorm_tpu_torch.tools.copy_dataset`` of (a)'s store with
   ``--field-regex noun_id image --partitions-count 2``: two files, read
   back on the card with the same digests. No flash kernel runs in (a) or
   (c) (counted).

11. ``pool``: the process pool and the telemetry it feeds, after phase 10
   in the same process (``POOL``; see ``pool_phase``). (a) The host's
   ceiling on phase 4's store: ``make_reader`` + ``batch_iterator(128)``
   with no device, 6 epochs timed after the first, the thread and the
   process pool at 1, 4 and 8 workers: every run's multiset of (label,
   image digest) equals the written rows' (``image_rows``) six times, and
   the one-worker orders are equal; rows/s each. (b) Phase 4's training run
   with ``reader_pool_type="process"`` (10 workers) and the same stage and
   CNN: loss finite and falling, images/s, ``consumer_s``, input stall and
   the busy share of a second, traced run, beside phase 4's thread-pool
   figures from this call; while the workers run, ``nvidia-smi
   --query-compute-apps=pid`` lists no worker's pid (the sandbox lists one
   entry, pid 1, however many processes hold a context, so ``/proc`` is
   read too: the training process holds ``/dev/nvidia*`` files and maps
   ``libcuda``, no worker does, in any sample); after ``join()`` no
   ``python ... exec_in_new_process`` child is left (checked after every
   leg). (c) The LM's 12 steps (phase 3's corpus and width) on
   ``make_columnar_reader(reader_pool_type="process", workers_count=1)``:
   its packed batches bit-equal to the thread pool's at one worker, the
   losses equal to the thread-pool run's, flash launches 26 / 24 / 24. (d)
   Phase 7's Criteo-shaped store through ``make_batch_reader`` on the
   process pool (one worker) with ``zmq_copy_buffers`` True and False: the
   tables equal the thread pool's; rows/s each; a resume from a
   ``state_dict()`` after 3 tables gives the thread pool's state and
   re-reads its rows. (e) During (b), ``start_metrics_server`` on
   127.0.0.1 at an ephemeral port, scraped over HTTP: the pool's items
   processed equal the reader's ``diagnostics``, the loader's batches and
   rows those yielded; ``stage_quantiles()`` printed; a worker fault
   injected through a predicate reaches the consumer as a
   ``WorkerException`` with its traceback and leaves a flight-recorder
   event. No flash kernel runs outside (c)'s LM.
12. ``parallel``: the model-parallel families over ``torch.distributed``,
   after phase 11 in the same process (``PARALLEL``; see
   ``parallel_phase``): 4 spawned ranks on card 0 (gloo, pinned-host
   staging, as phases 6 and 7 (d)), each family sharded by its partition
   specs (``torch_utils/mesh.py``). (a) The expert-parallel MoE at
   ``init_moe_params``' defaults (d_model 32, d_hidden 64, 8 experts) on
   phase 7's Criteo-shaped store (``make_batch_reader`` →
   ``make_torch_dataloader``, the 13 dense columns as features and
   ``label`` as the class, batch 256): 12 SGD steps at top-1 and at top-2,
   at ep = 4 and at (data 2, ep 2). (b) The pipeline at
   ``init_pipeline_params``' defaults (d_model 64, d_hidden 128; 4 stages at
   pp = 4, 2 at (data 2, pp 2)) on the same batches, 8 microbatches, 12
   steps under GPipe and under 1F1B. (c) The image classifier at phase 4's
   width (conv 64, hidden 2048, 56x56 crops) at (data 2, model 2) on phase
   4's store, each data rank reading its shard (both model ranks of a data
   group the same batches), 4 steps. (d) The DLRM at the Criteo trainer's
   widths (26 tables of 1024 x 16) at (data 2, model 2) on phase 7's
   store, read as phase 7 (d) reads it, 12 steps. The parent reads the same
   batches first and trains the same family in one process on the card
   (the MoE's ``reference_forward`` with 4 token shards, the pipeline's
   sequential stack, the unsharded classifier and DLRM on each step's two
   data shards together). Checked, on every rank: its batches on the card
   and bit-equal to the parent's; its split tensors ``1/n`` of the whole
   (bytes printed); losses finite and equal to the one-process run's, and
   its final parameters equal to its block of the one-process run's, each
   block's distance to it also bounded against how far that block moved
   in training (``PARALLEL_TOL``: f32 losses 1e-5, parameters rtol 1e-4 /
   atol 1e-5, top-2 2e-4 / 2e-5, update 1e-3; bf16 image and DLRM: losses
   5e-4, parameters 1e-4 / 1e-4, update 1e-1); GPipe's and 1F1B's losses
   within 1e-5 relative; flash launches 0 / 0 / 0 (counted, in the ranks and in the
   one-process runs); no rank left after the phase. Each case's steps/s a
   rank (after its first step) is gloo transport on one card, not a
   scaling claim.

13. ``autotune``: the online autotuner and the dataset converter, after
   phase 12 in the same process (``AUTOTUNE``; see ``autotune_phase``). (a)
   ``bench.py``'s autotune leg on phase 4's store and CNN (uint8 64x64x3
   batches of 128 into the bf16 model, which casts them): a thread-pool
   ``make_columnar_reader(shuffle_row_groups=True, schema_fields=["image",
   "label"])`` for 12 epochs → ``make_torch_dataloader(last_batch="drop")``
   under three variants, a warm-up round and one measured round:
   ``autotuned_defaults`` (10 workers, host_prefetch 4, device_prefetch 2,
   ``autotune={"interval_s": 0.1, "hysteresis": 1, "tolerance": 0.08}``),
   ``static_defaults`` (the same knobs, no autotuner) and ``hand_tuned`` (1
   worker, host_prefetch 6, the TPU host's best, not re-tuned here); the
   decode ceiling (the one-worker reader and collation, no device). Checked
   on every autotuned pass, with its reader still running: each decision
   within its knob's bounds, the knobs in force the last decision of each,
   the pool's live worker threads its ``workers_count`` once the trail is
   quiet, the registry's ``AUTOTUNE_DECISIONS`` and ``AUTOTUNE_ROUNDS``
   deltas the trail's counts, no "autotune round failed" record; every
   variant's multiset of rows (an exact int64 digest of each image on the
   card, and its label) the static pass's; no controller or worker thread
   alive after a loader closes. Printed: each variant's images/s and stall,
   the ceiling, the ratios against ``hand_tuned``, every round's
   bottleneck class in the measured pass (run-length encoded) and its trail
   (each entry's round, outcome, bottleneck class and decisions). (b)
   Phase 7's Criteo-shaped table read back as a ``pa.Table`` (no pandas)
   through ``make_spark_converter(dtype="float32")``: a second converter of
   the same table reuses the directory with no write, ``delete()`` honours
   the ref-count; one epoch of ``make_torch_device_dataloader`` equal batch
   for batch to ``make_batch_reader`` → ``make_torch_dataloader`` with the
   same reader arguments (one worker, shard_seed 7); the Criteo example's
   DLRM for 2 epochs through ``make_torch_device_dataloader(loader_kwargs=
   {"autotune": True})`` (the autotuned pass's checks again, losses finite,
   every row trained twice bar the final partial batch's); one epoch of the
   reference ``make_torch_dataloader`` (``BatchedDataLoader``) on the card.
   (c) No flash kernel runs on this path (counted).
14. ``service``: remote filesystems and the data service's first tier
   (``SERVICE``; see ``service_phase``), after phase 13 in the same
   process; dispatchers and workers on 127.0.0.1, the trainer on the card.
   (a) Phase 4's store and CNN through a static ``Dispatcher(num_epochs=6)``,
   2 ``BatchWorker(reader_factory="row", workers_count=4)``,
   ``ServiceBatchSource(credits=8)`` → ``TorchDataLoader(None, device_stage=
   ...)`` (the source pulled directly, without a producer thread) → the
   CNN, twice (the second under ``torch.profiler`` for the busy share):
   every batch on ``cuda:0``, each epoch's multiset of per-image digests
   (crc32 and adler32 of the image bytes, and the label, taken on the
   consuming thread inside the timed loop) the local reader's, losses
   finite; images/s after the warm-up epoch beside phase 4's from this
   call, stall, busy share, the client's ``recv_stall_s`` and the workers'
   ``credit_wait_s``. (b) Phase 7's store (the JAX
   ``service_loopback_scenario``'s shape: 2 workers of 2 reader threads,
   batch 512, credits 8) into the DLRM for one epoch: a local
   ``make_batch_reader`` (2 threads), then the service static with
   ``ordered=True``, then fcfs: every row exactly once each time; the
   three rows/s. (c) One of two workers ``kill()``-ed after 20 batches:
   no row lost, duplicates and takeovers reported; a
   ``TorchDataLoader.state_dict()`` after 25 batches resumed by a fresh
   fleet with ``resume_state=``: every row read, re-read rows reported.
   (d) A worker started as ``python -m petastorm_tpu_torch.service worker``
   under ``CUDA_VISIBLE_DEVICES=""``: its batches reach the card, and its
   ``/proc`` shows no ``/dev/nvidia*`` file and no ``libcuda`` mapping.
   (e) Phase 4's store copied into fsspec's ``memory://`` and read by
   ``make_reader(storage_options=...)`` and ``make_reader(filesystem=...)``
   to the card: images and labels bit for bit the local reader's. No flash
   kernel runs on this phase (counted).

15. ``control``: the data service's control plane (``CONTROL``; see
   ``control_phase``), after phase 14 in the same process. (a) Phase 4's
   store and CNN through ``Dispatcher(journal_dir=..., num_epochs=2)``, 2
   ``BatchWorker(reader_factory="row", workers_count=4)`` and
   ``ServiceBatchSource(credits=8, heartbeat_interval_s=0.25)``: after 6 of
   the first epoch's 12 batches the dispatcher is stopped, its connections
   dropped, and a new one started on the same port from the same journal
   (every send slowed 0.25 s by the ``slow-peer`` failpoint from the first
   batch until the client's resync, so the workers cannot run ahead and
   the epoch's streams outlive a heartbeat after the restart): each
   epoch's multiset of image digests the local reader's, batches on
   ``cuda:0``, losses finite, the new dispatcher's ``journal_replays`` 1
   and its fencing epoch above the old one, the client's ``resyncs`` at
   least 1; the seconds from the restart to the next batch and images/s
   over the run. (b) Phase 7's store at phase 14 (b)'s shape (2 workers of
   2 reader threads, batch 512, credits 8, ``ordered=True``), one DLRM
   epoch each: one worker's sends stalled 1.5 s three times (``slow-peer``,
   keyed to it) with ``hedging=True`` and ``hedge_quantile=0.9`` (hedges
   launched, a won race's late primary batches dropped, every row exactly
   once), then one worker's connections dropped with its reconnects reset
   (``breaker-trip``) under ``breaker_threshold=2`` (the client's breaker
   open, the dispatcher's ``breaker_open`` lists the worker, a new grant
   leaves it out, every row exactly once). (c) One epoch of (a)'s path with
   fleet tracing armed, the dispatcher and the 2 workers started as ``python
   -m petastorm_tpu_torch.service`` processes: the merged trace holds the
   dispatcher and the three peers with finite clock offsets, and
   ``critical_path.diagnose`` with the loader's measured stall prints its
   bottlenecks and stage profile. No flash kernel runs on this phase
   (counted).

16. ``dynamic``: the data service's dynamic sharding (``DYNAMIC``; see
   ``dynamic_phase``), after phase 15 in the same process. (a) Phase 4's
   store and CNN for 2 epochs through 2 ``BatchWorker(reader_factory="row")``
   with 1 and 4 decode threads (credits 8), first on a static dispatcher,
   then on ``Dispatcher(mode="dynamic")`` with
   ``ServiceBatchSource(dynamic_sync_interval_s=0.1)``: each epoch's image
   digests the local reader's, batches on ``cuda:0``, losses finite;
   images/s of both, the dynamic run's steals in / out per worker and
   ``steals_applied`` / ``steals_failed`` / ``dedup_dropped`` (0). (b)
   Phase 7's store at phase 14 (b)'s shape, ``ordered=True``, one DLRM epoch
   on a journaled dynamic dispatcher, each send slowed 0.05 s: a third
   worker registers after 4 batches; the first sync reply granting it
   steals is lost after they were journaled, and the dispatcher restarts
   from its journal on the same port: every row exactly once,
   ``journal_replays`` 1, the restarted dispatcher's corrective deltas
   applied (the final owners are theirs) and the joined worker serving
   pieces. (c) A static tagged image stream, 2 workers and the client with
   ``on_piece_error="quarantine"`` under ``FaultSchedule(poison_pieces={5})``:
   piece 5 reported once and quarantined by the dispatcher, every other
   image delivered once. (d) Phase 14 (a)'s image path (6 epochs), served
   by the workers' streaming piece engines (their finished streams' served
   pieces counted): images/s beside phase 4's and phase 14's. No flash
   kernel runs on this phase (counted).

17. ``dataplane``: the data plane of one host (``DATAPLANE``; see
   ``dataplane_phase``), after phase 16 in the same process. (a) Phase 14
   (a)'s image path (2 workers of 4 png threads, credits 8, 16 epochs),
   each worker with ``BatchCache(mem 256 MiB)``, with
   ``transport="tcp"`` on both sides and with ``"auto"`` in turns (tcp,
   shm, shm, tcp), first with the workers in this process, then in
   processes of their own (``python -m petastorm_tpu_torch.service worker
   --cache mem``): each epoch's digests the local reader's, every stream
   negotiated on the expected tier (``transport_streams_shm_total`` all of
   them over shm, 0 over TCP), every piece missed once (cold) and every warm
   lookup a hit: the hits are the warm pieces' and, where the client
   re-opened a broken stream on its worker, at most the pieces the new
   stream named again (counted at the client, reported per run), the shm
   runs' warm frames mapped from the workers' frame pools; images/s, stall and
   the mean gap between batches across and within an epoch of each run, and
   shm over TCP for each pair. Then, on each transport with
   the workers in this process, one cold epoch and three traced warm ones
   with a thread that sleeps 1 ms at a time beside them (how late it wakes is
   the wait for the GIL): the trace's stage profile (``client.recv``,
   ``shm.park``, ``worker.send``, ...), its wait attribution and the
   probe's lateness. (b) Phase 7's
   store at phase 14 (b)'s shape (2 workers of 2 reader threads, batch 512,
   credits 8), ``ColumnPredicate("cat_0", "mod-eq", 0, modulus=4)`` and
   the DLRM's 41-column projection, one DLRM epoch each with the filter on
   the workers, on the client, and in a local ``make_batch_reader``: every
   arm the same rows, column for column, the hoisted workers sending only
   the survivors; rows/s of each. (c) The image path with a worker-side
   transform (each image mirrored), ordered, one epoch a pass: stage
   fusion off and on give the same digests in order, with hand-off seconds
   0 when fused; a cached fleet's ``cache_placement`` flipped from
   ``post-transform`` to ``post-decode`` refills (misses 12 → 24) and gives
   the same digests. (d) The image path under ``autotune=`` with the
   rewrite knobs bound: the rounds' classes and every rewrite the planner
   probed, applied or reverted, with its reason. No flash kernel runs on
   this phase (counted) and no shared memory stays mapped.

18. ``fleet``: the data service's fleet (``FLEET``; see ``fleet_phase``),
   after phase 17 in the same process. (a) Phase 4's store and CNN (bf16,
   the device stage) as two jobs registered through ``JobHandle``,
   ``fleet-a`` (weight 2) and ``fleet-b`` (weight 1), each training its own
   model for 3 epochs on the card in a thread of its own, through
   ``Dispatcher(mode="dynamic", shuffle_seed=18)`` and 2
   ``BatchWorker(fleet_cache=True)`` of 4 decode threads with a 256 MiB
   memory cache each (credits 8). ``fleet-b`` starts once ``fleet-a``'s cold
   epoch filled the caches; from then on the second worker's sends are
   slowed 0.1 s (``slow-peer``), so steals move its pieces to the first
   worker, and the workers' ids are chosen so that the second worker owns
   its own pieces on the ring (a stolen one is served from the peer):
   each job's per-epoch digests the local reader's, the fleet's cold
   decodes the 12 pieces once for both jobs, remote warm serves above 0,
   ``fleet-a``'s plans at ``credit_scale`` 1.0 and ``fleet-b``'s at 0.5,
   ``petastorm_fleet_job_rows_total`` per job the rows delivered, both
   losses falling; images/s per job after its first epoch and their ratio.
   (b) The autoscaler over the CLI, processes without the card:
   ``dispatcher --mode dynamic
   --autoscale --autoscale-interval 0.25 --journal-dir ...``, ``worker
   --cache mem --fleet-cache`` and ``worker --cache mem --fleet-cache
   --standby`` (heartbeats 0.05 s; their batch transform pauses 0.1 s, a
   heavy augmentation, so one worker's cold epoch keeps a backlog). Streak
   planner: one job's 2 epochs admit the standby worker; once it ended the
   idle fleet drains a worker, which ships its memory tier to the survivor
   (``cache_handoff`` journaled), and retires it; with it stopped, the next
   job's 2 epochs decode nothing (the survivor's misses unchanged) with the
   local reader's digests; a dispatcher restarted from the journal reports
   the same autoscale counts and hand-offs. Model planner: one job's 2
   epochs journal at least one ``fleet_plan``, kept across a restart. (c)
   ``ChaosInjector(seed=19)`` with ``worker_kill_action``,
   ``job_cancel_action`` and ``worker_drain_action`` over one job's 2 epochs
   on 3 workers (each send slowed 0.1 s), its events from the first batch on:
   ``delivery_invariants`` 0 lost, duplicates allowed; then
   ``dispatcher_restart_action`` alone on a journaled dispatcher after 4
   batches, ``ordered=True``: 0 lost, 0 duplicated and a
   ``StreamDigest`` equal to a clean run's. No flash kernel runs on this
   phase (counted) and no job registration stays open. One ``fleet:`` line
   carries the figures and the card's name and power limit.
19. ``llm``: the data service's LLM stages feeding phase 3's LM at its full
   configuration (``LLM``; see ``llm_phase``) over the capstone's corpus
   (512 documents, max_len 48). (a) A static dispatcher (2 epochs, shuffle
   seed 7) with 2 workers that pack the corpus
   (``ServiceBatchSource(packing=PackingSpec(slot_len=128, slots=4,
   sequence_fields=["tokens"], length_field="length"), ordered=True)``)
   trains the LM through ``TorchDataLoader`` on the card with the flash
   kernels, their launches counted from 0 over this run: every epoch's
   unpacked documents are the corpus's, as are those of
   ``PackedBatchSource(placement="trainer")`` (both epochs) and of
   ``make_packed_torch_dataloader`` over the store; a second worker-placed
   run has the same stream digest; the loss falls; every kernel launched.
   Reported: warm steps/s (from a sync at step 3), real tokens/s,
   ``input_stall_pct``, each placement's fill (real tokens over slots x
   slot_len, and the ``petastorm_packing_fill_ratio`` gauge). (b) The
   worker-placed stream cut after 1, 5 and n - 1 packed batches, rebuilt
   from ``state_dict`` and continued, is the uninterrupted stream byte for
   byte; a resume under another spec is refused. (c) The corpus written
   with seeds 17 and 23 as corpora ``a`` and ``b`` of one journaled
   dispatcher, one worker each, mixed by ``MixedBatchSource(weights={"a":
   0.8, "b": 0.2}, seed=29, exhaustion="stop", factories=True)`` with
   packing into a fresh LM for 2 passes, ``set_mixture_weights({"a": 0.2,
   "b": 0.8}, effective_epoch=1)`` journaled before pass 2: each pass's
   draws are the seed tree's, each share within 0.1 of its weight or three
   binomial standard errors of its pass; a second run from the same seed
   and log has the same digest; a dispatcher restarted from the journal
   returns the same log. (d) The loader graph of a packed source declares
   the ``pack`` stage between ``collate`` and ``serialize`` and binds
   ``packing_placement``; an autotuned run of 4 epochs started at trainer
   placement prints its window classes and any ``packing_placement``
   decision (reported, not claimed). No mixture pass, job registration or
   shared-memory ring stays open. One ``llm:`` line carries the figures
   and the card's name and power limit.
20. ``bench``: the throughput tool and scenario suite
   (``petastorm_tpu_torch/benchmark/``) and the chaos fuzzer
   (``service/fuzz.py``), each run its own process, which runs the module
   or code as ``python -m`` / ``python -c`` would, forked from a server
   process that imported torch and nothing else (no state from the phases
   before it, and not seconds of torch import a run; see ``bench_phase``). (a) ``python -m
   petastorm_tpu_torch.benchmark <store> --torch-loader`` on phase 4's
   image store (written anew, the same seed): rows/s and
   ``input_stall_pct`` of ``reader_throughput`` through
   ``make_torch_dataloader`` onto the card. (b) ``python -m
   petastorm_tpu_torch.benchmark scenario <name>`` for each of the seven
   scenarios at the JAX defaults (tabular 40,000 rows x 8 days, ngram
   2,000 frames, image 1,024 rows of 64x64x3 with ``--device-stage on``
   on the card, weighted 8,192 rows, converter_mixing, packed 2,048 docs,
   service 40,000 rows): each one's counts (rows, row groups, windows,
   batches, draws, docs) and, for the image leg, the H2D bytes per image
   of uint8 staging. (c) ``scenario service --shuffle-seed 7 --ordered``
   twice over TCP and once over shm: the three ``stream_digest`` values
   equal. (d) ``service_loopback_scenario(brownout=True)`` with the same
   seed through the function (the CLI has no flag for it): every row once,
   the same digest, and the brownout level it ended at. (e)
   ``measure_device_stage_scaling(device_counts=(1,))`` on ``cuda:0``.
   (f) ``fuzz.fuzz([7], check_determinism=True)``: no failure. Each run's
   last line must parse (JSON; (a)'s is the reference's text line); one
   ``bench:`` line gives each run's seconds, headline numbers and the
   length in characters of its last line.
21. ``adapters``: the remote-store arguments and the TensorFlow adapter
   (``ADAPTERS``; see ``adapters_phase``). The port's writer puts a store
   of 2,048 rows (row groups of 128, one ``part`` value a group) into
   fsspec's ``memory://``; ``build_rowgroup_index(...,
   storage_options=...)`` indexes ``part``; ``make_reader(...,
   rowgroup_selector=SingleIndexSelector("by_part", [3, 7, 11]),
   storage_options=...)`` feeds ``make_torch_dataloader`` to the card.
   Checked: every batch lands on ``cuda:0``, the rows that reach the card
   are exactly the three groups' rows, bit for bit, and
   ``global_step_count(..., filters=[("part", "in", [3, 7, 11])],
   storage_options=...)`` equals the loader's batch count. Where
   tensorflow imports (kept off the card), ``make_petastorm_dataset`` over
   a port reader of the same selection gives the same rows; where it does
   not, the line says ``tf: not run, tensorflow not installed on this
   host``. ``hdfs://`` and a Spark session have no server here: the CPU
   tests hold them. One ``adapters:`` line carries the figures and the
   card's name and power limit.

Each phase's wall seconds are on the ``phases:`` line. The last three lines
are the kernels' JSON record (times at the LM's
shape, the shape the training path launches them at; ``backward`` is dQ +
dK/dV together beside SDPA's backward), the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))

BENCH = dict(B=2, T=4096, H=4, D=128)  # the attention benchmark's flash shape
LM = dict(B=4, T=128, H=4, D=16)       # one LM layer's attention shape
F32_FWD_ABS, F32_GRAD_REL, BF16_GRAD_REL = 1e-4, 1e-3, 1e-2
# bf16 outputs: kernel and plain version round f32 results that agree to
# ~1e-6 to bf16, so they may differ by one bf16 step, at most 2^-7 of the
# larger magnitude (plus 1e-5 absolute near zero).
BF16_STEP, BF16_ABS = 2.0 ** -7, 1e-5
PARITY_TOL = 2e-4
HBM_BYTES_PER_S = 3.35e12
# f32-grade products on the H100 SXM's tensor cores: 495 TFLOP/s TF32 over
# the three passes (hi*hi + hi*lo + lo*hi) that keep f32 precision, as the
# reference's Precision.HIGHEST takes three MXU passes. The same yardstick
# for all three kernels, whatever each one runs on.
F32_TC_FLOPS = 495e12 / 3
TRAIN_STEPS = 40  # phase 3: enough warm steps for a median step time
SP_TRAIN_STEPS = 12  # the LM at sp = 2 in phase 6
SEQ_STEPS = 48  # steps of each sequence trainer: losses fall over quarters of the run
SP = 2  # sequence-parallel ranks of phase 6, all on card 0
SP_TIMEOUT_S = 600
# bench.py's image workload (bench.py:77-123): schema, rows, row groups,
# batch, classes and model width; the crop is the device stage's.
IMAGE = dict(rows=1536, rows_per_row_group=128, image_shape=(64, 64, 3), batch=128,
             classes=10, conv_features=64, hidden=2048, lr=0.01, crop=(56, 56), epochs=6)
# Phase 4 writes png, as bench.py does (the codec needs cv2 or Pillow).
IMAGE_CODEC = "png"
# f32 logits, card vs CPU: 50,176-term sums in another order (TF32 off).
LOGIT_REL = 1e-4
# The JAX tabular scenario's store (benchmark/scenarios.py:37-38) and the
# Criteo example's trainer (examples/criteo_dlrm/train_dlrm.py:40-78).
TABULAR = dict(rows=40_000, days=8, batch=256, epochs=2, interrupt_after=100)
# Phase 2's sparse SGD case: the DLRM's table update at the Criteo Terabyte
# shapes (26 tables of dim 128, each hashed to 1,000,000 rows), batch 8,192,
# Zipf(1.1) ids over the published cardinalities capped at 40M.
SPARSE_SGD = dict(rows=1_000_000, dim=128, batch=8192, zipf=1.1, lr=0.01, seed=26)
CRITEO_CARDINALITIES = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
                        2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
                        39664984, 585935, 12972, 108, 36)
DP = 2  # data-parallel ranks of phase 7, on card 0
# Phase 8: the MNIST example's path (examples/mnist/generate_petastorm_mnist.py,
# pytorch_example.py) at the size of MNIST's training split, and the batch
# loaders on phase 7's store.
READER = dict(rows=60_000, rows_per_row_group=200, seed=0, batch=64, shuffle=512, lr=0.01,
              epochs=2, split=[0.8, 0.2], drop_partitions=2, cache_bytes=512 * 2**20,
              selected_groups=10, tab_days=(2, 5), tab_batch=256, tab_shuffle=4096,
              inmem_epochs=3, dlrm_steps=20, mix=[0.75, 0.25], mix_draws=3000, warm_batches=10)
DP_GRAD_REL = 1e-6
# Phase 9: bench.py's leg_cached_epochs (bench.py:355-431: a 1 GiB memory
# cache, shuffle seed 7) and the image path through the cached,
# producer-staged loader (a 256 MiB memory tier over a disk tier).
LOADER = dict(leg_cache_bytes=1 << 30, seed=7, passes=6, mem_mb=256, stage_batches=12,
              stage_prefetch=(1, 4), resume_passes=2, resume_after=5)
# Phase 10: the ImageNet example's store (examples/imagenet: 512 synthetic rows of
# 375x500x3 png, row_group_size_mb=64) written at 1 encode worker and at 8 (one per
# core of an 8-core host) and read back in batches of 32; the LM corpus through the
# reference write forms; copy_dataset of the ImageNet store into 2 files.
ETL = dict(rows=512, row_group_mb=64, workers=(1, 8), batch=32, lm_docs=512,
           lm_rows_per_file=128, lm_encode_workers=4, lm_steps=12, copy_files=2)
# Phase 11: the process pool at phase 4's image store and width (1, 4 and 8
# workers: the chip host has 8 cores), the LM's 12 steps as phase 10 (b), and
# phase 7's Criteo-shaped store through the Arrow serializer.
POOL = dict(image=IMAGE, workers=(1, 4, 8), lm_steps=12,
            lm_launches={"fwd": 26, "dq": 24, "dkv": 24},
            tab_rows=TABULAR["rows"], tab_days=TABULAR["days"], tab_resume_after=3)
# Phase 12: the model-parallel families on 4 gloo ranks of card 0 (see
# parallel_phase): their JAX init defaults, phase 7's store and batch for the
# MoE, the pipeline and the DLRM (12 steps), phase 4's store and width for the
# image classifier (4 steps).
PARALLEL = dict(world=4, steps=12, batch=TABULAR["batch"], microbatches=8, lr=0.05,
                aux_weight=0.01, tab_rows=TABULAR["rows"], tab_days=TABULAR["days"],
                image=IMAGE, image_steps=4, moe=dict(d_model=32, d_hidden=64, num_experts=8),
                pipeline=dict(d_model=64, d_hidden=128), dlrm=dict(vocab_size=1024, embed_dim=16))
#: Phase 12's limits against the one-process run: losses (relative) and
#: parameters (rtol, atol, update), where "update" bounds a block's
#: distance to the one-process block over the distance that block moved in
#: training, |got - want| / |want - start| (2-norms): a parameter left
#: frozen, or a gradient summed over too few or too many ranks, gives 0.3
#: or more however little the parameter moves, where bf16 rounding alone
#: gives up to a few hundredths after a few small steps. The same code runs on
#: both sides, so the bf16 limits sit near the errors measured there (the
#: image classifier's losses differ by 1.2e-4 on an H100: its GEMMs and
#: convolutions round bf16 differently at half the batch and width).
PARALLEL_TOL = dict(loss=1e-5, params=(1e-4, 1e-5, 1e-3), top2=(2e-4, 2e-5, 1e-3),
                    bf16_loss=5e-4, bf16=(1e-4, 1e-4, 1e-1))
# Phase 13: bench.py's autotune leg (bench.py:1497-1595) on phase 4's store and
# CNN: three variants (reader workers, host_prefetch, device_prefetch, autotune),
# AUTOTUNE_EPOCHS 12 a pass, the leg's REPEATS cut from 2 to 1 (a warm-up round
# and one measured round, to keep the phase near a minute); then phase 7's
# Criteo-shaped table through the dataset converter into the autotuned device
# loader and the Criteo example's DLRM (examples/criteo_dlrm/train_dlrm.py:40-78:
# batch 256, 2 epochs, shard_seed 7, SGD at 0.05).
AUTOTUNE = dict(image=IMAGE, epochs=12, repeats=1,
                variants={"autotuned_defaults": (None, 4, 2, {"interval_s": 0.1,
                                                              "hysteresis": 1,
                                                              "tolerance": 0.08}),
                          "static_defaults": (None, 4, 2, None),
                          "hand_tuned": (1, 6, 2, None)},
                tab_rows=TABULAR["rows"], tab_days=TABULAR["days"], tab_batch=TABULAR["batch"],
                tab_epochs=TABULAR["epochs"], tab_lr=0.05, quiet_s=10.0)
# Phase 14, the data service: phase 4's image path through 2 workers (4 reader
# threads each, credits 8) and the JAX service_loopback_scenario's tabular
# shape (benchmark/scenarios.py:630: 2 workers of 2 reader threads, batch 512,
# credits 8) on phase 7's store.
SERVICE = dict(image=IMAGE, workers=2, workers_count=4, credits=8,
               tab_rows=TABULAR["rows"], tab_days=TABULAR["days"], tab_batch=512,
               tab_workers_count=2, kill_at=20, resume_at=25)
# Phase 15, the control plane: (a) phase 14 (a)'s image path for 2 epochs
# with client and worker heartbeats every 0.25 s and the dispatcher restarted
# from its journal after 6 of an epoch's 12 batches; (b) phase 14 (b)'s
# tabular shape under a slow peer with hedging, then under a tripped breaker;
# (c) one traced epoch of (a)'s path with the dispatcher and the workers in
# processes of their own.
CONTROL = dict(image=IMAGE, epochs=2, workers=2, workers_count=4, credits=8, heartbeat_s=0.25,
               restart_after=6, restart_slow_s=0.25, seed=15, tab_rows=TABULAR["rows"],
               tab_days=TABULAR["days"], tab_batch=512, tab_workers_count=2,
               hedge_delay_s=1.5, hedge_at=(12, 24, 36), hedge_quantile=0.9, drop_after=2)
# Phase 16, dynamic sharding: (a) phase 4's store through 2 workers of 1 and 4
# decode threads (credits 8, 2 epochs), static then dynamic (syncs every
# 0.1 s); (b) phase 14 (b)'s tabular shape (batch 512, 2 reader threads a
# worker, credits 8), ordered, one epoch on a journaled dynamic dispatcher,
# every send slowed 0.05 s so the epoch outlives a join after 4 batches and
# a restart; (c) a static tagged image stream with piece 5 poisoned; (d)
# phase 14's image path re-measured.
DYNAMIC = dict(image=IMAGE, epochs=2, threads=(1, 4), credits=8, sync_s=0.1,
               tab_rows=TABULAR["rows"], tab_days=TABULAR["days"], tab_batch=512,
               tab_workers_count=2, tab_delay_s=0.05, join_after=4, poison=5)
# Phase 17, the data plane of one host: (a) phase 14 (a)'s image path over
# TCP and over shm in turns (16 epochs: the warm ones are short), each worker
# with a memory batch cache, in this process and in processes of their own,
# then three traced warm epochs on each; (b) phase 14
# (b)'s tabular shape (2 workers of 2 reader threads, batch 512, credits 8)
# with a ColumnPredicate keeping a quarter of the rows and the DLRM's
# projection, filtered on the workers, on the client and by the local
# reader; (c) stage fusion and the cache placement on the image path with a
# worker-side transform; (d) an autotuned image run with the rewrites armed.
DATAPLANE = dict(image=IMAGE, workers=2, workers_count=4, credits=8, cache_mb=256,
                 a_epochs=16, a_order=("tcp", "shm", "shm", "tcp"), a_traced_epochs=4,
                 probe_tick_s=0.001,
                 tab_rows=TABULAR["rows"], tab_days=TABULAR["days"], tab_batch=512,
                 tab_workers_count=2, tab_keep_mod=4, tune_epochs=8,
                 tune={"interval_s": 0.25, "hysteresis": 1, "placement_hysteresis": 1,
                       "rewrite_hysteresis": 2, "probe_defer": 0})
# Phase 18, the fleet: (a) phase 4's store and CNN, two weighted jobs (2:1)
# for 3 epochs at once on the card through a dynamic fleet of 2 fleet-cache
# workers (4 decode threads, 256 MiB memory caches, credits 8), the second
# worker's warm sends slowed 0.1 s; (b) the autoscaler over the CLI (ticks
# of 0.25 s, journaled), the workers' transform pausing 0.1 s a batch, with
# the streak planner then the model's, 2 epochs a job; (c) chaos on one job's
# 2 epochs over 3 workers (each send slowed 0.1 s, the seeded events, kill,
# drain, cancel, from the first batch on), then a dispatcher restart alone
# after 4 batches.
FLEET = dict(image=IMAGE, workers=2, workers_count=4, credits=8, cache_mb=256, seed=18,
             weights=(2.0, 1.0), a_epochs=3, a_sync_s=30.0, sync_s=0.1, a_slow_s=0.1,
             heartbeat_s=0.25, b_epochs=2, b_heartbeat_s=0.05, b_lease_s=2.0,
             b_transform_s=0.1, autoscale_interval_s=0.25, c_epochs=2, c_workers=3,
             c_delay_s=0.1, c_seed=19, c_interval_s=0.25, c_restart_after=4)
# Phase 19, the LLM stages: phase 3's LM (d_model 64, 4 heads, 2 layers,
# vocab 64, slot_len 128, 4 slots, f32) over the capstone's corpus (512
# documents, max_len 48) served by 2 workers (collation batches of 64, 2
# decode threads) that pack it, 2 epochs; (b) resumes after 1, 5 and n - 1
# packed batches; (c) the corpus written with seeds 17 and 23 as corpora a
# and b of one journaled dispatcher, mixed 0.8:0.2 (seed 29), then 0.2:0.8
# from pass 2; (d) an autotuned run of 4 epochs from trainer placement.
LLM = dict(docs=512, max_len=48, slot_len=128, slots=4, d_model=64, heads=4, workers=2,
           batch=64, workers_count=2, epochs=2, seed=7, warm_from=3, cuts=(1, 5, -1),
           corpus_seeds=(17, 23), mix_seed=29,
           weights=({"a": 0.8, "b": 0.2}, {"a": 0.2, "b": 0.8}), mix_tol=0.1,
           tune_epochs=4, tune={"interval_s": 0.1, "hysteresis": 1, "placement_hysteresis": 1,
                                "probe_defer": 0})
# Phase 20: the scenarios run at the JAX defaults; (a) times 60 batches of
# 128 after 10; (c) and (d) share one shuffle seed; (f) fuzzes one seed.
BENCH_RUNS = dict(warmup=10, measure=60, batch=128, seed=7, fuzz_seed=7, timeout_s=300)
# Phase 21: a memory:// store of 16 row groups, three of them selected.
ADAPTERS = dict(rows=2048, rows_per_row_group=128, width=32, parts=(3, 7, 11), batch=64,
                seed=21)
SPIN_CYCLES_PER_S = 2.0e9  # above the H100's top SM clock: spins last at least as asked
SPIN_SHORT = {}  # label -> timing batches whose spin ended before the last call was queued


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def sh(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    return (out.stdout or out.stderr).strip()


def cuda_ms(label, fn, calls, batches=3):
    """``(device ms, host ms)`` of one ``fn()`` on the current stream.

    The host's time to queue ``calls`` calls is measured first (after one
    warm-up call): that is the host ms per call, the wrapper's checks,
    allocations and launch. Then, per batch, a spin kernel holds the stream
    for twice that time, the ``calls`` calls are queued behind it between two
    CUDA events, and the events' span over ``calls`` is the device time per
    call: the card runs them back to back and never waits on the host. The
    device ms is the median over ``batches``. A batch whose spin had ended
    before the host queued its last call is run again with twice the spin
    (up to 4 times); ``label`` and the batches still short then go into
    ``SPIN_SHORT``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s, retries, times = 2 * host_s + 1e-3, 0, []
    while len(times) < batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        short = start.query()
        torch.cuda.synchronize()
        if short and retries < 4:
            spin_s, retries = 2 * spin_s, retries + 1
            continue
        if short:
            SPIN_SHORT[label] = SPIN_SHORT.get(label, 0) + 1
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), host_s * 1e3 / calls


def make_case(B, T, H, D, dtype, Hkv=None, seg=None, lens=False, seed=0):
    """Random ``(q, k, v, do)`` on the card and the kernels' keywords:
    causal unless ``lens``; ``seg`` True for sorted ids of 8 segments, or a
    ``segment_ids`` kind."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    Hkv = Hkv or H

    def rnd(h):
        return torch.randn(B, T, h, D, device="cuda", generator=g).to(dtype)

    from petastorm_tpu_torch.ops.segment_layouts import segment_ids

    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    kw = dict(causal=True, causal_offset=0, kv_lengths=None, q_seg=None,
              kv_seg=None)
    if seg is True:
        ids = torch.randint(0, 8, (B, T), device="cuda", generator=g)
        kw["q_seg"] = kw["kv_seg"] = torch.sort(ids, dim=1).values.int().contiguous()
    elif seg:
        kw["q_seg"] = kw["kv_seg"] = torch.tensor(segment_ids(seg, B, T, seed),
                                                  device="cuda")
    if lens:
        kw["causal"] = False
        kw["kv_lengths"] = torch.randint(T // 4, T + 1, (B,), device="cuda",
                                         generator=g).int()
    return (q, k, v, do), kw


def kernel_layout(case):
    """``case`` (``make_case``'s) laid out as the autograd functions give
    the kernels their inputs: zero-padded to an instantiated head dim
    (``pad_head_dim``; ``D=8`` runs as ``D=16``, instantiated head dims stay
    as they are) with the true head dim's scale among the keywords."""
    from petastorm_tpu_torch.ops import flash_attention as fa

    tensors, kw = case
    tensors, kw["scale"] = fa.pad_head_dim(*tensors)
    return tuple(tensors), kw


def forward_with(fn, q, k, v, kw):
    """``(o, lse)`` from one launch of ``fn``, the ``ptt_flash_fwd`` of
    another build of ``flash_fwd.cu``, with the arguments the wrapper passes.
    The wrapper's launch counts do not move."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0] * q.shape[2], q.shape[1]), dtype=torch.float32,
                      device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(kw["q_seg"]),
             ptr(kw["kv_seg"]), ptr(kw["kv_lengths"]),
             *fa._dims(q, k, kw["causal"], kw["causal_offset"], kw.get("scale")),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ptt_flash_fwd failed with cudaError {err}")
    return o, lse


def dq_with(fn, q, k, v, o, lse, do, kw, dlse=None):
    """``(dq, delta)`` from one launch of ``fn``, the ``ptt_flash_bwd_dq`` of
    another build of ``flash_bwd_dq.cu``, with the arguments the wrapper
    passes (``dlse``, the lse cotangent, or null). The wrapper's launch
    counts do not move."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    dq = torch.empty_like(q)
    delta = torch.empty((q.shape[0] * q.shape[2], q.shape[1]), dtype=torch.float32,
                        device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dlse), ptr(delta),
             ptr(dq), ptr(kw["q_seg"]), ptr(kw["kv_seg"]), ptr(kw["kv_lengths"]),
             *fa._dims(q, k, kw["causal"], kw["causal_offset"], kw.get("scale")),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ptt_flash_bwd_dq failed with cudaError {err}")
    return dq, delta


def dkv_with(fn, q, k, v, do, lse, delta, kw):
    """``(dk, dv)`` from one launch of ``fn``, the ``ptt_flash_bwd_dkv`` of
    another build of ``flash_bwd_dkv.cu``, with the arguments the wrapper
    passes. The wrapper's launch counts do not move."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk), ptr(dv),
             ptr(kw["q_seg"]), ptr(kw["kv_seg"]), ptr(kw["kv_lengths"]),
             *fa._dims(q, k, kw["causal"], kw["causal_offset"], kw.get("scale")),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ptt_flash_bwd_dkv failed with cudaError {err}")
    return dk, dv


def counted(read_counts, launch):
    """``(launch()'s result, the two tile counts it left)``: a counting
    build's counts are read and cleared (``read_counts``, its
    ``ptt_*_tile_counts``) before and after the launch."""
    import ctypes

    import torch

    counts = (ctypes.c_ulonglong * 2)()

    def read_and_clear():
        torch.cuda.synchronize()
        err = read_counts(ctypes.addressof(counts))
        if err:
            raise RuntimeError(f"reading a kernel's tile counts failed with cudaError {err}")
        return tuple(counts)

    read_and_clear()
    out = launch()
    return out, read_and_clear()


def count_tiles(name, count_libs, tensors, kw, kernel_out, dlse=None):
    """The three tile-skipping kernels' work on these inputs, counted on the
    card by one launch of each counting build (``count_libs``: kernel name
    -> its ``ptt_*`` entry point and ``ptt_*_tile_counts``): ``{"fwd": (K
    tiles its blocks load, FWD_WARP_Q x FWD_BLOCK_K tiles its warps
    compute), "dq": (K tiles its blocks load, DQ_WARP_Q x DQ_BLOCK_K tiles
    its warps compute), "dkv": (Q tiles its blocks load, DKV_WARP_K x
    DKV_BLOCK_Q tiles its warps compute)}`` over all heads. Raises unless the
    counts equal ``visited_k_tiles``'s and ``visited_q_tiles``'s and each
    counting build's output equals the kernel's (``kernel_out``: ``{"fwd":
    (o, lse), "dq": (dq, delta), "dkv": (dk, dv)}``) bit for bit."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = tensors
    (o, lse), delta = kernel_out["fwd"], kernel_out["dq"][1]  # delta less any dlse
    B, Tq, H = q.shape[:3]
    masks = dict(causal=kw["causal"], causal_offset=kw["causal_offset"],
                 kv_lengths=kw["kv_lengths"], q_seg=kw["q_seg"], kv_seg=kw["kv_seg"])
    launches = {
        "fwd": lambda fn: forward_with(fn, q, k, v, kw),
        "dq": lambda fn: dq_with(fn, q, k, v, o, lse, do, kw, dlse),
        "dkv": lambda fn: dkv_with(fn, q, k, v, do, lse, delta, kw),
    }
    want = {
        "fwd": tuple(int(fa.visited_k_tiles(B, Tq, k.shape[1], block_q=rows, **masks).sum())
                     * H for rows in (fa.FWD_BLOCK_Q, fa.FWD_WARP_Q)),
        "dq": tuple(int(fa.visited_k_tiles(B, Tq, k.shape[1], block_q=rows,
                                           block_k=fa.DQ_BLOCK_K, **masks).sum())
                    * H for rows in (fa.DQ_BLOCK_Q, fa.DQ_WARP_Q)),
        "dkv": tuple(int(fa.visited_q_tiles(B, Tq, k.shape[1], block_k=keys, **masks).sum())
                     * H for keys in (fa.DKV_BLOCK_K, fa.DKV_WARP_K)),
    }
    for kernel, (fn, read_counts) in count_libs.items():
        out, got = counted(read_counts, lambda: launches[kernel](fn))
        if got != want[kernel]:
            raise AssertionError(f"{name}: {kernel} loaded / computed {got} tiles on the "
                                 f"card, its mirror says {want[kernel]}")
        if not all(torch.equal(a, b) for a, b in zip(out, kernel_out[kernel])):
            raise AssertionError(f"{name}: {kernel}'s counting build's output differs "
                                 "from the kernel's")
    return want


def check_case(name, tensors, kw, count_libs, dlse=None):
    """Run all three kernels and their plain versions on the same inputs
    (``dlse``: an lse cotangent for the dQ kernel, or None), launch dQ and
    dK/dV twice each (the two results must be bit-identical), and count the
    kernels' tiles (``count_tiles``); return the error and tile line and
    each kernel's max absolute error, and raise on a tolerance miss: the
    forward absolute in f32 and within one bf16 step elementwise in bf16
    (``fwd_steps`` ≤ 1); lse and delta absolute (f32 for both dtypes);
    gradients relative to the largest gradient."""
    import torch

    from petastorm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = tensors
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=dlse, **kw)
    dq2, delta2 = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, dlse=dlse, **kw)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, dlse=dlse, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError(f"{name}: two launches of the dQ kernel differ")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{name}: two launches of the dK/dV kernel differ")
    tiles = count_tiles(name, count_libs, tensors, kw,
                        {"fwd": (o, lse), "dq": (dq, delta), "dkv": (dk, dv)}, dlse)
    bf16 = q.dtype == torch.bfloat16
    abs_err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    errs = {"fwd": abs_err(o, o_p)}
    max_abs = {"fwd": errs["fwd"], "dq": abs_err(dq, dq_p),
               "dkv": max(abs_err(dk, dk_p), abs_err(dv, dv_p))}
    finite = torch.isfinite(lse_p)
    if not torch.equal(finite, torch.isfinite(lse)):
        raise AssertionError(f"{name}: lse empty-row pattern differs")
    errs["lse"] = (lse[finite] - lse_p[finite]).abs().max().item()
    if dlse is not None:  # delta carries the lse cotangent into both backward kernels
        B, T, H = q.shape[:3]
        want = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, T) - dlse
        errs["delta"] = (delta - want).abs().max().item()
    for key, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        scale = want.float().abs().max().item() or 1.0
        errs[key] = abs_err(got, want) / scale
    # delta against rowsum(dout * o) - dlse on the kernel's own o: f32 sums
    # of exact products (bf16 products are exact in f32) in another order.
    limits = {"fwd": F32_FWD_ABS, "lse": F32_FWD_ABS, "delta": F32_FWD_ABS}
    if bf16:
        del errs["fwd"]
        g, w = o.float(), o_p.float()
        errs["fwd_steps"] = ((g - w).abs() / (
            BF16_STEP * torch.maximum(g.abs(), w.abs()) + BF16_ABS)).max().item()
        limits["fwd_steps"] = 1.0
    limits.update({g: BF16_GRAD_REL if bf16 else F32_GRAD_REL
                   for g in ("dq", "dk", "dv")})
    for key, err in errs.items():
        if not err <= limits[key]:
            raise AssertionError(
                f"{name}: {key} error {err:.3e} above {limits[key]:.0e}")
    return (name + " " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
            + " tiles fwd={}/{} dq={}/{} dkv={}/{}".format(*tiles["fwd"], *tiles["dq"],
                                                          *tiles["dkv"]), max_abs)


def visible_pairs(kw, B, T, H):
    """Visible (query, key) pairs of this run's masks, over all heads."""
    import torch

    rows = torch.arange(T, device="cuda")
    total = 0
    for b in range(B):
        for r0 in range(0, T, 1024):
            r = rows[r0:r0 + 1024]
            ok = rows[None, :] <= r[:, None] if kw["causal"] else \
                torch.ones(len(r), T, dtype=torch.bool, device="cuda")
            if kw["q_seg"] is not None:
                ok = ok & (kw["q_seg"][b, r0:r0 + 1024, None]
                           == kw["kv_seg"][b, None, :])
            if kw["kv_lengths"] is not None:
                ok = ok & (rows[None, :] < kw["kv_lengths"][b])
            total += int(ok.sum())
    return total * H


def measure(shape, count_libs):
    """Times and bounds of the three kernels, and of dQ + dK/dV together, on
    a causal + segment-ids f32 case of ``shape``; the visible pairs; and the
    tiles each kernel loads and computes, counted on the card."""
    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch.ops import flash_attention as fa

    B, T, H, D = shape["B"], shape["T"], shape["H"], shape["D"]
    (q, k, v, do), kw = make_case(B, T, H, D, torch.float32, seg=True, seed=1)
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    dq, delta = fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    tiles = count_tiles(f"timed T={T}", count_libs, (q, k, v, do), kw,
                        {"fwd": (o, lse), "dq": (dq, delta), "dkv": (dk, dv)})
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    _, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, **kw)

    calls = 50 if T <= 1024 else 10  # kernel calls per timing batch
    tag = f"T={T}"
    times = {
        "fwd": (cuda_ms(f"fwd {tag}", lambda: fa.flash_forward_kernel(q, k, v, **kw),
                        calls),
                cuda_ms(f"fwd plain {tag}",
                        lambda: fa.flash_forward_plain(q, k, v, **kw), 3)),
        "dq": (cuda_ms(f"dq {tag}",
                       lambda: fa.flash_bwd_dq_kernel(q, k, v, o, lse, do, **kw), calls),
               cuda_ms(f"dq plain {tag}",
                       lambda: fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, **kw), 3)),
        "dkv": (cuda_ms(f"dkv {tag}",
                        lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw),
                        calls),
                cuda_ms(f"dkv plain {tag}",
                        lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, **kw),
                        3)),
    }

    # Yardstick: SDPA on the same inputs with the same mask (materialized
    # once, outside the timing). Its backward yields dq, dk, dv together.
    mask = (torch.ones(T, T, dtype=torch.bool, device="cuda").tril()[None]
            & (kw["q_seg"][:, :, None] == kw["kv_seg"][:, None, :]))[:, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_fwd, _ = cuda_ms(
        f"sdpa fwd {tag}",
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), calls)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)
    sdpa_bwd, _ = cuda_ms(f"sdpa bwd {tag}",
                          lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                      retain_graph=True), calls)

    pairs = visible_pairs(kw, B, T, H)
    counts = {  # (query, key) pairs computed and tiles loaded, counted on the card
        "fwd pairs computed": tiles["fwd"][1] * fa.FWD_WARP_Q * fa.FWD_BLOCK_K,
        "fwd K-tile loads": tiles["fwd"][0],
        "dq pairs computed": tiles["dq"][1] * fa.DQ_WARP_Q * fa.DQ_BLOCK_K,
        "dq K-tile loads": tiles["dq"][0],
        "dkv pairs computed": tiles["dkv"][1] * fa.DKV_WARP_K * fa.DKV_BLOCK_Q,
        "dkv Q-tile loads": tiles["dkv"][0],
    }
    elt = 4
    act = B * T * H * D * elt      # one [B, T, H, D] f32 tensor
    row = B * H * T * 4            # one f32 per (b, h, row): lse or delta
    seg = 2 * B * T * 4
    work = {  # (bytes each input read once / each output written once, FLOPs)
        "fwd": (3 * act + act + row + seg, 4 * D * pairs),
        "dq": (5 * act + row + act + row + seg, 6 * D * pairs),
        "dkv": (4 * act + 2 * row + 2 * act + seg, 8 * D * pairs),
        # dq, dk, dv from q, k, v, o, do, lse: s and dp once, then three
        # products (SDPA's backward computes this function).
        "bwd": (5 * act + row + 3 * act + seg, 10 * D * pairs),
    }
    (dq_ms, dq_host), (dq_plain, _) = times["dq"]
    (dkv_ms, dkv_host), (dkv_plain, _) = times["dkv"]
    times["bwd"] = ((dq_ms + dkv_ms, dq_host + dkv_host), (dq_plain + dkv_plain, None))
    library = {"fwd": sdpa_fwd, "bwd": sdpa_bwd}
    out = {}
    for name, ((ms, host_ms), (plain_ms, _)) in times.items():
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_TC_FLOPS * 1e3
        out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations",
                     "library_ms": library.get(name)}
    return out, pairs, counts


def synced_ms(fn, calls=5):
    """Median host ms of one ``fn()`` between two synchronises, after one
    warm-up call: for a function that itself waits on the card, which
    ``cuda_ms``'s spin cannot time."""
    import torch

    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def sparse_sgd_case():
    """The DLRM's sparse table update (``ops/sparse_sgd.py``) at
    ``SPARSE_SGD``'s shape: the kernel path against the plain version run on
    the CPU on the named rows, tables and touched counts bit for bit, and
    every other row unchanged; then the kernel path's device and wrapper
    host ms (sort and kernel, by ``cuda_ms``), the plain version's on the
    card (it reads the count of named rows back), the bound (each row
    gradient and index entry read once, each named row read and written
    once, at 3.35 TB/s), and the kernel path on the longest run alone."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.ops import sparse_sgd as ss

    cfg = SPARSE_SGD
    rows, dim, lr = cfg["rows"], cfg["dim"], cfg["lr"]
    cards = np.array(CRITEO_CARDINALITIES)
    rng = np.random.RandomState(cfg["seed"])
    ids = (rng.zipf(cfg["zipf"], (cfg["batch"], cards.size)) - 1) % cards % rows
    index = (torch.from_numpy(ids).cuda()
             + torch.arange(cards.size, device="cuda") * rows).reshape(-1)
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    table = torch.empty((cards.size * rows, dim), device="cuda").normal_(0.0, 0.05,
                                                                         generator=gen)
    grads = torch.randn((index.numel(), dim), device="cuda", generator=gen)
    before = table.clone()
    touched = ss.sparse_sgd_kernel(table, index, grads, lr)
    # The plain version on the CPU (on the card its index_add_ adds in no
    # fixed order), on the named rows alone: the rest must be unchanged.
    named, inverse, counts = torch.unique(index, return_inverse=True, return_counts=True)
    want = before[named].cpu()
    want_touched = ss.sparse_sgd_plain(want, inverse.cpu(), grads.cpu(), lr)
    got = table[named].cpu()
    before[named] = table[named]
    if not torch.equal(got, want) or not torch.equal(table, before):
        fail(f"kernels: sparse_sgd differs from its plain version on "
             f"{int((got != want).any(1).sum())} named rows and changed "
             f"{int((table != before).any(1).sum())} others")
    if not int(touched) == int(want_touched) == named.numel():
        fail(f"kernels: sparse_sgd touched {int(touched)} rows, its plain version "
             f"{int(want_touched)}, the index names {named.numel()}")
    del before
    ms, host_ms = cuda_ms("sparse_sgd", lambda: ss.sparse_sgd_kernel(table, index, grads, lr),
                          50)
    plain_ms = synced_ms(lambda: ss.sparse_sgd_plain(table, index, grads, lr))
    hot = torch.full((int(counts.max()),), int(named[counts.argmax()]), device="cuda")
    hot_ms, _ = cuda_ms("sparse_sgd longest run",
                        lambda: ss.sparse_sgd_kernel(table, hot, grads[:hot.numel()], lr), 50)
    bound_ms = 1e3 * (index.numel() * (dim * 4 + 8) + 2 * named.numel() * dim * 4) \
        / HBM_BYTES_PER_S
    return {"lookups": index.numel(), "rows_named": named.numel(),
            "longest_run": int(counts.max()), "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "longest_run_ms": hot_ms}


def device_busy_pct(trace_path, batch_bytes, first_timed_batch, copies_per_batch=1):
    """The share (%) of a window of a ``torch.profiler`` Chrome trace during
    which the card ran a kernel, a copy or a memset (their union). The
    window opens at the start of the first copy of the ``first_timed_batch``-th
    batch: the copies of ``batch_bytes`` bytes (a batch's raw images, or one
    of its columns) come ``copies_per_batch`` to a batch, in batch order,
    and the window opens at copy ``first_timed_batch * copies_per_batch``.
    It closes at the end of the last device event. "not measured" when the
    trace holds no such copy."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    copies = sorted(e["ts"] for e in events if e.get("cat") == "gpu_memcpy"
                    and e.get("args", {}).get("bytes") == batch_bytes)
    first = first_timed_batch * copies_per_batch
    if len(copies) <= first:
        return "not measured"
    start, end = copies[first], max(e for _, e in device)
    busy, reach = 0.0, start
    for s, e in device:
        s, e = max(s, reach), min(e, end)
        if e > s:
            busy += e - s
            reach = e
    return f"{100.0 * busy / (end - start):.2f}"


def image_phase(smi):
    """Phase 4 (see the module docstring); fails the run on any check."""
    import copy

    import numpy as np
    import torch

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage

    cfg = IMAGE
    stage_kw = dict(normalize=(127.5, 127.5), crop=cfg["crop"], flip=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_img_")
    try:
        url = f"file://{tmp}/images"
        t0 = time.perf_counter()
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=cfg["rows"],
                                  image_shape=cfg["image_shape"], num_classes=cfg["classes"],
                                  rows_per_row_group=cfg["rows_per_row_group"])
        write_s = time.perf_counter() - t0

        # The host's ceiling: the training run's reader and collation with
        # no device, timed as the training run is (after the first epoch).
        warm = -(-cfg["rows"] // cfg["batch"])
        with make_reader(url, schema_fields=["image", "label"], num_epochs=cfg["epochs"],
                         shuffle_row_groups=True, shard_seed=0) as reader:
            raw, n, t0 = None, 0, None
            for i, batch in enumerate(batch_iterator(reader, cfg["batch"])):
                raw = batch["image"] if raw is None else raw
                if i == warm:
                    t0 = time.perf_counter()
                if t0 is not None:
                    n += len(batch["image"])
            ceiling = n / (time.perf_counter() - t0)

        # The stage: card against CPU, and against the selection of its draws.
        raw_cpu = torch.from_numpy(raw)
        raw_dev = raw_cpu.cuda()
        for dtype in (torch.float32, torch.bfloat16):
            stage = DeviceStage(output_dtype=dtype, **stage_kw)
            got = stage.apply({"image": raw_dev}, 5)["image"]
            if not torch.equal(got.cpu(), stage.apply({"image": raw_cpu}, 5)["image"]):
                fail(f"the device stage's card output ({dtype}) differs from its CPU output")
        draws = stage.draws(5, 0, raw.shape)
        (ch, cw), sel = cfg["crop"], []
        for img, (r, c), flip in zip(raw, draws["offsets"], draws["flips"]):
            img = img[r:r + ch, c:c + cw]
            sel.append(img[:, ::-1] if flip else img)
        want = (np.stack(sel).astype(np.float32) - np.float32(127.5)) * (
            np.float32(1.0) / np.float32(127.5))
        got = DeviceStage(**stage_kw).apply({"image": raw_dev}, 5)["image"].cpu().numpy()
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            fail("the device stage's crop / flip is not the selection its draws name")
        stage = DeviceStage(**stage_kw)
        stage_ms, _ = cuda_ms("device stage", lambda: stage.apply({"image": raw_dev}, 0), 20)

        # f32 logits, card against CPU, same weights (TF32 is off).
        in_shape = cfg["crop"] + (cfg["image_shape"][2],)
        cpu_model = ic.init_image_classifier(in_shape, cfg["classes"], hidden=cfg["hidden"],
                                             conv_features=cfg["conv_features"],
                                             compute_dtype=torch.float32, device="cpu")
        card_model = copy.deepcopy(cpu_model).cuda()
        x = stage.apply({"image": raw_cpu[:8]}, 0)["image"]
        with torch.no_grad():
            want = cpu_model(x)
            got = card_model(x.cuda()).cpu()
        logit_err = float((got - want).abs().max() / want.abs().max())
        if not logit_err <= LOGIT_REL:
            fail(f"f32 logits on the card differ from the CPU module's by {logit_err:.2e} "
                 f"of the largest, above {LOGIT_REL:.0e}")
        del cpu_model, card_model

        # The model step alone, on a resident batch (bf16 compute).
        model = ic.init_image_classifier(in_shape, cfg["classes"], hidden=cfg["hidden"],
                                         conv_features=cfg["conv_features"], device="cuda")
        step = ic.make_image_train_step(model, cfg["lr"])
        images = stage.apply({"image": raw_dev}, 0)["image"]
        labels = torch.zeros(cfg["batch"], dtype=torch.int32, device="cuda")
        mask = torch.ones(cfg["batch"], dtype=torch.bool, device="cuda")
        for _ in range(3):
            step(images, labels, mask)
        step_device_ms, step_host_ms = cuda_ms("image model step",
                                               lambda: step(images, labels, mask), 20)
        del model, step, images

        fa.reset_launch_counts()
        result = ic.train_image_classifier(
            url, batch_size=cfg["batch"], epochs=cfg["epochs"], num_classes=cfg["classes"],
            conv_features=cfg["conv_features"], hidden=cfg["hidden"],
            learning_rate=cfg["lr"], device_stage=DeviceStage(**stage_kw), device="cuda")
        launches = dict(fa.LAUNCHES)

        # The card's busy share in the timed window, from a trace of a second,
        # identical run (CUDA activity only): the union of its kernels,
        # copies and memsets from the H2D copy of the first timed batch's raw
        # images to the last device event.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = ic.train_image_classifier(
                url, batch_size=cfg["batch"], epochs=cfg["epochs"],
                num_classes=cfg["classes"], conv_features=cfg["conv_features"],
                hidden=cfg["hidden"], learning_rate=cfg["lr"],
                device_stage=DeviceStage(**stage_kw), device="cuda")
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy_pct = device_busy_pct(trace, cfg["batch"] * int(np.prod(cfg["image_shape"])),
                                   traced["warmup_steps"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses, warm = result["losses"], result["warmup_steps"]
    diag = result["diagnostics"]
    if result["batch_devices"] != ["cuda:0"]:
        fail(f"image batches arrived on {result['batch_devices']}, not cuda:0")
    if not all(math.isfinite(x) for x in losses) or not (
            np.mean(losses[-warm:]) < np.mean(losses[:warm])):
        fail(f"image loss not finite and falling: {losses}")
    per_row = diag["h2d_bytes"] / diag["rows"]
    if per_row != int(np.prod(cfg["image_shape"])) + 4:
        fail(f"{per_row} H2D bytes per row, expected 12,288 (raw image) + 4 (label)")
    print(f"image: gpu={smi!r} codec={IMAGE_CODEC} rows={cfg['rows']} batch={cfg['batch']} "
          f"crop={cfg['crop']} conv={cfg['conv_features']} hidden={cfg['hidden']} "
          f"steps={len(losses)} warmup_steps={warm} "
          f"images_per_s={result['images_per_s']:.1f} step_ms={result['step_ms']:.3f} "
          f"model_step_device_ms={step_device_ms:.3f} model_step_host_ms={step_host_ms:.3f} "
          f"host_decode_ceiling_images_per_s={ceiling:.1f} "
          f"stage_device_ms_per_batch={stage_ms:.4f} "
          f"consumer_ms_per_step={1e3 * diag['consumer_s'] / diag['batches']:.3f} "
          f"traced_images_per_s={traced['images_per_s']:.1f} "
          f"device_busy_pct_traced={busy_pct} "
          f"input_stall_pct={diag['input_stall_pct']} "
          f"dispatch_overlap_pct={diag['dispatch_overlap_pct']} "
          f"h2d_bytes_per_image={per_row:.1f} "
          f"raw_stage_s={diag['raw_stage_s']:.4f} device_decode_s={diag['device_decode_s']:.4f} "
          f"peak_mem_mib={result['peak_memory_bytes'] / 2**20:.1f} "
          f"logit_rel_err_f32={logit_err:.2e} dataset_write_s={write_s:.2f} "
          f"loss_first_epoch={np.mean(losses[:warm]):.4f} "
          f"loss_last_epoch={np.mean(losses[-warm:]):.4f} flash_launches={launches}",
          flush=True)
    return {"images_per_s": result["images_per_s"],
            "consumer_ms_per_step": 1e3 * diag["consumer_s"] / diag["batches"],
            "input_stall_pct": diag["input_stall_pct"], "device_busy_pct_traced": busy_pct}



def quarter_means(losses):
    """Mean loss over the first and the last quarter of a run."""
    n = max(1, len(losses) // 4)
    return sum(losses[:n]) / n, sum(losses[-n:]) / n


def seq_phase():
    """Phase 5 (see the module docstring); fails the run on any check."""
    from petastorm_tpu_torch.models import sequence_training as st
    from petastorm_tpu_torch.ops import flash_attention as fa

    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    try:
        frames_url, ragged_url = f"file://{tmp}/frames", f"file://{tmp}/ragged"
        st.generate_frames_dataset(frames_url)
        st.generate_ragged_dataset(ragged_url)
        runs = {
            "sequence": lambda: st.train_sequence(frames_url, steps=SEQ_STEPS,
                                                  attn_impl="flash", device="cuda"),
            "ragged": lambda: st.train_ragged_causal(ragged_url, steps=SEQ_STEPS,
                                                     device="cuda"),
            "packed": lambda: st.train_packed_causal(ragged_url, steps=SEQ_STEPS,
                                                     device="cuda"),
        }
        out = {}
        for name, run in runs.items():
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            result = run()
            seconds = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)
            losses = result["losses"]
            if len(losses) != SEQ_STEPS or not all(math.isfinite(x) for x in losses):
                fail(f"seq {name}: {len(losses)} losses, finite: {losses}")
            first, last = quarter_means(losses)
            if name != "sequence" and not last < first:
                fail(f"seq {name}: loss did not fall (first quarter {first:.4f}, "
                     f"last {last:.4f}): {losses}")
            if min(launches.values()) < 1:
                fail(f"seq {name}: a kernel was not launched: {launches}")
            out[name] = (first, last, seconds, launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("seq: head_dim=8 (run as 16, zero-padded) steps=" + str(SEQ_STEPS) + " "
          + " ".join(f"{n}: loss_first_quarter={f:.4f} loss_last_quarter={la:.4f} "
                     f"seconds={sec:.2f} launches={lc}"
                     for n, (f, la, sec, lc) in out.items()), flush=True)


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / (
        want.float().abs().max().item() or 1.0)


def _grads(loss_fn, model):
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def sp_rank(rank, out_dir, corpus_url, ragged_url):
    """One rank of phase 6 (a gloo group of ``SP`` ranks on card 0): runs
    every check (raising on a miss) and writes its numbers to
    ``<out_dir>/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = sp_checks(dist.group.WORLD, corpus_url, ragged_url)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sp_checks(group, corpus_url, ragged_url):
    """The checks of one rank of phase 6; returns its numbers."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.models import long_context_lm as lm
    from petastorm_tpu_torch.models import sequence_model as sm
    from petastorm_tpu_torch.models import sequence_training as st
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_POSITION_KEY,
        PACK_SEGMENT_KEY,
        pack_ragged,
    )

    out = {}
    # Ring (both placements) and Ulysses, flash local, against the dense
    # oracle on the card: outputs and q/k/v gradients.
    B, T, H = LM["B"], LM["T"], LM["H"]
    for d in (LM["D"], 8):
        g = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, w = (torch.randn(B, T, H, d, device="cuda", generator=g) for _ in range(4))
        seg = torch.sort(torch.randint(0, 6, (B, T), device="cuda", generator=g),
                         dim=1).values.int()
        ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = sm.attention_reference(*ref_in, causal=True, segment_ids=seg)
        (ref * w).sum().backward()
        for name, attn in (
                ("ring_striped", lambda a, b, c: sm.ring_attention(
                    a, b, c, group, causal=True, placement="striped", segment_ids=seg,
                    local_attn="flash")),
                ("ring_contiguous", lambda a, b, c: sm.ring_attention(
                    a, b, c, group, causal=True, placement="contiguous", segment_ids=seg,
                    local_attn="flash")),
                ("ulysses", lambda a, b, c: sm.ulysses_attention(
                    a, b, c, group, causal=True, segment_ids=seg, local_attn="flash"))):
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.reset_launch_counts()
            got = attn(*x)
            (got * w).sum().backward()
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
            err = (got - ref).abs().max().item()
            grad_err = max(_rel(a.grad, b.grad) for a, b in zip(x, ref_in))
            if not (err <= F32_FWD_ABS and grad_err <= F32_GRAD_REL):
                raise AssertionError(f"{name} D={d}: output error {err:.3e} (limit "
                                     f"{F32_FWD_ABS:.0e}), gradient error {grad_err:.3e} "
                                     f"(limit {F32_GRAD_REL:.0e}) against the dense oracle")
            if min(launches.values()) < 1:
                raise AssertionError(f"{name} D={d}: a kernel was not launched: {launches}")
            out[f"{name}_d{d}"] = {"out_err": err, "grad_rel_err": grad_err,
                                   "launches": launches}

    # The LM capstone at its full configuration over the group.
    fa.reset_launch_counts()
    result = lm.train_lm(corpus_url, slot_len=LM["T"], slots=LM["B"], steps=SP_TRAIN_STEPS,
                         num_heads=4, d_model=64, epochs=8, device="cuda", group=group)
    launches = dict(fa.LAUNCHES)
    losses = result["losses"]
    if len(losses) != SP_TRAIN_STEPS or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"sp LM: loss not finite and falling over {SP_TRAIN_STEPS} "
                             f"steps: {losses}")
    if not result["logit_parity"] <= PARITY_TOL:
        raise AssertionError(f"sp LM: ring vs dense logits differ by "
                             f"{result['logit_parity']:.3e}")
    if min(launches.values()) < 1:
        raise AssertionError(f"sp LM: a kernel was not launched: {launches}")
    # Its parameter gradients on one packed batch, against one process's.
    rng = np.random.RandomState(9)
    rows = [{"tokens": rng.randint(0, 64, int(rng.randint(8, 49))).astype(np.int32)}
            for _ in range(40)]
    packed = next(pack_ragged(iter(rows), slot_len=LM["T"], slots=LM["B"]))
    batch = [torch.from_numpy(packed[key]).cuda()
             for key in ("tokens", PACK_POSITION_KEY, PACK_SEGMENT_KEY)]
    model = lm.init_lm_params(0, d_model=64, num_heads=4, slot_len=LM["T"], device="cuda")
    loss_sp, grads_sp = _grads(lambda: lm.lm_loss(model, *batch, group=group), model)
    loss_one, grads_one = _grads(lambda: lm.lm_loss(model, *batch), model)
    lm_grad_err = max(_rel(grads_sp[n], grads_one[n]) for n in grads_one)
    if not (lm_grad_err <= F32_GRAD_REL and abs(loss_sp - loss_one) <= 1e-5 * abs(loss_one)):
        raise AssertionError(f"sp LM: gradients differ from one process's by "
                             f"{lm_grad_err:.3e} of the largest (loss {loss_sp} vs "
                             f"{loss_one})")
    out["lm"] = {"losses": losses, "steps_per_s": result["steps_per_s"],
                 "logit_parity": result["logit_parity"], "launches": launches,
                 "grad_rel_err": lm_grad_err,
                 "peak_mem_mib": result["peak_memory_bytes"] / 2 ** 20}

    # The sequence encoder over the group, ring and Ulysses, with their
    # default local attention (the kernels, for CUDA tensors): one step's
    # gradients against one process's, then training runs.
    gen = np.random.RandomState(10)
    windows = torch.tensor(gen.randn(16, 24, 6), dtype=torch.float32, device="cuda")
    labels = torch.tensor(gen.randint(0, 3, 16), device="cuda")
    mask = torch.ones(16, dtype=torch.bool, device="cuda")
    lengths = torch.tensor(gen.randint(4, 25, 16), dtype=torch.int32, device="cuda")
    model = sm.init_seq_params(1, feature_dim=6, d_model=32, num_heads=4, num_classes=3,
                               device="cuda")
    kw = dict(causal=True, compute_dtype=torch.float32)
    _, grads_one = _grads(lambda: sm.seq_loss(model, windows, labels, mask, lengths,
                                              attn_impl="flash", **kw), model)
    for impl in ("ring", "ulysses"):
        fa.reset_launch_counts()
        _, grads_sp = _grads(lambda: sm.seq_loss(model, windows, labels, mask, lengths,
                                                 group=group, attn_impl=impl, **kw), model)
        seq_launches = dict(fa.LAUNCHES)
        err = max(_rel(grads_sp[n], grads_one[n]) for n in grads_one)
        if not err <= F32_GRAD_REL or min(seq_launches.values()) < 1:
            raise AssertionError(f"sp seq {impl}: gradients differ from one process's by "
                                 f"{err:.3e}, launches {seq_launches}")
        t0 = time.perf_counter()
        trained = st.train_ragged_causal(ragged_url, steps=SEQ_STEPS, group=group,
                                         attn_impl=impl, device="cuda")
        seconds = time.perf_counter() - t0
        if not all(math.isfinite(x) for x in trained["losses"]):
            raise AssertionError(f"sp seq {impl}: losses not finite: {trained['losses']}")
        out[f"seq_{impl}"] = {"grad_rel_err": err, "launches": seq_launches,
                              "loss_quarters": quarter_means(trained["losses"]),
                              "train_s": seconds}
    fa.reset_launch_counts()
    packed_run = st.train_packed_causal(ragged_url, steps=SEQ_STEPS, group=group,
                                        device="cuda")
    if not all(math.isfinite(x) for x in packed_run["losses"]) \
            or min(fa.LAUNCHES.values()) < 1:
        raise AssertionError(f"sp packed: losses {packed_run['losses']}, "
                             f"launches {fa.LAUNCHES}")
    out["packed_ring"] = {"loss_quarters": quarter_means(packed_run["losses"]),
                          "launches": dict(fa.LAUNCHES)}
    return out


def sp_phase(one_process_steps_per_s):
    """Phase 6 (see the module docstring): ``SP`` spawned ranks on card 0;
    fails the run if a rank fails or does not finish."""
    from petastorm_tpu_torch.models.long_context_lm import generate_corpus
    from petastorm_tpu_torch.models.sequence_training import generate_ragged_dataset
    from petastorm_tpu_torch.torch_utils.mesh import run_ranks

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        corpus_url, ragged_url = f"file://{tmp}/corpus", f"file://{tmp}/ragged"
        generate_corpus(corpus_url)
        generate_ragged_dataset(ragged_url)
        t0 = time.perf_counter()
        try:
            run_ranks(sp_rank, SP, tmp, args=(tmp, corpus_url, ragged_url),
                      timeout_s=SP_TIMEOUT_S, cuda_device=0)
        except RuntimeError as exc:
            fail(f"sp: {exc}")
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(SP):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if ranks[0]["lm"]["losses"] != ranks[1]["lm"]["losses"]:
        fail(f"sp: the ranks' LM losses differ: {[r['lm']['losses'] for r in ranks]}")
    r0 = ranks[0]
    attn = " ".join(f"{n}: out_err={v['out_err']:.2e} grad_rel_err={v['grad_rel_err']:.2e}"
                    for n, v in r0.items() if "out_err" in v)
    lm_r = r0["lm"]
    print(f"sp: ranks={SP} on cuda:0, transport=gloo with pinned-host staging "
          f"(NCCL refuses two ranks on one card) | {attn} | lm d_model=64 heads=4 D=16 "
          f"layers=2 slot_len={LM['T']} slots={LM['B']} steps={len(lm_r['losses'])} "
          f"losses={[round(x, 4) for x in lm_r['losses']]} "
          f"logit_parity={lm_r['logit_parity']:.2e} grad_rel_err={lm_r['grad_rel_err']:.2e} "
          f"launches={lm_r['launches']} peak_mem_mib={lm_r['peak_mem_mib']:.1f} | "
          + " ".join(f"{n}: grad_rel_err={r0[n]['grad_rel_err']:.2e} "
                     f"loss_quarters={[round(x, 4) for x in r0[n]['loss_quarters']]} "
                     f"launches={r0[n]['launches']}" for n in ("seq_ring", "seq_ulysses"))
          + f" packed_ring: loss_quarters="
          f"{[round(x, 4) for x in r0['packed_ring']['loss_quarters']]} "
          f"| seconds={seconds:.1f}", flush=True)
    print(f"sp step times (this transport, not a claim): lm sp=2 "
          f"steps_per_s={lm_r['steps_per_s']:.2f} "
          f"(ranks: {[round(r['lm']['steps_per_s'], 2) for r in ranks]}) vs one process "
          f"{one_process_steps_per_s:.2f}; seq ragged {SEQ_STEPS} steps: ring "
          f"{r0['seq_ring']['train_s']:.2f} s, ulysses {r0['seq_ulysses']['train_s']:.2f} s",
          flush=True)


def reader_phase(smi, cfg=READER, device="cuda"):
    """Phase 8 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run on
    the card uses the defaults."""
    import random
    import threading

    import numpy as np
    import torch

    from petastorm_tpu_torch import local_disk_cache
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.models import mnist
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.predicates import in_pseudorandom_split, in_set
    from petastorm_tpu_torch.pytorch import BatchedDataLoader, DataLoader, InMemBatchedDataLoader
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def traced(run, trace_path, batch_bytes):
        """``run()``'s result and the card's busy share over its batches
        from ``cfg["warm_batches"]`` on (``device_busy_pct``)."""
        if not on_card:
            return run(), "not measured"
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = run()
        prof.export_chrome_trace(trace_path)
        return out, device_busy_pct(trace_path, batch_bytes, cfg["warm_batches"])

    # The cache's hits, counted here: every get, and every fill it calls.
    counts, lock = {"get": 0, "fill": 0}, threading.Lock()
    real_get = local_disk_cache.LocalDiskCache.get

    def counting_get(self, key, fill_cache_func):
        def fill():
            with lock:
                counts["fill"] += 1
            return fill_cache_func()
        with lock:
            counts["get"] += 1
        return real_get(self, key, fill)

    fa.reset_launch_counts()
    rows, group = cfg["rows"], cfg["rows_per_row_group"]
    groups = rows // group
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reader_")
    try:
        # (a) The MNIST-shaped store, its idx index, a selector over it.
        url = f"file://{tmp}/mnist"
        t0 = time.perf_counter()
        mnist.generate_mnist_dataset(url, rows, seed=cfg["seed"], rows_per_row_group=group)
        write_s = time.perf_counter() - t0
        store_mb = sum(os.path.getsize(os.path.join(tmp, "mnist", f))
                       for f in os.listdir(os.path.join(tmp, "mnist"))) / 1e6
        t0 = time.perf_counter()
        build_rowgroup_index(url, [SingleFieldIndexer("idx_index", "idx")])
        index_s = time.perf_counter() - t0
        step = groups // cfg["selected_groups"]
        picked = [g * step for g in range(cfg["selected_groups"])]
        values = [g * group + 17 for g in picked]
        with make_reader(url, schema_fields=["idx"],
                         rowgroup_selector=SingleIndexSelector("idx_index", values)) as reader:
            selected = sorted(int(r.idx) for r in reader)
        want = sorted(i for g in picked for i in range(g * group, (g + 1) * group))
        if selected != want:
            fail(f"reader (a): the selector delivered {len(selected)} rows, expected the "
                 f"{len(want)} rows of row groups {picked}")

        # (b) The MNIST example's path on the card, two epochs on one cache.
        split = in_pseudorandom_split(cfg["split"], 0, "idx")
        kept = sorted(i for i in range(rows) if split.do_include({"idx": i}))
        model = mnist.init_mnist_mlp(seed=cfg["seed"], device=device)
        before = [p.detach().clone() for p in model.parameters()]
        opt = torch.optim.SGD(model.parameters(), lr=cfg["lr"])
        cache_dir = os.path.join(tmp, "cache")
        epochs = []

        def mnist_epoch(epoch):
            reader = make_reader(
                url, schema_fields=["idx", "image", "digit"], transform_spec=mnist.MNIST_TRANSFORM,
                predicate=split, shuffle_row_drop_partitions=cfg["drop_partitions"],
                cache_type="local-disk", cache_location=cache_dir,
                cache_size_limit=cfg["cache_bytes"], num_epochs=1, shard_seed=epoch)
            idx, images, losses = [], [], []
            t0 = time.perf_counter()
            with DataLoader(reader, batch_size=cfg["batch"],
                            shuffling_queue_capacity=cfg["shuffle"],
                            shuffling_queue_seed=epoch, device=device) as loader:
                for batch in loader:
                    opt.zero_grad()
                    loss = torch.nn.functional.cross_entropy(model(batch["image"]),
                                                             batch["digit"])
                    loss.backward()
                    opt.step()
                    losses.append(loss.item())
                    idx.append(batch["idx"])
                    images.append(batch["image"])
            sync()
            seconds = time.perf_counter() - t0
            return dict(idx=torch.cat(idx), images=torch.cat(images), losses=losses,
                        seconds=seconds, size=reader.cache.size_on_disk(),
                        devices={str(t.device) for t in images})

        local_disk_cache.LocalDiskCache.get = counting_get
        try:
            for epoch in range(cfg["epochs"]):
                counts.update(get=0, fill=0)
                out, busy = traced(lambda: mnist_epoch(epoch),
                                   os.path.join(tmp, f"mnist{epoch}.json"),
                                   cfg["batch"] * 28 * 28 * 4)
                out.update(busy=busy, gets=counts["get"], fills=counts["fill"])
                epochs.append(out)
        finally:
            local_disk_cache.LocalDiskCache.get = real_get
        items = groups * cfg["drop_partitions"]
        for epoch, out in enumerate(epochs):
            got = sorted(out["idx"].cpu().tolist())
            if got != kept:
                fail(f"reader (b): epoch {epoch} delivered {len(got)} rows, not each of the "
                     f"{len(kept)} rows the predicate keeps once")
            if out["gets"] != items:
                fail(f"reader (b): epoch {epoch} asked the cache for {out['gets']} work items, "
                     f"expected {items}")
            if not all(math.isfinite(x) for x in out["losses"]):
                fail(f"reader (b): losses not finite in epoch {epoch}")
            if out["devices"] != {str(torch.device(device, 0) if on_card else device)}:
                fail(f"reader (b): batches arrived on {out['devices']}")
        if epochs[0]["fills"] != items or epochs[1]["fills"] != 0:
            fail(f"reader (b): cache fills {epochs[0]['fills']} / {epochs[1]['fills']}, "
                 f"expected {items} / 0 (every second-epoch item a hit)")
        order = [torch.argsort(out["idx"]) for out in epochs]
        if not torch.equal(epochs[0]["images"][order[0]], epochs[1]["images"][order[1]]):
            fail("reader (b): the cached epoch's images differ from the first epoch's")
        if all(torch.equal(a, b.detach()) for a, b in zip(before, model.parameters())):
            fail("reader (b): the parameters did not move")
        epoch_lines = [
            f"epoch {e}: rows={len(out['idx'])} rows_per_s_traced={len(out['idx']) / out['seconds']:.1f} "
            f"cache_gets={out['gets']} cache_fills={out['fills']} "
            f"cache_size_on_disk={out['size']} device_busy_pct_traced={out['busy']} "
            f"loss_mean={np.mean(out['losses']):.4f}"
            for e, out in enumerate(epochs)]
        del epochs, model, opt

        # (c) The batch loaders on phase 7's Criteo-shaped store.
        tab_url = f"file://{tmp}/criteo"
        tab_rows = td.make_tabular_dataset(tab_url, rows=TABULAR["rows"], days=TABULAR["days"])
        per_day = tab_rows // TABULAR["days"]
        days = set(cfg["tab_days"])

        def batched_run(limit=None, on_batch=None):
            reader = make_batch_reader(
                tab_url, predicate=in_set(days, "day"),
                shuffle_row_drop_partitions=cfg["drop_partitions"], cache_type="local-disk",
                cache_location=os.path.join(tmp, "tab_cache"), cache_size_limit=cfg["cache_bytes"],
                num_epochs=1, shard_seed=cfg["seed"])
            seen, where, n = [], set(), 0
            t0 = time.perf_counter()
            with BatchedDataLoader(reader, batch_size=cfg["tab_batch"],
                                   shuffling_queue_capacity=cfg["tab_shuffle"],
                                   shuffling_queue_seed=cfg["seed"], device=device) as loader:
                for batch in loader:
                    seen.append(batch["sample_index"])
                    where.update(str(t.device) for t in batch.values())
                    if on_batch is not None:
                        on_batch(batch)
                    n += 1
                    if limit is not None and n == limit:
                        break
            sync()
            return torch.cat(seen).cpu(), where, n / (time.perf_counter() - t0), n

        sample, where, batched_per_s, batched_n = batched_run()
        want = sorted(i for d in sorted(days) for i in range(d * per_day, (d + 1) * per_day))
        if sorted(sample.tolist()) != want:
            fail(f"reader (c): the batch loader delivered {len(sample)} rows, not each row of "
                 f"days {sorted(days)} once")
        dev = str(torch.device(device, 0)) if on_card else device
        if where != {dev}:
            fail(f"reader (c): the shuffle buffer's batches lay on {where}, not {dev}")
        model = td.init_dlrm(seed=1, device=device)
        dlrm_step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
        dlrm_losses = []

        def train(batch):
            dense, sparse, labels = td.collate_dlrm(batch)
            mask = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
            dlrm_losses.append(float(dlrm_step(dense, sparse, labels, mask)))

        _, _, dlrm_batches_per_s, _ = batched_run(cfg["dlrm_steps"], train)
        if len(dlrm_losses) != cfg["dlrm_steps"] or not all(map(math.isfinite, dlrm_losses)):
            fail(f"reader (c): DLRM steps off the batch loader: losses {dlrm_losses}")

        fields = ["sample_index", "label"] + [f"dense_{i}" for i in range(td.NUM_DENSE)]
        t0 = time.perf_counter()
        inmem = InMemBatchedDataLoader(make_batch_reader(tab_url, schema_fields=fields),
                                       batch_size=cfg["tab_batch"],
                                       num_epochs=cfg["inmem_epochs"], device=device,
                                       random_seed=cfg["seed"])
        with inmem:
            batches = list(inmem)
        sync()
        inmem_s = time.perf_counter() - t0
        if sorted(inmem._cache) != sorted(fields) or not all(
                t.device.type == torch.device(device).type for t in inmem._cache.values()):
            fail("reader (c): the in-memory loader's cache is not on the device")
        per_epoch = -(-tab_rows // cfg["tab_batch"])
        for e in range(cfg["inmem_epochs"]):
            got = torch.cat([b["sample_index"] for b in batches[e * per_epoch:
                                                                (e + 1) * per_epoch]])
            if sorted(got.cpu().tolist()) != list(range(tab_rows)):
                fail(f"reader (c): in-memory epoch {e} is not a permutation of the "
                     f"{tab_rows} rows")
        inmem_per_s = len(batches) / inmem_s

        # (d) WeightedSamplingReader over the two splits, against a host replay.
        readers = [make_reader(url, schema_fields=["idx"], num_epochs=1, predicate=(
            in_pseudorandom_split(cfg["split"], s, "idx"))) for s in range(2)]
        with WeightedSamplingReader(readers, cfg["mix"], random_seed=cfg["seed"]) as mix:
            sources = [0 if split.do_include({"idx": int(next(mix).idx)}) else 1
                       for _ in range(cfg["mix_draws"])]
        rnd, cum = random.Random(cfg["seed"]), np.cumsum(cfg["mix"]) / sum(cfg["mix"])
        replay = [next(i for i, c in enumerate(cum) if d < c) if d < cum[-1] else len(cum) - 1
                  for d in (rnd.random() for _ in range(cfg["mix_draws"]))]
        if sources != replay:
            first = next(i for i, (a, b) in enumerate(zip(sources, replay)) if a != b)
            fail(f"reader (d): draw {first} came from source {sources[first]}, the replay of "
                 f"random.Random({cfg['seed']}) says {replay[first]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"reader: the path launched flash kernels: {launches}")
    print(f"reader (a): gpu={smi!r} mnist rows={rows} row_groups={groups} "
          f"store_mb={store_mb:.1f} write_s={write_s:.2f} index_build_s={index_s:.2f} | "
          f"SingleIndexSelector over {len(values)} idx values in row groups {picked}: "
          f"rows={len(selected)} (each of those row groups' rows once)", flush=True)
    print(f"reader (b): make_reader(predicate=in_pseudorandom_split({cfg['split']}, 0, 'idx'), "
          f"shuffle_row_drop_partitions={cfg['drop_partitions']}, local-disk cache "
          f"limit={cfg['cache_bytes']}) -> DataLoader(batch={cfg['batch']}, "
          f"shuffling_queue_capacity={cfg['shuffle']}) -> MLP 784-128-10 SGD lr={cfg['lr']}; "
          f"kept_rows={len(kept)} work_items={items} | " + " | ".join(epoch_lines)
          + "; second epoch: every item a cache hit, images bit-equal", flush=True)
    print(f"reader (c): criteo rows={tab_rows} | make_batch_reader(predicate=in_set("
          f"{sorted(days)}, 'day'), drop_partitions={cfg['drop_partitions']}, local-disk "
          f"cache) -> BatchedDataLoader(batch={cfg['tab_batch']}, "
          f"shuffling_queue_capacity={cfg['tab_shuffle']}): rows={len(sample)} "
          f"batches={batched_n} batches_per_s={batched_per_s:.1f} on {sorted(where)} | "
          f"dlrm steps={len(dlrm_losses)} batches_per_s={dlrm_batches_per_s:.1f} "
          f"loss_first={dlrm_losses[0]:.5f} loss_last={dlrm_losses[-1]:.5f} | "
          f"InMemBatchedDataLoader({len(fields)} columns, epochs={cfg['inmem_epochs']}): "
          f"batches={len(batches)} batches_per_s={inmem_per_s:.1f} (fill included) "
          f"seconds={inmem_s:.2f}", flush=True)
    print(f"reader (d): WeightedSamplingReader({cfg['mix']}, random_seed={cfg['seed']}) over "
          f"the two splits: {cfg['mix_draws']} draws, source 0 share="
          f"{sources.count(0) / len(sources):.4f}, equal to the host replay; "
          f"flash_launches={launches}", flush=True)


def tabular_dp_rank(rank, out_dir, url):
    """One rank of phase 7 (d) (a gloo group of ``DP`` ranks on card 0):
    runs its checks (raising on a miss), trains on its shard and writes
    its numbers to ``<out_dir>/rank<rank>.json`` and its final parameters
    to ``params<rank>.pt``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, params = tabular_dp_checks(rank, dist.group.WORLD, url)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.save({k: v.cpu() for k, v in params.items()},
               os.path.join(out_dir, f"params{rank}.pt"))


def tabular_dp_checks(rank, group, url):
    """The checks of one rank of phase 7 (d); returns its numbers and its
    final parameters."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.sharding import agree_max_batches, global_step_count

    cfg = TABULAR
    # f32 compute: the first step's all-reduced gradients against the mean
    # of both batches' one-process gradients (the batches are all-gathered).
    model = td.init_dlrm(compute_dtype=torch.float32, device="cuda")
    reader = make_batch_reader(url, num_epochs=cfg["epochs"], shuffle_row_groups=True,
                               shard_seed=7, cur_shard=rank, shard_count=DP)
    with make_torch_dataloader(reader, cfg["batch"], device="cuda", group=group) as loader:
        batch = next(iter(loader))
    dense, sparse, labels = td.collate_dlrm(batch)
    mask = torch.ones(labels.shape[0], dtype=torch.bool, device="cuda")
    _, grads = td.dlrm_gradients(model, dense, sparse, labels, mask, group)
    grads = {k: v.clone() for k, v in grads.items()}
    gathered = []
    for t in (dense, sparse, labels):
        parts = [torch.empty_like(t.cpu()) for _ in range(DP)]
        dist.all_gather(parts, t.cpu(), group=group)
        gathered.append(parts)
    mean = None
    for parts in zip(*gathered):
        _, g = td.dlrm_gradients(model, *(p.cuda() for p in parts), mask)
        g = {k: v.clone() for k, v in g.items()}
        mean = g if mean is None else {k: mean[k] + g[k] for k in g}
    grad_err = max((grads[k] - mean[k] / DP).abs().max().item()
                   / max((mean[k] / DP).abs().max().item(), 1e-30) for k in grads)
    if not grad_err <= DP_GRAD_REL:
        raise AssertionError(f"dp: all-reduced gradients differ from the one-process mean by "
                             f"{grad_err:.3e} of the largest (limit {DP_GRAD_REL:.0e})")
    agreed = agree_max_batches(100 + rank, group=group)
    if agreed != 100:
        raise AssertionError(f"dp: agree_max_batches gave {agreed}, expected min(100, 101)")
    want = global_step_count(url, cfg["batch"], DP, num_epochs=cfg["epochs"], shard_seed=7)
    t0 = time.perf_counter()
    result = td.train_dlrm(url, batch_size=cfg["batch"], epochs=cfg["epochs"], device="cuda",
                           group=group)
    seconds = time.perf_counter() - t0
    derived = result["diagnostics"]["max_batches"]
    if not (derived == want == result["steps"] > 0):
        raise AssertionError(f"dp rank {rank}: derived max_batches {derived}, "
                             f"global_step_count {want}, steps {result['steps']}")
    if not all(math.isfinite(x) for x in result["losses"]):
        raise AssertionError(f"dp rank {rank}: losses not finite: {result['losses']}")
    return {"grad_rel_err": grad_err, "agreed": agreed, "steps": result["steps"],
            "max_batches": derived, "global_step_count": want,
            "steps_per_s_warm": result["steps_per_s_warm"],
            "train_s": seconds}, result["model"].state_dict()


def tabular_phase(smi):
    """Phase 7 (see the module docstring); fails the run on any check."""
    import gc

    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.ops import sparse_sgd as ss
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.checkpoint import restore_training_state
    from petastorm_tpu_torch.torch_utils.mesh import run_ranks

    cfg = TABULAR
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tab_")
    try:
        url = f"file://{tmp}/criteo"
        t0 = time.perf_counter()
        rows = td.make_tabular_dataset(url, rows=cfg["rows"], days=cfg["days"])
        write_s = time.perf_counter() - t0
        arrow_schema = pq.read_schema(os.path.join(tmp, "criteo", "part-00000.parquet"))
        wide = sum(1 for f in arrow_schema if f.type.bit_width == 64)  # int64 columns
        per_group = rows // cfg["days"]

        # (a) Filters: a full scan and a one-day scan.
        scans = {}
        for name, filters in (("full", None), ("day3", [("day", "=", 3)])):
            t0 = time.perf_counter()
            with make_batch_reader(url, num_epochs=1, filters=filters) as reader:
                n = sum(len(b.sample_index) for b in reader)
                groups = reader.diagnostics["rowgroups_total"]
            scans[name] = (groups, n, n / (time.perf_counter() - t0))
        if scans["full"][:2] != (cfg["days"], rows) or scans["day3"][:2] != (1, per_group):
            fail(f"tabular (a): scans planned / read {scans}, expected "
                 f"({cfg['days']}, {rows}) and (1, {per_group})")

        # (b) The uninterrupted run, then an identical traced one.
        train = dict(batch_size=cfg["batch"], epochs=cfg["epochs"], device="cuda")
        fa.reset_launch_counts()
        ss.LAUNCHES["sparse_sgd"] = 0
        base = td.train_dlrm(url, collect_field="sample_index", **train)
        launches = dict(fa.LAUNCHES)
        sparse_launches = ss.LAUNCHES["sparse_sgd"]
        steps = cfg["epochs"] * rows // cfg["batch"]
        losses = base["losses"]
        first_q, last_q = quarter_means(losses)
        if base["steps"] != steps or not all(math.isfinite(x) for x in losses) \
                or not last_q < first_q:
            fail(f"tabular (b): {base['steps']} steps (expected {steps}), losses finite and "
                 f"falling: quarter means {first_q:.7f} -> {last_q:.7f}")
        if base["batch_devices"] != ["cuda:0"]:
            fail(f"tabular (b): batches arrived on {base['batch_devices']}, not cuda:0")
        counts = np.bincount(base["collected"], minlength=rows)
        dropped = cfg["epochs"] * rows - steps * cfg["batch"]
        if counts.max() > cfg["epochs"] or int((cfg["epochs"] - counts).sum()) != dropped:
            fail(f"tabular (b): rows trained {counts.min()}-{counts.max()} times, "
                 f"{int((cfg['epochs'] - counts).sum())} short (expected {dropped})")
        if any(launches.values()):
            fail(f"tabular (b): the path launched flash kernels: {launches}")
        if sparse_launches != base["steps"]:
            fail(f"tabular (b): {sparse_launches} sparse_sgd launches in {base['steps']} steps "
                 f"(expected one a step)")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = td.train_dlrm(url, **train)
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy = device_busy_pct(trace, cfg["batch"] * 8, td.WARM_FROM_STEP,
                               copies_per_batch=wide)
        diag = base["diagnostics"]

        # (c) Preempted at step 100, checkpointed, every object dropped,
        # restored, and finished by a fresh reader with resume_state.
        ckpt = os.path.join(tmp, "ckpt")
        first = td.train_dlrm(url, interrupt_after=cfg["interrupt_after"], checkpoint_dir=ckpt,
                              collect_field="sample_index", **train)
        saved = {k: v.detach().cpu().clone() for k, v in first["model"].state_dict().items()}
        first_rows, save_ms = first["collected"], first["checkpoint_save_ms"]
        first_steps = first["steps"]
        del first
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        arrays, state = restore_training_state(ckpt, map_location="cuda")
        restore_ms = 1e3 * (time.perf_counter() - t0)
        model = td.init_dlrm(seed=1, device="cuda")
        model.load_state_dict(arrays["model"])
        restored = model.state_dict()
        if sorted(restored) != sorted(saved) or not all(
                torch.equal(restored[k].cpu(), saved[k]) for k in saved):
            fail("tabular (c): restored parameters differ from the saved ones")
        second = td.train_dlrm(url, resume_state=state, model=model,
                               collect_field="sample_index", **train)
        if not all(math.isfinite(x) for x in second["losses"]):
            fail(f"tabular (c): resumed losses not finite: {second['losses']}")
        counts = np.bincount(np.concatenate([first_rows, second["collected"]]),
                             minlength=rows)
        deficit = int(np.maximum(cfg["epochs"] - counts, 0).sum())
        reread = int(np.maximum(counts - cfg["epochs"], 0).sum())
        if deficit >= cfg["batch"]:
            fail(f"tabular (c): {deficit} row-trainings short of {cfg['epochs']} per row "
                 f"over both runs (limit: under {cfg['batch']}, the dropped final batch)")

        # (d) Data parallel: DP spawned ranks on card 0.
        t0 = time.perf_counter()
        try:
            run_ranks(tabular_dp_rank, DP, tmp, args=(tmp, url), timeout_s=SP_TIMEOUT_S,
                      cuda_device=0)
        except RuntimeError as exc:
            fail(f"tabular (d): {exc}")
        dp_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        params = [torch.load(os.path.join(tmp, f"params{r}.pt")) for r in range(DP)]
        if not all(torch.equal(params[0][k], params[1][k]) for k in params[0]):
            fail("tabular (d): the ranks' final parameters differ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    full, day = scans["full"], scans["day3"]
    print(f"tabular (a): gpu={smi!r} rows={rows} row_groups={cfg['days']} "
          f"columns={len(arrow_schema)} write_s={write_s:.2f} | full scan: "
          f"rowgroups_total={full[0]} rows={full[1]} rows_per_s={full[2]:.1f} | "
          f"filters=[('day', '=', 3)]: rowgroups_total={day[0]} rows={day[1]} "
          f"rows_per_s={day[2]:.1f}", flush=True)
    print(f"tabular (b): dlrm 13 dense, 26 tables x 1024 x 16, hidden 64, bf16, "
          f"batch={cfg['batch']} epochs={cfg['epochs']} steps={base['steps']} "
          f"loss_first_quarter={first_q:.7f} loss_last_quarter={last_q:.7f} "
          f"steps_per_s_warm={base['steps_per_s_warm']:.2f} "
          f"rows_per_s_warm={base['rows_per_s_warm']:.1f} (steps {td.WARM_FROM_STEP}-end) "
          f"input_stall_pct={diag['input_stall_pct']} "
          f"h2d_bytes_per_row={diag['h2d_bytes'] / diag['rows']:.1f} "
          f"peak_mem_mib={base['peak_memory_bytes'] / 2**20:.1f} "
          f"traced_steps_per_s_warm={traced['steps_per_s_warm']:.2f} "
          f"device_busy_pct_traced={busy} dropped_rows={dropped} "
          f"flash_launches={launches} sparse_sgd_launches={sparse_launches}", flush=True)
    print(f"tabular (c): interrupted after {first_steps} steps, resumed for "
          f"{second['steps']} steps; restored parameters bit for bit; "
          f"reread_rows={reread} deficit_rows={deficit} "
          f"checkpoint_save_ms={save_ms:.2f} checkpoint_restore_ms={restore_ms:.2f}",
          flush=True)
    grad_errs = [f"{r['grad_rel_err']:.2e}" for r in ranks]
    print(f"tabular (d): ranks={DP} on cuda:0 (gloo, pinned-host staging; transport on one "
          f"card, not a claim): global_step_count={ranks[0]['global_step_count']} "
          f"steps={[r['steps'] for r in ranks]} "
          f"max_batches={[r['max_batches'] for r in ranks]} final parameters bit-equal; "
          f"f32 grad_rel_err={grad_errs} "
          f"agree_max_batches(100, 101)={ranks[0]['agreed']} "
          f"steps_per_s_warm={[round(r['steps_per_s_warm'], 2) for r in ranks]} "
          f"seconds={dp_s:.1f}", flush=True)
    return {"sparse_sgd_launches": sparse_launches}


def loader_phase(smi, image_images_per_s, cfg=IMAGE, device="cuda"):
    """Phase 9 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run on
    the card uses the defaults. ``image_images_per_s``: phase 4's, from this
    call, printed beside (b)'s."""
    import hashlib

    import numpy as np
    import torch

    from petastorm_tpu_torch.cache_impl import BatchCache, CacheConfig
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.service.seedtree import fold_in, permutation
    from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    lc, batch = LOADER, cfg["batch"]
    on_card = torch.device(device).type == "cuda"
    dev = str(torch.device(device, 0)) if on_card else device
    per_pass = -(-cfg["rows"] // batch)
    raw_bytes = batch * int(np.prod(cfg["image_shape"]))
    stage_kw = dict(normalize=(127.5, 127.5), crop=cfg["crop"], flip=True)
    fields = ["image", "label"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def digests(batches):
        return [hashlib.blake2b(t.cpu().numpy().tobytes(), digest_size=16).hexdigest()
                for t in batches]

    def equal(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=cfg["rows"],
                                  image_shape=cfg["image_shape"], num_classes=cfg["classes"],
                                  rows_per_row_group=cfg["rows_per_row_group"])

        # (a) bench.py's leg_cached_epochs on the card.
        def cached_epochs(seed):
            cache = BatchCache(mem_budget_bytes=lc["leg_cache_bytes"])
            reader = make_columnar_reader(url, reader_pool_type="thread", workers_count=1,
                                          num_epochs=1, shuffle_row_groups=False,
                                          schema_fields=fields)
            # Each pass's images are kept for the checks in a buffer made
            # beforehand: allocating on the card inside the timed pass
            # would time the allocator.
            passes = [torch.empty((per_pass, batch) + tuple(cfg["image_shape"]),
                                  dtype=torch.uint8, device=device) for _ in range(2)]
            counts, walls, marks, where = [], [], [], set()
            try:
                with make_torch_dataloader(reader, batch, batch_cache=cache, shuffle_seed=seed,
                                           device=device) as loader:
                    for images in passes:
                        n = 0
                        sync()
                        t0 = time.perf_counter()
                        for i, b in enumerate(loader):
                            if i == per_pass:
                                fail(f"loader (a) seed={seed}: more than {per_pass} batches "
                                     "in a pass")
                            images[i].copy_(b["image"])
                            where.add(str(b["image"].device))
                            n += len(b["image"])
                        sync()
                        walls.append(time.perf_counter() - t0)
                        counts.append(n)
                        stats = cache.stats()
                        marks.append((stats["hits"], stats["misses"]))
            finally:
                cache.cleanup()
            warm_hits = marks[1][0] - marks[0][0]
            warm_lookups = warm_hits + marks[1][1] - marks[0][1]
            return dict(passes=passes, counts=counts, where=where, stats=stats,
                        cold=counts[0] / walls[0], warm=counts[1] / walls[1],
                        hit_rate=warm_hits / warm_lookups if warm_lookups else None)

        leg = {seed: cached_epochs(seed) for seed in (None, lc["seed"])}
        canonical = digests(leg[None]["passes"][0])
        for seed, run in leg.items():
            if run["counts"] != [per_pass * batch] * 2 or run["where"] != {dev}:
                fail(f"loader (a) seed={seed}: passes delivered {run['counts']} rows on "
                     f"{run['where']}, expected {per_pass * batch} per pass on {dev}")
            if run["hit_rate"] != 1.0:
                fail(f"loader (a) seed={seed}: warm hit rate {run['hit_rate']}, expected 1.0")
        if not equal(leg[None]["passes"][1], leg[None]["passes"][0]):
            fail("loader (a): the unseeded warm pass is not the cold pass bit for bit")
        seeded = [digests(images) for images in leg[lc["seed"]]["passes"]]
        for k, got in enumerate(seeded):
            order = permutation(fold_in(lc["seed"], ("cache-epoch", k)), per_pass)
            if got != [canonical[i] for i in order]:
                fail(f"loader (a): seeded pass {k} is not the canonical batches in the order "
                     f"permutation(fold_in({lc['seed']}, ('cache-epoch', {k})), {per_pass})")
        if seeded[0] == seeded[1] or leg[lc["seed"]]["stats"]["permuted_serves"] != 2:
            fail(f"loader (a): the seeded passes' orders are equal or not counted as permuted "
                 f"({leg[lc['seed']]['stats']['permuted_serves']} permuted serves)")
        leg_lines = [
            f"seed={seed}: cold_images_per_sec={run['cold']:.1f} "
            f"warm_images_per_sec={run['warm']:.1f} warm_vs_cold={run['warm'] / run['cold']:.3f} "
            f"cache_hit_rate={run['hit_rate']} bytes_mem={run['stats']['bytes_mem']} "
            f"permuted_serves={run['stats']['permuted_serves']}"
            for seed, run in leg.items()]
        del leg, seeded

        # (b) The image path on a cached, producer-staged loader.
        in_shape = cfg["crop"] + (cfg["image_shape"][2],)

        def image_run(name):
            cache = CacheConfig("mem+disk", mem_mb=lc["mem_mb"],
                                cache_dir=os.path.join(tmp, f"{name}_cache")).build()
            reader = make_reader(url, schema_fields=fields, num_epochs=1,
                                 shuffle_row_groups=False)
            trace_path = os.path.join(tmp, f"{name}_loader_trace.json")
            model = ic.init_image_classifier(in_shape, cfg["classes"], hidden=cfg["hidden"],
                                             conv_features=cfg["conv_features"], device=device)
            step = ic.make_image_train_step(model, cfg["lr"])
            out = dict(losses=[], walls=[], diags=[], labels=[], where=set())
            try:
                with make_torch_dataloader(
                        reader, batch, last_batch="pad", device_stage=DeviceStage(**stage_kw),
                        batch_cache=cache, shuffle_seed=lc["seed"], stage_in_producer=True,
                        trace_path=trace_path, device=device) as loader:
                    for _ in range(lc["passes"]):
                        losses = []
                        labels = torch.zeros(cfg["classes"], dtype=torch.int64, device=device)
                        sync()
                        t0 = time.perf_counter()
                        for b in loader:
                            out["where"].update(str(t.device) for t in b.values())
                            images = b["image"]
                            mask = b.get(PAD_MASK_KEY)
                            if mask is None:
                                mask = torch.ones(images.shape[0], dtype=torch.bool,
                                                  device=images.device)
                            losses.append(step(images, b["label"], mask))
                            labels.index_add_(0, b["label"].long(), mask.long())
                        sync()
                        out["walls"].append(time.perf_counter() - t0)
                        out["losses"].append([float(x) for x in losses])
                        out["labels"].append(labels.cpu().tolist())
                        out["diags"].append(loader.diagnostics)
                out["stats"] = cache.stats()
            finally:
                cache.cleanup()
            with open(trace_path) as f:
                events = json.load(f)["traceEvents"]
            out["spans"] = {name: sum(1 for e in events if e["ph"] == "B" and e["name"] == name)
                            for name in ("loader.decode", "loader.wait", "loader.device_put",
                                         "loader.consumer")}
            return out

        fa.reset_launch_counts()
        run = image_run("b")
        launches = dict(fa.LAUNCHES)
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced = image_run("b_traced")
            trace = os.path.join(tmp, "b_profile.json")
            prof.export_chrome_trace(trace)
            busy = device_busy_pct(trace, raw_bytes, per_pass)
        else:
            traced, busy = run, "not measured"
        if any(launches.values()):
            fail(f"loader (b): the path launched flash kernels: {launches}")
        if run["where"] != {dev}:
            fail(f"loader (b): batches arrived on {run['where']}, not {dev}")
        first, last = np.mean(run["losses"][0]), np.mean(run["losses"][-1])
        if not all(math.isfinite(x) for p in run["losses"] for x in p) or not last < first:
            fail(f"loader (b): loss not finite and falling: pass means "
                 f"{[round(float(np.mean(p)), 4) for p in run['losses']]}")
        stats = run["stats"]
        if (stats["misses"], stats["hits"], stats["permuted_serves"]) != (
                1, lc["passes"] - 1, lc["passes"]):
            fail(f"loader (b): cache misses / hits / permuted serves {stats['misses']} / "
                 f"{stats['hits']} / {stats['permuted_serves']}, expected 1 / "
                 f"{lc['passes'] - 1} / {lc['passes']}")
        if any(labels != run["labels"][0] for labels in run["labels"]) or \
                sum(run["labels"][0]) != cfg["rows"]:
            fail(f"loader (b): the passes trained on different labels: {run['labels']}")
        if run["spans"]["loader.device_put"] != per_pass or \
                run["spans"]["loader.wait"] != per_pass:
            fail(f"loader (b): the trace of the last pass holds {run['spans']}, expected "
                 f"{per_pass} loader.device_put and loader.wait spans")
        warm = run["diags"][1:]
        walls = run["walls"]
        stall_pct = 100.0 * sum(d["stall_s"] for d in warm) / sum(d["wall_s"] for d in warm)
        consumer_ms = 1e3 * sum(d["consumer_s"] for d in warm) / sum(d["batches"] for d in warm)
        cold_ips = cfg["rows"] / walls[0]
        warm_ips = (lc["passes"] - 1) * cfg["rows"] / sum(walls[1:])
        traced_warm_ips = (lc["passes"] - 1) * cfg["rows"] / sum(traced["walls"][1:])
        decode_ms = [1e3 * sum(d["producer_decode_s"] for d in diags)
                     / sum(d["batches"] for d in diags) for diags in (run["diags"][:1], warm)]
        del traced

        # (c) Producer-side staging is invisible in the data.
        def staged(stage_in_producer, prefetch):
            reader = make_reader(url, schema_fields=fields, num_epochs=1, workers_count=1,
                                 shuffle_row_groups=False)
            with make_torch_dataloader(
                    reader, batch, last_batch="pad", device_stage=DeviceStage(**stage_kw),
                    max_batches=lc["stage_batches"], stage_in_producer=stage_in_producer,
                    device_prefetch=prefetch, device=device) as loader:
                return [(b["image"], b["label"]) for b in loader]

        runs = {(sip, p): staged(sip, p) for sip in (False, True) for p in lc["stage_prefetch"]}
        ref = runs[(False, lc["stage_prefetch"][0])]
        if len(ref) != lc["stage_batches"]:
            fail(f"loader (c): {len(ref)} batches, expected {lc['stage_batches']}")
        for key, got in runs.items():
            if not all(equal(g, w) for g, w in zip(got, ref)) or len(got) != len(ref):
                fail(f"loader (c): stage_in_producer={key[0]} device_prefetch={key[1]} gave "
                     "other card tensors than consumer-side staging at device_prefetch 1")
        del runs, ref

        # (d) Resume a permuted pass from the disk tier.
        def resume_loader(cache, cache_resume=None):
            # One decode worker: the uninterrupted run fills its own entry,
            # which must hold the canonical order the interrupted run's does.
            reader = make_reader(url, schema_fields=fields, num_epochs=1, workers_count=1,
                                 shuffle_row_groups=False)
            return make_torch_dataloader(
                reader, batch, last_batch="pad",
                device_stage=DeviceStage(normalize=stage_kw["normalize"]), batch_cache=cache,
                shuffle_seed=lc["seed"], stage_in_producer=True, cache_resume=cache_resume,
                device=device)

        def take(batches):
            return [(b["image"], b["label"]) for b in batches]

        full_cache = BatchCache(mem_budget_bytes=lc["mem_mb"] << 20)
        with resume_loader(full_cache) as loader:
            for _ in range(lc["resume_passes"]):
                for _ in loader:
                    pass
            want = take(loader)
        full_cache.cleanup()
        cache_dir = os.path.join(tmp, "d_cache")
        cache = CacheConfig("mem+disk", mem_mb=lc["mem_mb"], cache_dir=cache_dir).build()
        with resume_loader(cache) as loader:
            for _ in range(lc["resume_passes"]):
                for _ in loader:
                    pass
            iterator = iter(loader)
            head = take(next(iterator) for _ in range(lc["resume_after"]))
            state = loader.state_dict()
            iterator.close()
        cache.cleanup()
        del loader, cache
        want_state = {"version": 1, "kind": "cache_replay", "cache_epoch": lc["resume_passes"],
                      "batches_yielded": lc["resume_after"], "shuffle_seed": lc["seed"]}
        if state != want_state:
            fail(f"loader (d): state_dict() {state}, expected {want_state}")
        cache = CacheConfig("mem+disk", mem_mb=lc["mem_mb"], cache_dir=cache_dir).build()
        t0 = time.perf_counter()
        with resume_loader(cache, state) as loader:
            rest = take(loader)
        sync()
        resume_s = time.perf_counter() - t0
        resumed = cache.stats()
        cache.cleanup()
        if not all(equal(g, w) for g, w in zip(head + rest, want)) or \
                len(head) + len(rest) != len(want):
            fail(f"loader (d): the interrupted + resumed pass 3 ({len(head)} + {len(rest)} "
                 f"batches) is not the uninterrupted pass's {len(want)} bit for bit")
        if resumed["hits_disk"] < 1 or resumed["misses"] != 0:
            fail(f"loader (d): the resumed cache counted {resumed['hits_disk']} disk hits and "
                 f"{resumed['misses']} misses, expected >= 1 and 0 (no fill)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"loader (a): gpu={smi!r} bench.py leg_cached_epochs: make_columnar_reader(workers=1) "
          f"-> make_torch_dataloader({batch}, batch_cache=BatchCache(1 GiB)), 2 passes of "
          f"{per_pass} batches | " + " | ".join(leg_lines)
          + "; unseeded replay bit-equal, seeded passes in the seed-tree order", flush=True)
    print(f"loader (b): gpu={smi!r} make_reader -> make_torch_dataloader(pad, DeviceStage("
          f"crop={cfg['crop']}, flip), CacheConfig('mem+disk', {lc['mem_mb']} MiB), "
          f"shuffle_seed={lc['seed']}, stage_in_producer, trace_path) -> CNN conv="
          f"{cfg['conv_features']} hidden={cfg['hidden']}, {lc['passes']} passes: "
          f"pass1_images_per_s={cold_ips:.1f} warm_images_per_s={warm_ips:.1f} "
          f"(passes 2-{lc['passes']}) phase4_images_per_s={image_images_per_s:.1f} "
          f"input_stall_pct_warm={stall_pct:.2f} "
          f"dispatch_overlap_pct_last={warm[-1]['dispatch_overlap_pct']} "
          f"consumer_ms_per_step_warm={consumer_ms:.3f} "
          f"producer_decode_ms_per_batch_pass1={decode_ms[0]:.3f} "
          f"producer_decode_ms_per_batch_warm={decode_ms[1]:.3f} "
          f"traced_warm_images_per_s={traced_warm_ips:.1f} device_busy_pct_traced_warm={busy} "
          f"loss_pass1={first:.4f} loss_pass{lc['passes']}={last:.4f} "
          f"last_pass_spans={run['spans']} cache_stats={json.dumps(stats)} "
          f"flash_launches={launches}", flush=True)
    print(f"loader (c): the first {lc['stage_batches']} batches at stage_in_producer "
          f"False/True x device_prefetch {list(lc['stage_prefetch'])}: bit-equal card "
          "tensors (the stage's draws follow the production ordinal)", flush=True)
    print(f"loader (d): stopped after {lc['resume_after']} batches of pass "
          f"{lc['resume_passes'] + 1}: {json.dumps(state)}; a fresh BatchCache on the same "
          f"directory and a fresh reader resumed the pass in {resume_s:.2f} s: "
          f"{len(rest)} batches bit-equal to the uninterrupted run's; hits_disk="
          f"{resumed['hits_disk']} misses={resumed['misses']}", flush=True)


def etl_phase(smi, cfg=ETL, device="cuda"):
    """Phase 10 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run on
    the card uses the defaults."""
    import hashlib

    import numpy as np
    import pyarrow as pa
    import torch

    from petastorm_tpu_torch.etl.metadata import (
        get_schema_from_dataset_url,
        load_row_groups,
        materialize_dataset,
        write_rows,
    )
    from petastorm_tpu_torch.fs_utils import FilesystemResolver
    from petastorm_tpu_torch.models import imagenet
    from petastorm_tpu_torch.models.long_context_lm import corpus_rows, corpus_schema, train_lm
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
    from petastorm_tpu_torch.schema.unischema import encode_row
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_SEGMENT_KEY,
        count_packed_batches,
        make_packed_torch_dataloader,
        unpack,
    )

    on_card = torch.device(device).type == "cuda"
    dev = str(torch.device(device, 0)) if on_card else device
    rows_n, batch, schema = cfg["rows"], cfg["batch"], imagenet.ImagenetSchema
    image_bytes = int(np.prod(imagenet.IMAGE_SHAPE))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def digest(array):
        return hashlib.blake2b(np.ascontiguousarray(array).tobytes(), digest_size=16).hexdigest()

    def files(directory):
        return {name: digest(np.fromfile(os.path.join(directory, name), np.uint8))
                for name in sorted(os.listdir(directory))}

    def store_bytes(directory):
        return sum(os.path.getsize(os.path.join(directory, name))
                   for name in os.listdir(directory) if not name.startswith("_"))

    def cli(module, *args):
        out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                             text=True, timeout=300, cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO))
        if out.returncode != 0:
            fail(f"etl: python -m {module} exited {out.returncode}:\n{out.stderr}")
        return out.stdout.splitlines()

    def read_images(reader, passes):
        """Each pass through ``make_torch_dataloader`` (re-iterated after
        ``reader.reset()``): its noun ids, card images, wall s, the reader's
        diagnostics halfway, and the loader's H2D bytes."""
        out = []
        with make_torch_dataloader(reader, batch, last_batch="keep", device=device) as loader:
            for p in range(passes):
                if p:
                    reader.reset()
                ids, images, mid = [], [], None
                sync()
                t0 = time.perf_counter()
                for b in loader:
                    ids.extend(str(n) for n in b["noun_id"])
                    images.append(b["image"])
                    if len(images) == max(2, -(-rows_n // batch) // 2):
                        mid = reader.diagnostics
                sync()
                out.append(dict(ids=ids, images=images, seconds=time.perf_counter() - t0,
                                mid=mid, h2d=loader.diagnostics["h2d_bytes"],
                                where={str(t.device) for t in images}))
        return out

    def check_images(label, run, want_ids):
        if run["where"] != {dev}:
            fail(f"etl {label}: batches arrived on {run['where']}, not {dev}")
        if sorted(run["ids"]) != sorted(want_ids):
            fail(f"etl {label}: read {len(run['ids'])} rows, not the {len(want_ids)} written")
        got = [digest(row) for t in run["images"] for row in t.cpu().numpy()]
        bad = [n for n, d in zip(run["ids"], got) if d != digests[n]]
        if bad:
            fail(f"etl {label}: {len(bad)} images differ from the rows written, e.g. {bad[:3]}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_etl_")
    try:
        # (a) The ImageNet example's store, written twice by the port.
        rows = list(imagenet.synthetic_rows(rows_n))
        digests = {r["noun_id"]: digest(r["image"]) for r in rows}
        fa.reset_launch_counts()
        writes = {}
        for workers in cfg["workers"]:
            url = f"file://{tmp}/imagenet_w{workers}"
            t0 = time.perf_counter()
            with materialize_dataset(None, url, schema, row_group_size_mb=cfg["row_group_mb"]):
                written = write_rows(url, schema, rows, row_group_size_mb=cfg["row_group_mb"],
                                     encode_workers=workers)
            seconds = time.perf_counter() - t0
            path = os.path.join(tmp, f"imagenet_w{workers}")
            writes[workers] = dict(url=url, path=path, seconds=seconds, files=files(path),
                                   written=len(written), mb=store_bytes(path) / 1e6)
        serial, parallel = (writes[w] for w in cfg["workers"])
        if serial["files"] != parallel["files"]:
            fail(f"etl (a): the stores written at {cfg['workers']} encode workers differ: "
                 f"{serial['files']} vs {parallel['files']}")
        # The probe rule, computed here: the bytes per row of the first 64
        # encoded rows, in a table of the storage schema.
        probe = [encode_row(schema, r) for r in rows[:64]]
        bytes_per_row = max(1, pa.Table.from_pylist(probe, schema=schema.as_arrow_schema())
                            .nbytes // len(probe))
        group_rows = max(1, (cfg["row_group_mb"] << 20) // bytes_per_row)
        fs = FilesystemResolver(parallel["url"]).filesystem()
        groups = [p.num_rows for p in load_row_groups(fs, parallel["path"])]
        want_groups = [min(group_rows, rows_n - i) for i in range(0, rows_n, group_rows)]
        if groups != want_groups:
            fail(f"etl (a): row groups of {groups} rows, the probe rule gives {want_groups}")
        listing = cli("petastorm_tpu_torch.etl.metadata_util", parallel["url"], "--schema")
        listed = [line.split(":")[0].strip() for line in listing if "dtype=" in line]
        if listed != ["noun_id", "text", "image"]:
            fail(f"etl (a): metadata_util --schema listed {listed}:\n" + "\n".join(listing))
        reader = make_reader(parallel["url"], reader_pool_type="thread")
        read = read_images(reader, passes=2)
        for p, run in enumerate(read):
            check_images(f"(a) pass {p + 1}", run, list(digests))
        first = read[0]
        if first["h2d"] != (rows_n * image_bytes if on_card else 0):
            fail(f"etl (a): {first['h2d']} H2D bytes for {rows_n} rows, expected "
                 f"{image_bytes} a row (the string labels stay on the host)")
        mid = first["mid"]
        if not (mid and mid["items_ventilated"] > 0 and mid["items_processed"] > 0):
            fail(f"etl (a): mid-pass reader diagnostics {mid}: the live counters did not move")
        end = reader.diagnostics
        if end["epochs_completed"] != 2 or end["items_processed"] != 2 * len(groups):
            fail(f"etl (a): diagnostics after two passes {end}")
        for run in read:
            del run["images"]
        launches_a = dict(fa.LAUNCHES)
        write_lines = [f"encode_workers={w}: {rows_n / writes[w]['seconds']:.1f} rows/s "
                       f"{writes[w]['mb'] / writes[w]['seconds']:.1f} MB/s (store "
                       f"{writes[w]['mb']:.1f} MB, {writes[w]['seconds']:.3f} s)"
                       for w in cfg["workers"]]

        # (b) The LM corpus through the reference write forms, its metadata
        # regenerated by inference, then packed and trained on the card.
        lm_url, lm_path = f"file://{tmp}/corpus", os.path.join(tmp, "corpus")
        docs = list(corpus_rows(cfg["lm_docs"]))
        lm_schema = corpus_schema(encoded=False)
        t0 = time.perf_counter()
        with materialize_dataset(None, lm_url, lm_schema):
            lm_files = write_rows(lm_url, lm_schema, docs, compression="zstd",
                                  rows_per_file=cfg["lm_rows_per_file"],
                                  encode_workers=cfg["lm_encode_workers"],
                                  basename_template="lm-{:03d}.parquet")
        lm_write_s = time.perf_counter() - t0
        want_files = [os.path.join(lm_path, f"lm-{i:03d}.parquet")
                      for i in range(-(-cfg["lm_docs"] // cfg["lm_rows_per_file"]))]
        if lm_files != want_files:
            fail(f"etl (b): wrote {lm_files}, expected {want_files}")
        os.remove(os.path.join(lm_path, "_common_metadata"))
        regen = cli("petastorm_tpu_torch.etl.petastorm_generate_metadata", lm_url)
        inferred = get_schema_from_dataset_url(lm_url)
        shapes = {n: (np.dtype(f.numpy_dtype).name, f.shape, f.codec)
                  for n, f in inferred.fields.items()}
        if inferred._name != "inferred_schema" or shapes != {
                "tokens": ("int32", (None,), None), "length": ("int32", (), None)}:
            fail(f"etl (b): regenerated schema {inferred!r}")
        lm_groups = [p.num_rows for p in load_row_groups(fs, lm_path)]
        if lm_groups != [cfg["lm_rows_per_file"]] * len(want_files):
            fail(f"etl (b): regenerated row groups {lm_groups}")
        reader_kw = dict(num_epochs=1, shuffle_row_groups=True, shard_seed=0, workers_count=1)
        pack_kw = dict(slot_len=128, slots=4, sequence_fields=["tokens"], length_field="length")
        counted = count_packed_batches(make_columnar_reader(lm_url, **reader_kw), **pack_kw)
        reader = make_columnar_reader(lm_url, **reader_kw)
        packed = []
        with make_packed_torch_dataloader(reader, device=device, **pack_kw) as loader:
            for b in loader:
                if b[PACK_SEGMENT_KEY].device != torch.device(dev):
                    fail(f"etl (b): a packed batch arrived on {b[PACK_SEGMENT_KEY].device}")
                packed.append({k: t.cpu() for k, t in b.items()})
        if len(packed) != counted:
            fail(f"etl (b): count_packed_batches gave {counted}, the loader delivered "
                 f"{len(packed)} batches")
        got_docs = sorted(tuple(d.tolist()) for b in packed for d in unpack(b, "tokens"))
        want_docs = sorted(tuple(d["tokens"][:d["length"]].tolist()) for d in docs)
        if got_docs != want_docs:
            fail(f"etl (b): unpack gave {len(got_docs)} documents, not the "
                 f"{len(want_docs)} written")
        fa.reset_launch_counts()
        trained = train_lm(lm_url, steps=cfg["lm_steps"], device=device)
        launches_b = dict(fa.LAUNCHES)
        losses = trained["losses"]
        if len(losses) != cfg["lm_steps"] or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"etl (b): losses not {cfg['lm_steps']} finite and falling: {losses}")
        if on_card and min(launches_b.values()) < 1:
            fail(f"etl (b): a kernel was not launched by train_lm: {launches_b}")

        # (c) copy_dataset of (a)'s store: two fields, two files.
        copy_url, copy_path = f"file://{tmp}/copy", os.path.join(tmp, "copy")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        cli("petastorm_tpu_torch.tools.copy_dataset", parallel["url"], copy_url,
            "--field-regex", "noun_id", "image", "--partitions-count", str(cfg["copy_files"]))
        copy_s = time.perf_counter() - t0
        copied = sorted(n for n in os.listdir(copy_path) if not n.startswith("_"))
        if len(copied) != cfg["copy_files"]:
            fail(f"etl (c): copy_dataset wrote {copied}, expected {cfg['copy_files']} files")
        if list(get_schema_from_dataset_url(copy_url).fields) != ["noun_id", "image"]:
            fail("etl (c): the copy's schema is not (noun_id, image)")
        (copy_read,) = read_images(make_reader(copy_url, reader_pool_type="thread"), passes=1)
        check_images("(c)", copy_read, list(digests))
        launches_c = dict(fa.LAUNCHES)
        if any(launches_a.values()) or any(launches_c.values()):
            fail(f"etl: a flash kernel ran outside the LM: (a) {launches_a} (c) {launches_c}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"etl (a): gpu={smi!r} the ImageNet example's store, {rows_n} rows of "
          f"{imagenet.IMAGE_SHAPE} png, materialize_dataset(None, ..., row_group_size_mb="
          f"{cfg['row_group_mb']}) + write_rows(row_group_size_mb={cfg['row_group_mb']}): "
          + "; ".join(write_lines)
          + f"; stores byte-equal ({len(parallel['files'])} files); probe {bytes_per_row} "
          f"bytes/row -> {group_rows} rows/group, row groups {groups}; metadata_util --schema "
          f"lists {listed}; make_reader(thread) -> make_torch_dataloader({batch}) on {dev}: "
          f"read_rows_per_s={rows_n / first['seconds']:.1f} (pass 1), images bit-equal, "
          f"h2d_bytes_per_row={first['h2d'] // rows_n}; reset() -> pass 2: the same "
          f"{rows_n} noun ids, images bit-equal; mid-pass diagnostics {json.dumps(mid)}; "
          f"flash_launches={launches_a}", flush=True)
    print(f"etl (b): generate_corpus's {cfg['lm_docs']} documents (plain int32 columns) "
          f"through write_rows(compression='zstd', rows_per_file={cfg['lm_rows_per_file']}, "
          f"encode_workers={cfg['lm_encode_workers']}, basename_template='lm-{{:03d}}.parquet') "
          f"in {lm_write_s:.3f} s -> {len(lm_files)} files; _common_metadata deleted and "
          f"regenerated by inference ({regen[-1]!r}); count_packed_batches={counted} = "
          f"batches delivered to {dev}; unpack gave the {len(want_docs)} documents; "
          f"train_lm {len(losses)} steps losses={[round(x, 4) for x in losses]} "
          f"steps_per_s_warm={trained['steps_per_s_warm']:.2f} flash_launches={launches_b}",
          flush=True)
    print(f"etl (c): copy_dataset --field-regex noun_id image --partitions-count "
          f"{cfg['copy_files']} in {copy_s:.2f} s -> {copied}; read back on {dev}: "
          f"{len(copy_read['ids'])} rows, images bit-equal, read_rows_per_s="
          f"{rows_n / copy_read['seconds']:.1f}; flash_launches={launches_c}", flush=True)


def pool_children():
    """pids of live ``python ... -m petastorm_tpu_torch.workers_pool.
    exec_in_new_process`` processes: the process pool's workers."""
    from petastorm_tpu_torch.workers_pool.exec_in_new_process import CHILD_MODULE

    pids = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if len(argv) > 2 and b"python" in argv[0] and argv[2] == CHILD_MODULE.encode():
            pids.add(int(entry))
    return pids


def compute_apps():
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists. (The chip
    host's sandbox lists one entry, pid 1, however many processes hold a
    context: printed, not relied on.)"""
    out = sh(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"])
    return [int(line) for line in out.split() if line.strip().isdigit()]


def card_handles(pid):
    """What of the card process ``pid`` holds: its open ``/dev/nvidia*``
    files and whether it maps ``libcuda``. A process with a CUDA context
    has both; None when the process is gone."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
        with open(f"/proc/{pid}/maps") as f:
            libcuda = "libcuda" in f.read()
    except OSError:
        return None
    devices = set()
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            devices.add(target)
    return sorted(devices), libcuda


def _injected_fault(values):
    raise ValueError("injected decode fault")


def pool_phase(smi, image, cfg=POOL, device="cuda"):
    """Phase 11 (see the module docstring); fails the run on any check.
    ``image``: phase 4's figures from this call. ``cfg`` and ``device``
    exist for a small dry run on the host; the run on the card uses the
    defaults."""
    import collections
    import hashlib
    import json as _json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.models.long_context_lm import generate_corpus, train_lm
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.predicates import in_lambda
    from petastorm_tpu_torch.reader.reader import (
        make_batch_reader,
        make_columnar_reader,
        make_reader,
    )
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.telemetry import start_metrics_server
    from petastorm_tpu_torch.telemetry.flight import RECORDER
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.packing import (
        PACK_SEGMENT_KEY,
        make_packed_torch_dataloader,
    )
    from petastorm_tpu_torch.workers_pool import WorkerException

    on_card = torch.device(device).type == "cuda"
    img = cfg["image"]
    stage_kw = dict(normalize=(127.5, 127.5), crop=img["crop"], flip=True)
    fa.reset_launch_counts()
    leftover = pool_children()
    if leftover:
        fail(f"pool: pool workers alive before the phase: {sorted(leftover)}")

    def no_orphans(where):
        left = pool_children()
        if left:
            fail(f"pool {where}: exec_in_new_process children left after join(): "
                 f"{sorted(left)}")

    def digest(image_bytes):
        return hashlib.blake2b(image_bytes, digest_size=16).hexdigest()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    try:
        # (a) The host's ceiling: make_reader + batch_iterator, no device.
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=img["rows"],
                                  image_shape=img["image_shape"], num_classes=img["classes"],
                                  rows_per_row_group=img["rows_per_row_group"])
        written = collections.Counter(
            (int(r["label"]), digest(r["image"].tobytes()))
            for r in ic.image_rows(img["rows"], img["image_shape"], img["classes"]))
        want = collections.Counter({k: n * img["epochs"] for k, n in written.items()})
        warm = -(-img["rows"] // img["batch"])
        ceiling, sequences = {}, {}
        for pool in ("thread", "process"):
            for workers in cfg["workers"]:
                seen, order, n, hash_s, t0 = collections.Counter(), [], 0, 0.0, None
                with make_reader(url, schema_fields=["image", "label"],
                                 num_epochs=img["epochs"], shuffle_row_groups=True,
                                 shard_seed=0, reader_pool_type=pool,
                                 workers_count=workers) as reader:
                    for i, batch in enumerate(batch_iterator(reader, img["batch"])):
                        if i == warm:
                            t0 = time.perf_counter()
                        if t0 is not None:
                            n += len(batch["image"])
                        h0 = time.perf_counter()
                        keys = [(int(label), digest(im.tobytes()))
                                for label, im in zip(batch["label"], batch["image"])]
                        hash_s += time.perf_counter() - h0 if t0 is not None else 0.0
                        seen.update(keys)
                        order.extend(keys)
                    elapsed = time.perf_counter() - t0 - hash_s
                no_orphans(f"(a) {pool} x{workers}")
                if seen != want:
                    fail(f"pool (a): {pool} pool at {workers} workers delivered another "
                         f"multiset of (label, image digest) than the {img['rows']} rows "
                         f"written, {img['epochs']} times")
                ceiling[(pool, workers)] = n / elapsed
                sequences[(pool, workers)] = order
        if sequences[("process", 1)] != sequences[("thread", 1)]:
            fail("pool (a): at one worker the process pool's row order is not the thread "
                 "pool's")
        del sequences

        # (b) + (e): phase 4's training run on a process pool, scraped over HTTP.
        server = start_metrics_server(0, snapshot_interval_s=0.5)
        host, port = server.address

        def scrape(path):
            with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=10) as resp:
                return resp.read().decode()

        def family(snapshot, name):
            return snapshot[name]["series"]

        try:
            before = _json.loads(scrape("/metrics.json"))
            parent = os.getpid()
            apps, workers_seen, stop = [], set(), threading.Event()
            handles = {"parent": [], "workers": {}}

            def watch():
                while not stop.wait(0.25):
                    kids = pool_children()
                    workers_seen.update(kids)
                    if on_card and kids:
                        apps.append(compute_apps())
                        handles["parent"].append(card_handles(parent))
                        for kid in kids:
                            held = card_handles(kid)
                            if held is not None:
                                handles["workers"].setdefault(kid, []).append(held)

            watcher = threading.Thread(target=watch, daemon=True, name="pool-phase-watch")
            watcher.start()
            train = dict(batch_size=img["batch"], epochs=img["epochs"],
                         num_classes=img["classes"], conv_features=img["conv_features"],
                         hidden=img["hidden"], learning_rate=img["lr"],
                         reader_pool_type="process", device=device)
            try:
                result = ic.train_image_classifier(url, device_stage=DeviceStage(**stage_kw),
                                                   **train)
            finally:
                stop.set()
                watcher.join()
            no_orphans("(b)")
            after = _json.loads(scrape("/metrics.json"))
            text = scrape("/metrics")
            health = scrape("/healthz")
            loader = result["loader"]
            diag, reader_diag = result["diagnostics"], loader.reader.diagnostics
            quantiles = loader.stage_quantiles()
        finally:
            server.stop()
        if not workers_seen:
            fail("pool (b): no pool worker process was seen during the run")
        listed = sorted({tuple(sample) for sample in apps})
        worker_samples = sum(len(v) for v in handles["workers"].values())
        if on_card:
            # The parent's handles show the probe sees a context; the
            # workers' must show none, in every sample.
            if not handles["parent"] or not all(
                    h is not None and h[0] and h[1] for h in handles["parent"]):
                fail(f"pool (b): the training process shows no card handle in /proc: "
                     f"{handles['parent'][:3]}")
            held = {pid: samples for pid, samples in handles["workers"].items()
                    if any(devices or libcuda for devices, libcuda in samples)}
            if not worker_samples or held:
                fail(f"pool (b): pool workers hold the card: {held} ({worker_samples} samples)")
            if any(pid in workers_seen for sample in apps for pid in sample):
                fail(f"pool (b): nvidia-smi lists a pool worker: {listed}")
        losses, warm_steps = result["losses"], result["warmup_steps"]
        if result["batch_devices"] != [str(torch.device(device, 0)) if on_card else device]:
            fail(f"pool (b): batches arrived on {result['batch_devices']}")
        if not all(math.isfinite(x) for x in losses) or not (
                np.mean(losses[-warm_steps:]) < np.mean(losses[:warm_steps])):
            fail(f"pool (b): image loss not finite and falling: {losses}")

        # (e) The scrape against the reader's and the loader's own counts.
        def total(snapshot, name, **labels):
            return sum(s.get("value", 0.0) for s in family(snapshot, name)
                       if all(s["labels"].get(k) == v for k, v in labels.items()))

        processed = (total(after, "petastorm_pool_items_processed_total")
                     - total(before, "petastorm_pool_items_processed_total"))
        lid = loader.loader_id
        batches = total(after, "petastorm_loader_batches_total", loader=lid)
        rows = total(after, "petastorm_loader_rows_total", loader=lid)
        groups = -(-img["rows"] // img["rows_per_row_group"])
        if processed != reader_diag["items_processed"] or processed != groups * img["epochs"]:
            fail(f"pool (e): the scrape's items processed {processed} disagree with the "
                 f"reader's {reader_diag['items_processed']} ({groups * img['epochs']} items)")
        if (batches, rows) != (len(losses), diag["rows"]) or diag["batches"] != len(losses) \
                or rows != img["rows"] * img["epochs"]:
            fail(f"pool (e): the scrape's loader batches / rows {batches} / {rows} disagree "
                 f"with the {len(losses)} steps and {diag['rows']} rows yielded")
        if "# TYPE petastorm_pool_items_processed_total counter" not in text \
                or health != "ok\n":
            fail("pool (e): /metrics or /healthz did not answer as expected")
        noted = len(RECORDER.snapshot())
        faulty = make_reader(url, schema_fields=["image", "label"], reader_pool_type="process",
                             workers_count=2, predicate=in_lambda(["label"], _injected_fault))
        try:
            with faulty:
                for _ in faulty:
                    pass
            fail("pool (e): the injected worker fault did not reach the consumer")
        except WorkerException as exc:
            caught = exc
        no_orphans("(e)")
        if "injected decode fault" not in caught.formatted_traceback \
                or "Traceback" not in caught.formatted_traceback:
            fail(f"pool (e): the worker exception lost its traceback: {caught!r}")
        events = [e for e in RECORDER.snapshot()[noted:]
                  if e["event"] == "pool.worker_exception" and e["pool"] == "process"]
        if not events or "injected" not in events[-1]["error"]:
            fail("pool (e): the worker exception left no flight-recorder event")
        del faulty, caught

        # (b) The traced busy share of a second, identical run.
        from torch.profiler import ProfilerActivity, profile
        busy = "not measured"
        if on_card:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced = ic.train_image_classifier(
                    url, device_stage=DeviceStage(**stage_kw), **train)
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            busy = device_busy_pct(trace, img["batch"] * int(np.prod(img["image_shape"])),
                                   traced["warmup_steps"])
            del traced
            no_orphans("(b) traced")

        # (c) The LM fed by a one-worker process pool against the thread pool's.
        outside = dict(fa.LAUNCHES)
        lm_url = f"file://{tmp}/corpus"
        generate_corpus(lm_url)
        pack_kw = dict(slot_len=128, slots=4, sequence_fields=["tokens"], length_field="length",
                       max_batches=cfg["lm_steps"], device=device)
        packed = {}
        for pool in ("thread", "process"):
            reader = make_columnar_reader(lm_url, num_epochs=8, shuffle_row_groups=True,
                                          shard_seed=0, reader_pool_type=pool, workers_count=1)
            with make_packed_torch_dataloader(reader, **pack_kw) as loader_:
                packed[pool] = [{k: t.clone() for k, t in b.items()} for b in loader_]
        no_orphans("(c) batches")
        if len(packed["process"]) != cfg["lm_steps"] or any(
                b1.keys() != b2.keys() or not all(torch.equal(b1[k], b2[k]) for k in b1)
                for b1, b2 in zip(packed["process"], packed["thread"])):
            fail("pool (c): the process pool's packed batches are not the thread pool's bit "
                 "for bit")
        if on_card and packed["process"][0][PACK_SEGMENT_KEY].device.type != "cuda":
            fail("pool (c): packed batches did not arrive on the card")
        del packed
        lm = {}
        for pool in ("thread", "process"):
            fa.reset_launch_counts()
            lm[pool] = train_lm(lm_url, steps=cfg["lm_steps"], device=device,
                                reader_pool_type=pool, workers_count=1)
            lm[pool]["launches"] = dict(fa.LAUNCHES)
        no_orphans("(c) train")
        lm_losses = lm["process"]["losses"]
        if lm_losses != lm["thread"]["losses"]:
            fail(f"pool (c): losses on the process pool {lm_losses} differ from the thread "
                 f"pool's {lm['thread']['losses']}")
        if not all(math.isfinite(x) for x in lm_losses) or not lm_losses[-1] < lm_losses[0]:
            fail(f"pool (c): losses not finite and falling: {lm_losses}")
        launches = lm["process"]["launches"]
        if on_card and launches != cfg["lm_launches"]:
            fail(f"pool (c): flash launches {launches}, expected {cfg['lm_launches']}")

        # (d) The batch reader over the Arrow serializer, phase 7's store.
        fa.reset_launch_counts()
        tab_url = f"file://{tmp}/criteo"
        tab_rows = td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        tab_kw = dict(num_epochs=1, shuffle_row_groups=True, shard_seed=0, workers_count=1)

        def read_tables(pool, zmq_copy_buffers=True, limit=None, resume_state=None):
            """``(tables, state, (start_s, rows/s after the first table))``."""
            out, state = [], None
            t0 = time.perf_counter()
            with make_batch_reader(tab_url, reader_pool_type=pool, resume_state=resume_state,
                                   zmq_copy_buffers=zmq_copy_buffers, **tab_kw) as reader:
                for b in reader:
                    out.append(b._asdict())
                    if len(out) == 1:
                        t1 = time.perf_counter()
                    if limit is not None and len(out) == limit:
                        state = reader.state_dict()
                        break
                t2 = time.perf_counter()
            rest = sum(len(b["sample_index"]) for b in out[1:])
            return out, state, (t1 - t0, rest / (t2 - t1))

        def same_tables(a, b):
            return len(a) == len(b) and all(
                x.keys() == y.keys() and all(x[k].dtype == y[k].dtype
                                             and np.array_equal(x[k], y[k]) for k in x)
                for x, y in zip(a, b))

        reference, _, thread_rate = read_tables("thread")
        tab_rates = {"thread": thread_rate}
        for zc in (True, False):
            tables, _, tab_rates[f"process zmq_copy_buffers={zc}"] = read_tables("process", zc)
            if not same_tables(tables, reference):
                fail(f"pool (d): the process pool's tables (zmq_copy_buffers={zc}) are not "
                     "the thread pool's")
        if sum(len(b["sample_index"]) for b in reference) != tab_rows:
            fail(f"pool (d): one pass read {sum(len(b['sample_index']) for b in reference)} "
                 f"rows of {tab_rows}")
        resumed = {}
        for pool in ("thread", "process"):
            first, state, _ = read_tables(pool, limit=cfg["tab_resume_after"])
            rest, _, _ = read_tables(pool, resume_state=state)
            resumed[pool] = (state, sorted(int(i) for b in rest for i in b["sample_index"]),
                             sorted(int(i) for b in first for i in b["sample_index"]))
        no_orphans("(d)")
        if resumed["process"] != resumed["thread"]:
            fail("pool (d): the process pool's resume state or re-read rows differ from the "
                 "thread pool's")
        state, rest_ids, first_ids = resumed["process"]
        if sorted(rest_ids + first_ids) != list(range(tab_rows)):
            fail("pool (d): the resumed pass and the first together are not the epoch's rows")
        if any(outside.values()) or any(fa.LAUNCHES.values()):
            fail(f"pool: a flash kernel ran outside (c): before it {outside}, after it "
                 f"{dict(fa.LAUNCHES)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cores = os.cpu_count()
    print(f"pool (a): gpu={smi!r} host cores={cores}; make_reader(image, label) + "
          f"batch_iterator({img['batch']}) on phase 4's store ({img['rows']} png rows "
          f"{img['image_shape']}, groups of {img['rows_per_row_group']}, {img['epochs']} "
          f"epochs, timed after the first), no device, rows/s: "
          + "; ".join(f"{pool} x{w}={ceiling[(pool, w)]:.1f}"
                      for pool in ("thread", "process") for w in cfg["workers"])
          + "; every run the written rows' (label, image digest) multiset, the one-worker "
          "orders equal", flush=True)
    print(f"pool (b): train_image_classifier(reader_pool_type='process', 10 workers) at "
          f"phase 4's width on {device}: images_per_s={result['images_per_s']:.1f} "
          f"consumer_ms_per_step={1e3 * diag['consumer_s'] / diag['batches']:.3f} "
          f"input_stall_pct={diag['input_stall_pct']} device_busy_pct_traced={busy}; "
          f"phase 4 (thread pool, this call): images_per_s={image['images_per_s']:.1f} "
          f"consumer_ms_per_step={image['consumer_ms_per_step']:.3f} "
          f"input_stall_pct={image['input_stall_pct']} "
          f"device_busy_pct_traced={image['device_busy_pct_traced']}; "
          f"loss {np.mean(losses[:warm_steps]):.4f} -> {np.mean(losses[-warm_steps:]):.4f}; "
          f"{len(workers_seen)} workers seen; while they ran ({len(apps)} samples) nvidia-smi "
          f"listed compute apps {listed} (the sandbox's pid for the training process "
          f"{parent}), no worker pid; /proc: the training process held "
          f"{handles['parent'][-1][0] if handles['parent'] else None} and libcuda, the "
          f"workers no /dev/nvidia* file and no libcuda in {worker_samples} samples; none "
          "left after join()", flush=True)
    print(f"pool (c): train_lm {cfg['lm_steps']} steps on make_columnar_reader(process, 1 "
          f"worker): packed batches bit-equal to the thread pool's, losses equal "
          f"{[round(x, 4) for x in lm_losses]}, flash_launches={launches}, "
          f"steps_per_s_warm process={lm['process']['steps_per_s_warm']} "
          f"thread={lm['thread']['steps_per_s_warm']}", flush=True)
    print(f"pool (d): make_batch_reader on phase 7's store ({tab_rows} rows, "
          f"{cfg['tab_days']} row groups, 1 worker), rows/s after the first table: "
          + "; ".join(f"{k}={rate:.1f} (first table after {start:.3f} s)"
                      for k, (start, rate) in tab_rates.items())
          + f"; tables equal to the thread pool's; resume after {cfg['tab_resume_after']} "
          f"tables re-reads {len(rest_ids)} rows, as the thread pool's", flush=True)
    print(f"pool (e): metrics server {host}:{port}: items_processed "
          f"{int(processed)} = reader's, loader batches / rows {int(batches)} / {int(rows)} = "
          f"yielded; stage_quantiles={_json.dumps(quantiles)}; injected worker fault -> "
          f"WorkerException with its traceback, flight event {events[-1]['event']!r}",
          flush=True)
    return ceiling


def _parallel_layouts(family):
    """``(name, axis sizes, axis names, batch_axis)`` of a family's two
    layouts on 4 ranks."""
    axis = {"moe": "ep", "pipeline": "pp"}[family]
    return [(f"{axis}4", (4,), (axis,), None),
            (f"dp2_{axis}2", (2, 2), ("data", axis), "data")]


def _tab_batches(url, cfg, device, shard=None):
    """The first ``cfg["steps"]`` batches of phase 7's store as the
    trainers read it (one worker, the seeded row-group order): the MoE and
    pipeline features (the 13 dense columns), labels, and the DLRM's
    columns, on ``device``."""
    import torch

    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.reader.reader import make_batch_reader
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    kw = dict(cur_shard=shard, shard_count=2) if shard is not None else {}
    reader = make_batch_reader(url, num_epochs=2, shuffle_row_groups=True, shard_seed=7,
                               workers_count=1, **kw)
    out = []
    with make_torch_dataloader(reader, cfg["batch"], max_batches=cfg["steps"],
                               device=device) as loader:
        for batch in loader:
            dense, sparse, labels = td.collate_dlrm(batch)
            out.append((dense, sparse, labels.long()))
    if len(out) != cfg["steps"]:
        raise AssertionError(f"read {len(out)} batches, expected {cfg['steps']}")
    return out


def _image_batches(url, cfg, device, shard):
    """The first ``cfg["image_steps"]`` batches of data shard ``shard`` of
    phase 4's store through phase 4's stage (one worker: the seeded order)."""
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

    image = cfg["image"]
    stage = DeviceStage(normalize=(127.5, 127.5), crop=image["crop"], flip=True)
    reader = make_reader(url, schema_fields=["image", "label"], num_epochs=1, workers_count=1,
                         shuffle_row_groups=True, shard_seed=0, cur_shard=shard, shard_count=2)
    with make_torch_dataloader(reader, image["batch"], max_batches=cfg["image_steps"],
                               device=device, device_stage=stage) as loader:
        out = [(b["image"], b["label"].long()) for b in loader]
    if len(out) != cfg["image_steps"]:
        raise AssertionError(f"read {len(out)} image batches, expected {cfg['image_steps']}")
    return out


def _moe_loss(top_k, shards, aux_weight):
    from petastorm_tpu_torch.models import moe
    from petastorm_tpu_torch.models.image_classifier import masked_cross_entropy

    def loss(params, x, labels, mask):
        logits, aux = moe.reference_forward(params, x, num_shards=shards, top_k=top_k)
        return masked_cross_entropy(logits, labels, mask) + aux_weight * aux

    return loss


def _pipeline_loss(params, x, labels, mask):
    from petastorm_tpu_torch.models import pipeline as pl
    from petastorm_tpu_torch.models.image_classifier import masked_cross_entropy

    return masked_cross_entropy(pl.reference_forward(params, x), labels, mask)


def parallel_reference(tmp, tab_url, img_url, cfg, device):
    """The parent's half of phase 12: the batches every rank must see, and
    each family trained in one process on ``device`` on them; saved to
    ``<tmp>/reference.pt`` (on the host) for the ranks to hold themselves
    against. Returns the flash launches it counted."""
    import torch

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import moe
    from petastorm_tpu_torch.models import pipeline as pl
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    tab = _tab_batches(tab_url, cfg, device)
    ref = {"tab": [tuple(t.cpu() for t in b) for b in tab]}
    mask = torch.ones(cfg["batch"], dtype=torch.bool, device=device)
    for name, _, _, _ in _parallel_layouts("moe"):
        full = moe.init_moe_params(0, 13, device=device, **cfg["moe"])
        for top_k in (1, 2):
            params, losses = full, []
            for dense, _, labels in tab:
                params, loss = ic.sgd_step(_moe_loss(top_k, cfg["world"], cfg["aux_weight"]),
                                            params, cfg["lr"], dense, labels, mask)
                losses.append(float(loss))
            ref[("moe", name, top_k)] = (losses, {k: v.cpu() for k, v in params.items()})
    for name, sizes, names, _ in _parallel_layouts("pipeline"):
        params = pl.init_pipeline_params(0, 13, num_stages=sizes[names.index("pp")],
                                         device=device, **cfg["pipeline"])
        losses = []
        for dense, _, labels in tab:
            params, loss = ic.sgd_step(_pipeline_loss, params, cfg["lr"], dense, labels, mask)
            losses.append(float(loss))
        ref[("pipeline", name)] = (losses, {k: v.cpu() for k, v in params.items()})
    del tab
    # (c), (d): each step's two data shards together, through the unsharded model.
    image = cfg["image"]
    shards = [_image_batches(img_url, cfg, device, d) for d in range(2)]
    ref["image"] = [[tuple(t.cpu() for t in b) for b in s] for s in shards]
    model = ic.init_image_classifier(image["crop"] + (3,), image["classes"],
                                     hidden=image["hidden"],
                                     conv_features=image["conv_features"], device=device)
    step = ic.make_image_train_step(model, image["lr"])
    losses = []
    for (x0, y0), (x1, y1) in zip(*shards):
        x, y = torch.cat([x0, x1]), torch.cat([y0, y1])
        losses.append(float(step(x, y, torch.ones(len(y), dtype=torch.bool, device=device))))
    ref["image_run"] = (losses, {k: v.cpu() for k, v in model.state_dict().items()})
    del model, shards
    shards = [_tab_batches(tab_url, cfg, device, d) for d in range(2)]
    ref["dlrm"] = [[tuple(t.cpu() for t in b) for b in s] for s in shards]
    model = td.init_dlrm(device=device, **cfg["dlrm"])
    step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
    losses = []
    for a, b in zip(*shards):
        dense, sparse, labels = (torch.cat([u, v]) for u, v in zip(a, b))
        losses.append(float(step(dense, sparse, labels, torch.ones_like(labels, dtype=torch.bool))))
    ref["dlrm_run"] = (losses, {k: v.cpu() for k, v in model.state_dict().items()})
    del model, shards
    torch.save(ref, os.path.join(tmp, "reference.pt"))
    return dict(fa.LAUNCHES)


def _parallel_close(got, want, start, tol, what, misses):
    """The largest abs error and update error of ``got`` (a rank's blocks
    after training) against ``want`` (the one-process run's blocks),
    ``start`` holding the blocks before training; each tensor outside
    ``tol`` (rtol, atol, update; see ``PARALLEL_TOL``) adds a line to
    ``misses``."""
    import torch

    err = update = 0.0
    for key, value in got.items():
        w, s = want[key].to(value.device), start[key].to(value.device)
        diff = (value - w).double().norm().item()
        moved = (w - s).double().norm().item()
        rel = diff / moved if moved else (0.0 if diff == 0 else math.inf)
        abs_err = (value - w).abs().max().item()
        if not torch.allclose(value, w, rtol=tol[0], atol=tol[1]) or rel > tol[2]:
            misses.append(f"{what}: {key} differs from the one-process run's block by "
                          f"{abs_err:.3e}, {rel:.3e} of its update (rtol {tol[0]}, atol "
                          f"{tol[1]}, update {tol[2]})")
        err, update = max(err, abs_err), max(update, rel)
    return err, update


def _parallel_losses(got, want, rtol, what, misses):
    """The largest relative error of the losses ``got`` against ``want``;
    a loss not finite or outside ``rtol`` adds a line to ``misses``."""
    if not all(math.isfinite(x) for x in got):
        misses.append(f"{what}: losses not finite: {got}")
        return math.inf
    errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    if max(errs) > rtol:
        step = errs.index(max(errs))
        misses.append(f"{what}: step {step}'s loss {got[step]} differs from the one-process "
                      f"run's {want[step]} by {max(errs):.3e} relative (rtol {rtol})")
    return max(errs)


def _train(device, step, batches):
    """The losses of ``step(batch)`` over ``batches`` and the steps/s after
    the first step (its first-use set-up and gloo connections left out)."""
    import torch

    losses = [float(step(batches[0]))]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    losses += [float(step(batch)) for batch in batches[1:]]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return losses, (len(batches) - 1) / (time.perf_counter() - t0)


def _case_record(losses, loss_err, rate, errs, params, full, split):
    """A phase 12 case's numbers on one rank: ``params`` its block, ``full``
    the whole, ``split`` the names of the tensors the layout splits."""
    from petastorm_tpu_torch.torch_utils.mesh import shard_bytes

    return dict(steps_per_s=rate, loss_first=losses[0], loss_last=losses[-1], loss_err=loss_err,
                param_err=errs[0], update_err=errs[1],
                bytes=shard_bytes(params), full_bytes=shard_bytes(full),
                split=shard_bytes({k: params[k] for k in split}),
                split_full=shard_bytes({k: full[k] for k in split}))


def _functional(step, params, mask):
    """``(one step on a (features, ids, labels) batch, the params dict it
    updates)`` for a functional ``step(params, x, labels, mask)``."""
    state = dict(params)

    def one(batch):
        new, loss = step(state, batch[0], batch[2], mask)
        state.update(new)
        return loss

    return one, state


def parallel_rank(rank, tmp, tab_url, img_url, cfg, device):
    """One rank of phase 12: every case on its real path (its own readers
    and loaders, its block of each family), each held against the parent's
    one-process run; its numbers to ``<tmp>/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import moe
    from petastorm_tpu_torch.models import pipeline as pl
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.torch_utils.mesh import Mesh, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    ref = torch.load(os.path.join(tmp, "reference.pt"), weights_only=False)
    fa.reset_launch_counts()
    out, devices, misses = {}, set(), []

    def same_batches(got, want, what):
        for g, w in zip(got, want):
            devices.update(str(t.device) for t in g)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(g, w)):
                raise AssertionError(f"{what}: rank {rank}'s batches differ from the parent's")

    tab = _tab_batches(tab_url, cfg, device)
    same_batches(tab, ref["tab"], "(a)/(b)")
    mask = torch.ones(cfg["batch"], dtype=torch.bool, device=device)
    tol = PARALLEL_TOL
    for name, sizes, names, batch_axis in _parallel_layouts("moe"):
        mesh = Mesh(sizes, names)
        specs = moe.moe_param_partition_specs()
        full = moe.init_moe_params(0, 13, device="cpu", **cfg["moe"])
        for top_k in (1, 2):
            start = shard_params(full, specs, mesh)
            one, params = _functional(
                moe.make_moe_train_step(cfg["lr"], cfg["aux_weight"], mesh=mesh,
                                        batch_axis=batch_axis, top_k=top_k),
                {k: v.to(device) for k, v in start.items()}, mask)
            losses, rate = _train(device, one, tab)
            want_losses, want = ref[("moe", name, top_k)]
            what = f"(a) moe {name} top-{top_k} rank {rank}"
            loss_err = _parallel_losses(losses, want_losses, tol["loss"], what, misses)
            errs = _parallel_close(params, shard_params(want, specs, mesh), start,
                                   tol["top2" if top_k == 2 else "params"], what, misses)
            out[f"moe {name} top{top_k}"] = _case_record(losses, loss_err, rate, errs, params,
                                                          full, ("w1", "w2"))
    for name, sizes, names, batch_axis in _parallel_layouts("pipeline"):
        mesh = Mesh(sizes, names)
        specs = pl.pipeline_param_partition_specs()
        full = pl.init_pipeline_params(0, 13, num_stages=mesh.shape["pp"], device="cpu",
                                       **cfg["pipeline"])
        schedule_losses = {}
        for schedule in ("gpipe", "1f1b"):
            start = shard_params(full, specs, mesh)
            one, params = _functional(
                pl.make_pipeline_train_step(cfg["lr"], mesh=mesh,
                                            num_microbatches=cfg["microbatches"],
                                            batch_axis=batch_axis, schedule=schedule),
                {k: v.to(device) for k, v in start.items()}, mask)
            losses, rate = _train(device, one, tab)
            want_losses, want = ref[("pipeline", name)]
            what = f"(b) pipeline {name} {schedule} rank {rank}"
            loss_err = _parallel_losses(losses, want_losses, tol["loss"], what, misses)
            errs = _parallel_close(params, shard_params(want, specs, mesh), start, tol["params"],
                                   what, misses)
            schedule_losses[schedule] = losses
            out[f"pipeline {name} {schedule}"] = _case_record(losses, loss_err, rate, errs,
                                                               params, full, ("w1", "w2"))
        _parallel_losses(schedule_losses["1f1b"], schedule_losses["gpipe"], 1e-5,
                         f"(b) pipeline {name} 1f1b against gpipe rank {rank}", misses)
    del tab

    mesh = Mesh((2, 2), ("data", "model"))
    d, data = mesh.axis_index("data"), mesh.group("data")
    image = cfg["image"]
    batches = _image_batches(img_url, cfg, device, d)
    same_batches(batches, ref["image"][d], "(c)")
    full = ic.init_image_classifier(image["crop"] + (3,), image["classes"],
                                    hidden=image["hidden"],
                                    conv_features=image["conv_features"], device="cpu")
    model = ic.shard_image_classifier(full, mesh).to(device)
    step = ic.make_image_train_step(model, image["lr"], group=data)
    ones = torch.ones(image["batch"], dtype=torch.bool, device=device)
    losses, rate = _train(device, lambda b: step(b[0], b[1], ones), batches)
    want_losses, want = ref["image_run"]
    what = f"(c) image rank {rank}"
    loss_err = _parallel_losses(losses, want_losses, tol["bf16_loss"], what, misses)
    state, specs = model.state_dict(), ic.param_partition_specs()
    errs = _parallel_close(state, shard_params(want, specs, mesh),
                           shard_params(full.state_dict(), specs, mesh), tol["bf16"], what,
                           misses)
    out["image"] = _case_record(losses, loss_err, rate, errs, state, full.state_dict(),
                                ("dense1_kernel", "dense1_bias", "dense2_kernel"))
    del model, full, state, batches

    batches = _tab_batches(tab_url, cfg, device, d)
    same_batches(batches, ref["dlrm"][d], "(d)")
    full = td.init_dlrm(device="cpu", **cfg["dlrm"])
    model = td.shard_dlrm(full, mesh).to(device)
    step = td.make_dlrm_train_step(model, td.LEARNING_RATE, group=data)
    ones = torch.ones(cfg["batch"], dtype=torch.bool, device=device)
    losses, rate = _train(device, lambda b: step(*b, ones), batches)
    # Each data rank's loss is its rows' mean: the batch's is their mean.
    pair = torch.tensor(losses, dtype=torch.float64)
    dist.all_reduce(pair, group=data)
    want_losses, want = ref["dlrm_run"]
    what = f"(d) dlrm rank {rank}"
    loss_err = _parallel_losses((pair / 2).tolist(), want_losses, tol["bf16_loss"], what,
                                misses)
    state, specs = model.state_dict(), td.dlrm_partition_specs()
    errs = _parallel_close(state, shard_params(want, specs, mesh),
                           shard_params(full.state_dict(), specs, mesh), tol["bf16"], what,
                           misses)
    out["dlrm"] = _case_record(losses, loss_err, rate, errs, state, full.state_dict(),
                               ("embeddings",))
    if devices != {str(device) if device.type == "cpu" else f"cuda:{device.index or 0}"}:
        raise AssertionError(f"rank {rank}: batches arrived on {sorted(devices)}")
    out["launches"] = dict(fa.LAUNCHES)
    if any(out["launches"].values()):
        raise AssertionError(f"rank {rank}: flash kernels launched: {out['launches']}")
    if misses:  # every parity miss of every case, after all of them ran
        raise AssertionError("\n".join(misses))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def parallel_phase(smi, cfg=PARALLEL, device="cuda"):
    """Phase 12 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run
    on the card uses the defaults."""
    import multiprocessing

    import torch

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.torch_utils.mesh import run_ranks

    device = torch.device(device)
    image = cfg["image"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        tab_url, img_url = f"file://{tmp}/criteo", f"file://{tmp}/images"
        td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        ic.generate_image_dataset(img_url, CompressedImageCodec(IMAGE_CODEC), rows=image["rows"],
                                  image_shape=image["image_shape"],
                                  num_classes=image["classes"],
                                  rows_per_row_group=image["rows_per_row_group"])
        t0 = time.perf_counter()
        parent_launches = parallel_reference(tmp, tab_url, img_url, cfg, device)
        reference_s = time.perf_counter() - t0
        if any(parent_launches.values()):
            fail(f"parallel: the one-process runs launched flash kernels: {parent_launches}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            run_ranks(parallel_rank, cfg["world"], tmp,
                      args=(tmp, tab_url, img_url, cfg, str(device)), timeout_s=SP_TIMEOUT_S,
                      cuda_device=0 if device.type == "cuda" else None)
        except RuntimeError as exc:
            fail(f"parallel: {exc}")
        ranks_s = time.perf_counter() - t0
        left = multiprocessing.active_children()
        if left:
            fail(f"parallel: processes left after the ranks joined: {left}")
        ranks = []
        for r in range(cfg["world"]):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def case(key):
        rows = [r[key] for r in ranks]
        for r, row in enumerate(rows):
            n = round(row["split_full"] / row["split"])
            if row["split"] * n != row["split_full"] or \
                    row["bytes"] != row["full_bytes"] - row["split_full"] + row["split"]:
                fail(f"parallel: rank {r} of {key} holds {row['bytes']} bytes, not its 1/n "
                     f"of the split tensors: {row}")
        first = rows[0]
        return (f"steps_per_s_rank={[round(r['steps_per_s'], 2) for r in rows]} "
                f"loss={first['loss_first']:.5f}->{first['loss_last']:.5f} "
                f"max_loss_rel_err={max(r['loss_err'] for r in rows):.2e} "
                f"max_param_err={max(r['param_err'] for r in rows):.2e} "
                f"max_update_rel_err={max(r['update_err'] for r in rows):.2e} "
                f"split_bytes_rank={first['split']} of {first['split_full']} "
                f"(1/{round(first['split_full'] / first['split'])}) "
                f"bytes_rank={first['bytes']} of {first['full_bytes']}")

    launches = [r["launches"] for r in ranks]
    common = (f"ranks={cfg['world']} on {device} (gloo, pinned-host staging; transport on one "
              f"card, not a claim)")
    print(f"parallel (a): moe d_model {cfg['moe']['d_model']} d_hidden "
          f"{cfg['moe']['d_hidden']} {cfg['moe']['num_experts']} experts, batch {cfg['batch']}, "
          f"{cfg['steps']} steps, {common}; "
          + "; ".join(f"{name} top-{k}: {case(f'moe {name} top{k}')}"
                      for name, _, _, _ in _parallel_layouts("moe") for k in (1, 2)), flush=True)
    print(f"parallel (b): pipeline d_model {cfg['pipeline']['d_model']} d_hidden "
          f"{cfg['pipeline']['d_hidden']}, {cfg['microbatches']} microbatches, "
          f"{cfg['steps']} steps; gpipe and 1f1b losses within 1e-5; "
          + "; ".join(f"{name} {s}: {case(f'pipeline {name} {s}')}"
                      for name, _, _, _ in _parallel_layouts("pipeline")
                      for s in ("gpipe", "1f1b")), flush=True)
    print(f"parallel (c): image conv {image['conv_features']} hidden {image['hidden']} crop "
          f"{image['crop']} bf16, (data 2, model 2), batch {image['batch']} a data rank, "
          f"{cfg['image_steps']} steps: {case('image')}", flush=True)
    print(f"parallel (d): dlrm 26 tables x {cfg['dlrm']['vocab_size']} x "
          f"{cfg['dlrm']['embed_dim']} bf16, (data 2, model 2), batch {cfg['batch']} a data "
          f"rank, {cfg['steps']} steps: {case('dlrm')}; flash launches ranks={launches} "
          f"one-process={parent_launches}; reference_s={reference_s:.1f} "
          f"ranks_s={ranks_s:.1f}; no rank left", flush=True)


class _LogRecords(logging.Handler):
    """Keeps every record it is handed (phase 13: the autotuner's failed
    rounds)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _autotune_checks(loader, before, name, failed):
    """Phase 13's checks on one autotuned pass, while its reader still
    runs: every decision within its knob's bounds, the knobs in force the
    last decision of each, the pool's live threads its ``workers_count``
    once the trail is quiet, the registry's decision and round deltas the
    controller's counts, no failed round."""
    from petastorm_tpu_torch.telemetry.metrics import AUTOTUNE_DECISIONS, AUTOTUNE_ROUNDS

    controller = loader.autotune
    if controller is None or controller.running:
        fail(f"autotune: the controller of the {name} pass was not built or still runs")
    report = controller.report()
    if len(report["trail"]) >= controller._max_trail:
        fail("autotune: the trail reached its bound, so its counts are not the whole pass")
    last, counted = {}, collections.Counter()
    for entry in report["trail"]:
        for d in entry["decisions"]:
            desc = controller.graph.knobs[d["knob"]].descriptor()
            if not desc["lo"] <= d["to"] <= desc["hi"]:
                fail(f"autotune: decision {d} leaves its bounds {desc}")
            last[d["knob"]] = d["to"]
            counted[(d["knob"], d["direction"])] += 1
    for knob, value in last.items():
        if report["knobs"][knob] != value:
            fail(f"autotune: {knob} is {report['knobs'][knob]} in force, but its last "
                 f"decision set {value}")
    pool = loader.reader._workers_pool
    deadline = time.monotonic() + AUTOTUNE["quiet_s"]
    while pool.live_workers != pool.workers_count and time.monotonic() < deadline:
        time.sleep(0.01)
    if pool.live_workers != pool.workers_count or pool.workers_count != \
            report["knobs"]["workers_count"]:
        fail(f"autotune: {pool.live_workers} live worker threads, workers_count "
             f"{pool.workers_count}, knob {report['knobs']['workers_count']}")
    decisions = {key: child.value - before[0].get(key, 0.0)
                 for key, child in AUTOTUNE_DECISIONS.children().items()}
    rounds = sum(child.value for child in AUTOTUNE_ROUNDS.children().values()) - before[1]
    if {k: v for k, v in decisions.items() if v} != {k: float(v) for k, v in counted.items()} \
            or rounds != report["rounds"]:
        fail(f"autotune: registry deltas {decisions} / {rounds} rounds differ from the "
             f"trail's {dict(counted)} / {report['rounds']}")
    if failed:
        fail(f"autotune: {len(failed)} rounds failed: {failed[0].getMessage()}")
    return report


def _registry_before():
    from petastorm_tpu_torch.telemetry.metrics import AUTOTUNE_DECISIONS, AUTOTUNE_ROUNDS

    return ({key: child.value for key, child in AUTOTUNE_DECISIONS.children().items()},
            sum(child.value for child in AUTOTUNE_ROUNDS.children().values()))


@contextlib.contextmanager
def _window_classes():
    """Every planning round's bottleneck class, in order, while the block
    runs (the controller's trail keeps only the rounds that changed
    something)."""
    from petastorm_tpu_torch.pipeline import autotune as at

    classes, plan = [], at.Planner.plan

    def recording(self, profile):
        decisions = plan(self, profile)
        classes.append(self.last_class)
        return decisions

    at.Planner.plan = recording
    try:
        yield classes
    finally:
        at.Planner.plan = plan


def _classes_text(classes):
    """Round classes run-length encoded: ``idle, decode-bound, consumer-bound x21``."""
    runs = []
    for cls in classes:
        if runs and runs[-1][0] == cls:
            runs[-1][1] += 1
        else:
            runs.append([cls, 1])
    return ", ".join(cls if n == 1 else f"{cls} x{n}" for cls, n in runs) or "none"


def _trail_text(report):
    """The trail as one line: each entry's round, outcome and bottleneck
    class, with its decisions."""
    return "; ".join(
        f"r{e['round']} {e['outcome']} {e['bottleneck']}"
        + "".join(f" {d['knob']} {d['direction']} {d['from']}->{d['to']}"
                  for d in e["decisions"])
        for e in report["trail"])


def autotune_phase(smi, cfg=AUTOTUNE, device="cuda"):
    """Phase 13 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run
    on the card uses the defaults."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_columnar_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.spark import make_spark_converter
    from petastorm_tpu_torch.torch_utils.batcher import batch_iterator
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
    from petastorm_tpu_torch.workers_pool.thread_pool import WORKER_THREAD_PREFIX

    device = torch.device(device)
    image = cfg["image"]
    batch = image["batch"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    handler = _LogRecords()
    log = logging.getLogger("petastorm_tpu_torch.service.autotune")
    log.addHandler(handler)
    fa.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        # -- (a) bench.py's autotune leg ----------------------------------
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=image["rows"],
                                  image_shape=image["image_shape"],
                                  num_classes=image["classes"],
                                  rows_per_row_group=image["rows_per_row_group"])
        model = ic.init_image_classifier(image["image_shape"], image["classes"],
                                         hidden=image["hidden"],
                                         conv_features=image["conv_features"], device=device)
        step = ic.make_image_train_step(model, image["lr"])
        mask = torch.ones(batch, dtype=torch.bool, device=device)
        # A row's identity on the card: an exact int64 weighted sum of its
        # pixels (below 2^43), beside its label.
        weights = torch.randint(0, 1 << 20, (int(np.prod(image["image_shape"])),),
                                generator=torch.Generator().manual_seed(13)).to(device)
        for _ in range(2):  # the first steps' allocations, off every timed pass
            step(torch.zeros((batch,) + tuple(image["image_shape"]), dtype=torch.uint8,
                             device=device), torch.zeros(batch, dtype=torch.int32,
                                                         device=device), mask)
        sync()

        def make_reader_with(workers):
            kwargs = {} if workers is None else {"workers_count": workers}
            return make_columnar_reader(url, reader_pool_type="thread",
                                        num_epochs=cfg["epochs"], shuffle_row_groups=True,
                                        schema_fields=["image", "label"], **kwargs)

        def run_pass(name, workers, host_prefetch, device_prefetch, autotune):
            before = _registry_before()
            handler.records.clear()
            loader = make_torch_dataloader(
                make_reader_with(workers), batch, last_batch="drop", non_tensor_policy="drop",
                host_prefetch=host_prefetch, device_prefetch=device_prefetch,
                autotune=autotune, device=device)
            n, prints, devices = 0, [], set()
            t0 = time.perf_counter()
            with _window_classes() as classes, loader:
                for b in loader:
                    images = b["image"]
                    step(images, b["label"], mask)
                    prints.append(torch.stack(
                        [(images.reshape(batch, -1).long() * weights).sum(1),
                         b["label"].long()], 1))
                    devices.add(str(images.device))
                    n += batch
                sync()
                wall = time.perf_counter() - t0
                out = {"images_per_s": n / wall,
                       "input_stall_pct": loader.diagnostics["input_stall_pct"],
                       "rows": collections.Counter(map(tuple, torch.cat(prints).tolist())),
                       "devices": sorted(devices)}
                if autotune is not None:
                    out["autotune"] = _autotune_checks(loader, before, name, handler.records)
                    out["classes"] = classes
            left = [t.name for t in threading.enumerate()
                    if t.name.startswith(("pipeline-autotune", WORKER_THREAD_PREFIX))]
            if left:
                fail(f"autotune: threads alive after the {name} loader closed: {left}")
            return out

        def ceiling_pass():
            reader = make_reader_with(1)
            n, t0 = 0, time.perf_counter()
            with reader:
                for _ in batch_iterator(reader, batch, last_batch="drop"):
                    n += batch
            return n / (time.perf_counter() - t0)

        t_leg = time.perf_counter()
        ceiling_pass()  # the page cache and the interpreter, warm
        ceiling = ceiling_pass()
        best, trails = {}, []
        for round_index in range(cfg["repeats"] + 1):
            results = {name: run_pass(name, *variant)
                       for name, variant in cfg["variants"].items()}
            want = results["static_defaults"]["rows"]
            for name, result in results.items():
                if result["devices"] != ["cuda:0" if device.type == "cuda" else "cpu"]:
                    fail(f"autotune: {name} batches arrived on {result['devices']}")
                if result["rows"] != want:
                    fail(f"autotune: the {name} pass delivered another multiset of rows than "
                         f"the static pass ({sum(result['rows'].values())} rows against "
                         f"{sum(want.values())})")
            trails.append(results["autotuned_defaults"]["autotune"])
            if round_index == 0:
                continue  # the warm-up round: every variant pays it once
            for name, result in results.items():
                if name not in best or result["images_per_s"] > best[name]["images_per_s"]:
                    best[name] = result
        leg_s = time.perf_counter() - t_leg
        del model, step
        tuned, static, hand = (best[k] for k in ("autotuned_defaults", "static_defaults",
                                                 "hand_tuned"))
        report = tuned["autotune"]
        print(f"autotune (a): gpu={smi!r} bench.py leg_autotune on phase 4's store "
              f"({image['rows']} png {image['image_shape']}, row groups of "
              f"{image['rows_per_row_group']}) and CNN (conv {image['conv_features']}, hidden "
              f"{image['hidden']}, bf16), batch {batch}, {cfg['epochs']} epochs a pass, "
              f"{cfg['repeats']} measured round after a warm-up: "
              + " ".join(f"{name}_images_per_s={best[name]['images_per_s']:.1f} "
                         f"{name}_input_stall_pct={best[name]['input_stall_pct']}"
                         for name in cfg["variants"])
              + f" decode_ceiling_images_per_s={ceiling:.1f} "
              f"autotuned_vs_hand_tuned={tuned['images_per_s'] / hand['images_per_s']:.3f} "
              f"static_default_vs_hand_tuned={static['images_per_s'] / hand['images_per_s']:.3f} "
              f"pipeline_vs_decode_ceiling="
              + "/".join(f"{best[name]['images_per_s'] / ceiling:.2f}" for name in cfg["variants"])
              + f" rows_per_pass={sum(tuned['rows'].values())} (every variant = static multiset, "
              f"every round); knobs_in_force={report['knobs']} rounds={report['rounds']} "
              f"noop_streak={report['noop_streak']} rounds_per_pass="
              f"{[t['rounds'] for t in trails]} round_classes: {_classes_text(tuned['classes'])}; "
              f"trail: {_trail_text(report)}; leg_s={leg_s:.1f}",
              flush=True)

        # -- (b) the converter on the tabular store ---------------------------
        tab_url = f"file://{tmp}/criteo"
        td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        table = pq.read_table(os.path.join(tmp, "criteo", "part-00000.parquet"))
        parent = f"file://{tmp}/converter"
        t0 = time.perf_counter()
        conv = make_spark_converter(table, dtype="float32", parent_cache_dir_url=parent)
        materialize_s = time.perf_counter() - t0
        part = os.path.join(conv.cache_dir_url[len("file://"):], "part-00000.parquet")
        stamp = (os.stat(part).st_mtime_ns, sorted(os.listdir(os.path.join(tmp, "converter"))))
        t0 = time.perf_counter()
        again = make_spark_converter(table, dtype="float32", parent_cache_dir_url=parent)
        reuse_s = time.perf_counter() - t0
        if again.cache_dir_url != conv.cache_dir_url or \
                (os.stat(part).st_mtime_ns,
                 sorted(os.listdir(os.path.join(tmp, "converter")))) != stamp:
            fail("autotune: a second converter of the same table wrote again")
        if len(conv) != cfg["tab_rows"]:
            fail(f"autotune: the converter holds {len(conv)} rows, not {cfg['tab_rows']}")
        again.delete()
        if not os.path.exists(part):
            fail("autotune: delete() of one of two references removed the directory")

        reader_kw = dict(shuffle_row_groups=True, shard_seed=7, workers_count=1, num_epochs=1)
        with conv.make_torch_device_dataloader(
                batch_size=cfg["tab_batch"],
                loader_kwargs=dict(last_batch="drop", device=device), **reader_kw) as loader:
            via_converter = list(loader)
        with make_torch_dataloader(make_batch_reader(conv.cache_dir_url, **reader_kw),
                                   cfg["tab_batch"], last_batch="drop", device=device) as loader:
            direct = list(loader)
        if len(via_converter) != len(direct) or not all(
                sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
                for a, b in zip(via_converter, direct)):
            fail("autotune: the converter's device loader and make_batch_reader → "
                 "make_torch_dataloader gave other batches")
        parity_batches = len(direct)
        del via_converter, direct

        dlrm = td.init_dlrm(device=device)
        dlrm_step = td.make_dlrm_train_step(dlrm, cfg["tab_lr"])
        before = _registry_before()
        handler.records.clear()
        losses, seen = [], collections.Counter()
        with _window_classes() as tab_classes, conv.make_torch_device_dataloader(
                batch_size=cfg["tab_batch"], num_epochs=cfg["tab_epochs"],
                shuffle_row_groups=True, shard_seed=7,
                loader_kwargs=dict(last_batch="drop", device=device,
                                   autotune=True)) as loader:
            t0 = None
            for b in loader:
                if len(losses) == td.WARM_FROM_STEP:
                    sync()
                    t0 = time.perf_counter()
                dense, sparse, labels = td.collate_dlrm(b)
                losses.append(dlrm_step(dense, sparse, labels,
                                        torch.ones(labels.shape[0], dtype=torch.bool,
                                                   device=labels.device)))
                seen.update(b["sample_index"].tolist())
            sync()
            warm_s = time.perf_counter() - t0
            diag = loader.diagnostics
            tab_report = _autotune_checks(loader, before, "dlrm", handler.records)
        losses = [float(x) for x in losses]
        steps = len(losses)
        expected = cfg["tab_epochs"] * cfg["tab_rows"] // cfg["tab_batch"]
        if steps != expected or not all(math.isfinite(x) for x in losses):
            fail(f"autotune: the DLRM took {steps} steps (expected {expected}), losses "
                 f"{losses[:3]}...{losses[-3:]}")
        lost = cfg["tab_epochs"] * cfg["tab_rows"] - sum(seen.values())
        if max(seen.values()) > cfg["tab_epochs"] or not 0 <= lost < cfg["tab_batch"]:
            fail(f"autotune: rows trained more than {cfg['tab_epochs']} times or "
                 f"{lost} rows lost")

        with conv.make_torch_dataloader(batch_size=cfg["tab_batch"], num_epochs=1,
                                        device=device) as loader:
            t0 = time.perf_counter()
            ref_rows, ref_devices = 0, set()
            for b in loader:
                ref_rows += int(b["label"].shape[0])
                ref_devices.update(str(t.device) for t in b.values())
            sync()
            ref_s = time.perf_counter() - t0
        if ref_rows != cfg["tab_rows"] or len(ref_devices) != 1:
            fail(f"autotune: the BatchedDataLoader gave {ref_rows} rows on {ref_devices}")
        conv.delete()
        if os.path.exists(part):
            fail("autotune: delete() of the last reference left the directory")
        warm_steps = steps - td.WARM_FROM_STEP
        print(f"autotune (b): gpu={smi!r} make_spark_converter(pa.Table of "
              f"{cfg['tab_rows']} rows x {table.num_columns} columns, float32) "
              f"materialize_s={materialize_s:.3f} reuse_s={reuse_s:.3f} (same directory, "
              f"no write; delete() kept it for the other reference); "
              f"make_torch_device_dataloader = make_batch_reader → make_torch_dataloader, "
              f"{parity_batches} batches equal; the DLRM at the Criteo example's defaults "
              f"(batch {cfg['tab_batch']}, {cfg['tab_epochs']} epochs, autotune=True): "
              f"steps={steps} loss={losses[0]:.4f}->{losses[-1]:.4f} "
              f"steps_per_s_warm={warm_steps / warm_s:.1f} "
              f"rows_per_s_warm={warm_steps * cfg['tab_batch'] / warm_s:.1f} "
              f"input_stall_pct={diag['input_stall_pct']} knobs_in_force={tab_report['knobs']} "
              f"rounds={tab_report['rounds']} round_classes: {_classes_text(tab_classes)}; "
              f"trail: {_trail_text(tab_report) or 'empty'}; "
              f"BatchedDataLoader one epoch rows_per_s={ref_rows / ref_s:.1f} on "
              f"{sorted(ref_devices)}", flush=True)
    finally:
        log.removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"autotune: flash kernels launched on this path: {launches}")
    print(f"autotune (c): flash launches {launches}", flush=True)
    return {"autotuned_images_per_s": tuned["images_per_s"]}


def _image_digest(image, label):
    """An exact per-row digest of one image and its label: crc32 and
    adler32 of the image's bytes, and the label."""
    raw = image.tobytes()
    return (zlib.crc32(raw), zlib.adler32(raw), int(label))


class _DigestingSource:
    """A batch source that records each batch's per-image digests on the
    consuming thread and passes the batch on; its iterator keeps the inner
    one's ``prefetched`` and ``close``, so the loader pulls it as it would
    the source itself."""

    def __init__(self, source, sink):
        self._source, self._sink = source, sink

    def __call__(self):
        return _DigestingIterator(self._source(), self._sink)


class _DigestingIterator:
    def __init__(self, inner, sink):
        self._inner, self._sink = inner, sink
        self.prefetched = getattr(inner, "prefetched", False)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._inner)
        self._sink.extend(_image_digest(i, lab) for i, lab in zip(batch["image"], batch["label"]))
        return batch

    def close(self):
        self._inner.close()


def _service_fleet(service, url, cfg, factory, batch, workers_count, mode="static",
                   num_epochs=1, workers=None, dispatcher=None, tag=None, **worker_kwargs):
    """``(dispatcher, [workers])`` on 127.0.0.1, started. ``tag`` names the
    workers (the registry's series are per worker id); ``worker_kwargs``
    go to each worker, a ``batch_cache`` given as a zero-argument callable
    built once a worker."""
    dispatcher = dispatcher or service.Dispatcher(mode=mode, num_epochs=num_epochs).start()
    fleet = []
    try:
        for i in range(cfg["workers"] if workers is None else workers):
            kwargs = {k: (v() if k == "batch_cache" and callable(v) else v)
                      for k, v in worker_kwargs.items()}
            fleet.append(service.BatchWorker(
                url, dispatcher_address=dispatcher.address, batch_size=batch,
                reader_factory=factory, worker_id=f"svc-{tag or f'{factory}-{mode}'}-{i}",
                reader_kwargs={"workers_count": workers_count}, **kwargs).start())
    except BaseException:
        _stop_fleet(dispatcher, fleet)
        raise
    return dispatcher, fleet


def _stop_fleet(dispatcher, workers):
    for worker in workers:
        worker.stop()
    dispatcher.stop()


def _dlrm_epoch(loader, device, step, collect=True):
    """One pass of ``loader`` into the DLRM step: ``(rows/s from the second
    batch on, the sample_index values, losses, the batches' devices)``."""
    import torch

    from petastorm_tpu_torch.models import tabular_dlrm as td

    losses, collected, devices, rows, t0 = [], [], set(), 0, None
    for batch in loader:
        if t0 is None and losses:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        devices.update(str(t.device) for t in batch.values() if torch.is_tensor(t))
        dense, sparse, labels = td.collate_dlrm(batch)
        mask = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
        losses.append(step(dense, sparse, labels, mask))
        if collect:
            collected.append(batch["sample_index"])
        if t0 is not None:
            rows += labels.shape[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rate = rows / (time.perf_counter() - t0) if t0 is not None else 0.0
    ids = torch.cat(collected).cpu().numpy() if collected else None
    return rate, ids, [float(x) for x in losses], sorted(devices)


def service_phase(smi, image, cfg=SERVICE, device="cuda"):
    """Phase 14 (see the module docstring); fails the run on any check.
    ``image`` is phase 4's result (its images/s is reported beside this
    path's). ``cfg`` and ``device`` exist for a small dry run on the host;
    the run on the card uses the defaults."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import service
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader, make_torch_dataloader

    device = torch.device(device)
    img = cfg["image"]
    per_epoch = img["rows"]
    lines, t_parts = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_svc_")
    fa.reset_launch_counts()
    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=img["rows"],
                                  image_shape=img["image_shape"], num_classes=img["classes"],
                                  rows_per_row_group=img["rows_per_row_group"])
        # One decode worker: row groups in their order, for the bit-for-bit
        # comparison of (e).
        with make_reader(url, schema_fields=["image", "label"], num_epochs=1,
                         shuffle_row_groups=False, workers_count=1) as reader:
            local_rows = [(r.image, r.label) for r in reader]
        local_digests = collections.Counter(_image_digest(i, lab) for i, lab in local_rows)

        # (a) The image path through the service, twice (the second traced).
        t0 = time.perf_counter()
        disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                       cfg["workers_count"], num_epochs=img["epochs"])
        runs = []
        try:
            for traced in (False, True):
                in_shape = img["crop"] + (img["image_shape"][2],)
                torch.manual_seed(0)
                model = ic.init_image_classifier(in_shape, img["classes"], hidden=img["hidden"],
                                                 conv_features=img["conv_features"],
                                                 device=device)
                step = ic.make_image_train_step(model, img["lr"])
                wait_before = sum(w.diagnostics_snapshot()["metrics"]
                                  ["credit_wait_seconds_total"] for w in workers)
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"])
                digests = []
                loader = TorchDataLoader(
                    None, _DigestingSource(source, digests), device=device,
                    device_stage=DeviceStage(normalize=(127.5, 127.5), crop=img["crop"],
                                             flip=True))
                warm = -(-per_epoch // img["batch"])
                losses, devices, timed_rows, t_start = [], set(), 0, None
                prof = None
                if traced and device.type == "cuda":
                    from torch.profiler import ProfilerActivity, profile
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                try:
                    with loader:
                        for i, batch in enumerate(loader):
                            if i == warm:
                                if device.type == "cuda":
                                    torch.cuda.synchronize(device)
                                t_start = time.perf_counter()
                            devices.update(str(t.device) for t in batch.values()
                                           if torch.is_tensor(t))
                            images = batch["image"]
                            mask = batch.get(PAD_MASK_KEY)
                            if mask is None:
                                mask = torch.ones(images.shape[0], dtype=torch.bool,
                                                  device=images.device)
                            losses.append(step(images, batch["label"], mask))
                            if t_start is not None:
                                timed_rows += images.shape[0]
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        elapsed = time.perf_counter() - t_start
                        diag = loader.diagnostics
                finally:
                    if prof is not None:
                        prof.__exit__(None, None, None)
                busy = "not measured"
                if prof is not None and device.type == "cuda":
                    trace = os.path.join(tmp, "service_trace.json")
                    prof.export_chrome_trace(trace)
                    busy = device_busy_pct(trace, img["batch"] * int(np.prod(img["image_shape"])),
                                           warm)
                losses = [float(x) for x in losses]
                epochs = [collections.Counter(digests[e * per_epoch:(e + 1) * per_epoch])
                          for e in range(img["epochs"])]
                if len(digests) != img["epochs"] * per_epoch or any(
                        counts != local_digests for counts in epochs):
                    bad = [e for e, counts in enumerate(epochs) if counts != local_digests]
                    fail(f"service (a): {len(digests)} images over {img['epochs']} epochs; "
                         f"epochs {bad} differ from the local reader's digest multiset")
                if devices != {"cuda:0" if device.type == "cuda" else "cpu"}:
                    fail(f"service (a): batches arrived on {sorted(devices)}")
                if not all(math.isfinite(x) for x in losses):
                    fail(f"service (a): loss not finite: {losses}")
                runs.append({
                    "images_per_s": timed_rows / elapsed, "busy": busy, "diag": diag,
                    "recv_stall_s": sum(w["stall_s"] for w in
                                        source.diagnostics["per_worker"].values()),
                    "credit_wait_s": sum(w.diagnostics_snapshot()["metrics"]
                                         ["credit_wait_seconds_total"]
                                         for w in workers) - wait_before,
                    "losses": losses, "steps": len(losses)})
                del model, step, loader
        finally:
            _stop_fleet(disp, workers)
        plain, traced_run = runs
        t_parts["a"] = time.perf_counter() - t0
        lines.append(
            f"service (a): image path through {cfg['workers']} workers (row reader, "
            f"{cfg['workers_count']} threads each, batch {img['batch']}, credits "
            f"{cfg['credits']}) -> TorchDataLoader(device_stage) -> CNN conv "
            f"{img['conv_features']} hidden {img['hidden']} bf16, {img['epochs']} epochs "
            f"(first a warm-up): images_per_s={plain['images_per_s']:.1f} "
            f"local_phase4_images_per_s={image['images_per_s']:.1f} "
            f"ratio={plain['images_per_s'] / image['images_per_s']:.3f} "
            f"input_stall_pct={plain['diag']['input_stall_pct']} "
            f"recv_stall_s={plain['recv_stall_s']:.4f} "
            f"credit_wait_s={plain['credit_wait_s']:.4f} "
            f"traced_images_per_s={traced_run['images_per_s']:.1f} "
            f"device_busy_pct_traced={traced_run['busy']} "
            f"local_phase4_busy_pct={image['device_busy_pct_traced']} steps={plain['steps']} "
            f"loss_first={plain['losses'][0]:.4f} loss_last={plain['losses'][-1]:.4f} "
            f"epoch_digests=local x{img['epochs']}")

        # (b) The tabular path: local make_batch_reader against the service,
        # static (ordered) and fcfs, one DLRM epoch each.
        t0 = time.perf_counter()
        tab_url = f"file://{tmp}/criteo"
        rows = td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        rates = {}
        for kind in ("local", "static", "fcfs"):
            torch.manual_seed(0)
            model = td.init_dlrm(device=device)
            step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
            if kind == "local":
                reader = make_batch_reader(tab_url, num_epochs=1, shuffle_row_groups=False,
                                           workers_count=cfg["tab_workers_count"])
                loader = make_torch_dataloader(reader, cfg["tab_batch"], last_batch="keep",
                                               device=device)
                with loader:
                    rate, ids, losses, devices = _dlrm_epoch(loader, device, step)
            else:
                disp, workers = _service_fleet(service, tab_url, cfg, "batch",
                                               cfg["tab_batch"], cfg["tab_workers_count"],
                                               mode=kind)
                try:
                    source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                        ordered=kind == "static")
                    with TorchDataLoader(None, source, device=device) as loader:
                        rate, ids, losses, devices = _dlrm_epoch(loader, device, step)
                finally:
                    _stop_fleet(disp, workers)
            counts = np.bincount(ids, minlength=rows)
            if len(ids) != rows or counts.max() != 1:
                fail(f"service (b) {kind}: {len(ids)} rows delivered for {rows}, "
                     f"{int((counts > 1).sum())} more than once, "
                     f"{int((counts == 0).sum())} never")
            if not all(math.isfinite(x) for x in losses) or devices != [
                    "cuda:0" if device.type == "cuda" else "cpu"]:
                fail(f"service (b) {kind}: losses {losses[:4]}..., devices {devices}")
            rates[kind] = rate
            del model, step
        t_parts["b"] = time.perf_counter() - t0
        lines.append(
            f"service (b): Criteo-shaped store ({rows} rows, {cfg['tab_days']} row groups) "
            f"-> DLRM one epoch, batch {cfg['tab_batch']}, {cfg['workers']} workers x "
            f"{cfg['tab_workers_count']} threads, credits {cfg['credits']}: "
            f"local_rows_per_s={rates['local']:.1f} "
            f"static_ordered_rows_per_s={rates['static']:.1f} "
            f"fcfs_rows_per_s={rates['fcfs']:.1f} "
            f"static_over_local={rates['static'] / rates['local']:.3f} "
            f"fcfs_over_local={rates['fcfs'] / rates['local']:.3f} every row exactly once")

        # (c) A worker killed mid-epoch; a checkpoint resumed by a fresh fleet.
        t0 = time.perf_counter()
        disp, workers = _service_fleet(service, tab_url, cfg, "batch", cfg["tab_batch"],
                                       cfg["tab_workers_count"])
        try:
            source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                max_retries=1, backoff_base=0.02,
                                                backoff_max=0.1)
            got, killed = [], False
            with TorchDataLoader(None, source, device=device) as loader:
                for batch in loader:
                    got.append(batch["sample_index"])
                    if not killed and len(got) == cfg["kill_at"]:
                        workers[1].kill()
                        killed = True
            kill_ids = torch.cat(got).cpu().numpy()
            recovery = source.diagnostics["recovery"]
        finally:
            _stop_fleet(disp, workers)
        counts = np.bincount(kill_ids, minlength=rows)
        if not killed or counts.min() < 1:
            fail(f"service (c): kill at batch {cfg['kill_at']} (killed={killed}) lost "
                 f"{int((counts == 0).sum())} rows")
        kill_dupes = int(counts.sum() - rows)
        parts = []
        state = None
        for attempt in ("first", "resumed"):
            disp, workers = _service_fleet(service, tab_url, cfg, "batch", cfg["tab_batch"],
                                           cfg["tab_workers_count"])
            try:
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    resume_state=state)
                got = []
                with TorchDataLoader(None, source, device=device) as loader:
                    for batch in loader:
                        got.append(batch["sample_index"])
                        if attempt == "first" and len(got) == cfg["resume_at"]:
                            state = loader.state_dict()
                            break
                parts.append(torch.cat(got).cpu().numpy())
            finally:
                _stop_fleet(disp, workers)
        counts = np.bincount(np.concatenate(parts), minlength=rows)
        if counts.min() < 1:
            fail(f"service (c): the checkpoint at batch {cfg['resume_at']} and its resume "
                 f"left {int((counts == 0).sum())} rows unread")
        t_parts["c"] = time.perf_counter() - t0
        lines.append(
            f"service (c): worker killed after {cfg['kill_at']} batches: no row lost, "
            f"duplicates={kill_dupes} takeovers={recovery['takeovers']} "
            f"duplicates_dropped={recovery['duplicates_dropped']}; checkpoint after "
            f"{cfg['resume_at']} batches (epoch {state['epoch']}, "
            f"{len(state['completed_pieces'])} pieces done, watermarks "
            f"{state['watermarks']}) resumed by a fresh fleet: every row read, "
            f"re_read_rows={int(counts.sum() - rows)}")

        # (d) A worker in its own process that sees no card.
        t0 = time.perf_counter()
        disp = service.Dispatcher().start()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        child = subprocess.Popen(
            [sys.executable, "-m", "petastorm_tpu_torch.service", "worker", "--dispatcher",
             f"127.0.0.1:{disp.address[1]}", "--dataset-url", tab_url, "--reader", "batch",
             "--batch-size", str(cfg["tab_batch"]), "--workers-count",
             str(cfg["tab_workers_count"]), "--worker-id", "subprocess"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        try:
            hello = json.loads(child.stdout.readline() or "{}")
            if hello.get("worker_id") != "subprocess":
                fail(f"service (d): the worker process did not start: {hello} "
                     f"{child.stderr.read()[-2000:]}")
            source = service.ServiceBatchSource(disp.address, credits=cfg["credits"])
            got, handles = [], None
            with TorchDataLoader(None, source, device=device) as loader:
                for batch in loader:
                    got.append(batch["sample_index"])
                    if handles is None:
                        handles = card_handles(child.pid)  # mid-stream
            sub_ids = torch.cat(got).cpu().numpy()
            sub_devices = sorted({str(t.device) for t in got})
        finally:
            child.terminate()
            try:
                child.wait(timeout=20)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(timeout=10)
            child.stdout.close()
            child.stderr.close()
            disp.stop()
        if sorted(sub_ids.tolist()) != list(range(rows)):
            fail(f"service (d): the subprocess worker served {len(sub_ids)} rows, not "
                 f"each of {rows} once")
        if handles is None or handles[0] or handles[1]:
            fail(f"service (d): the worker process holds card handles {handles}")
        t_parts["d"] = time.perf_counter() - t0
        lines.append(
            f"service (d): worker process (CUDA_VISIBLE_DEVICES='', python -m "
            f"petastorm_tpu_torch.service worker) served {len(sub_ids)} rows to "
            f"{sub_devices}; its /proc: /dev/nvidia* files {handles[0]}, libcuda mapped "
            f"{handles[1]}")

        # (e) The image store through fsspec's memory:// to the card.
        t0 = time.perf_counter()
        import fsspec

        memory = fsspec.filesystem("memory")
        mem_path = f"/chip-smoke-{os.getpid()}/images"
        memory.put(os.path.join(tmp, "images"), mem_path, recursive=True)
        try:
            for how, kwargs in (("storage_options", {"storage_options": {
                    "skip_instance_cache": False}}), ("filesystem", {"filesystem": memory})):
                with make_reader(f"memory://{mem_path}", schema_fields=["image", "label"],
                                 num_epochs=1, shuffle_row_groups=False, workers_count=1,
                                 **kwargs) as reader:
                    loader = make_torch_dataloader(reader, img["batch"], last_batch="keep",
                                                   device=device)
                    got = [(b["image"].cpu().numpy(), b["label"].cpu().numpy())
                           for b in loader]
                mem_images = np.concatenate([g[0] for g in got])
                mem_labels = np.concatenate([g[1] for g in got])
                if not (np.array_equal(mem_images, np.stack([i for i, _ in local_rows]))
                        and np.array_equal(mem_labels, np.array([lab for _, lab in local_rows]))):
                    fail(f"service (e): memory:// through {how} differs from the local reader")
        finally:
            memory.rm(f"/chip-smoke-{os.getpid()}", recursive=True)
        t_parts["e"] = time.perf_counter() - t0
        lines.append(
            f"service (e): phase 4's store copied to memory://{mem_path} and read with "
            f"make_reader(storage_options=...) and make_reader(filesystem=...) to the card: "
            f"{len(local_rows)} images and labels bit for bit the local reader's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"service: a flash kernel ran on the data-service path: {launches}")
    print("\n".join(lines), flush=True)
    print(f"service: gpu={smi!r} parts_s=" + ",".join(f"{k}:{v:.1f}" for k, v in t_parts.items())
          + f" flash_launches={launches}", flush=True)
    return {"images_per_s": runs[0]["images_per_s"]}


def _image_trainer(img, device):
    """Phase 4's CNN at ``img``'s widths and its train step, seeded."""
    import torch

    from petastorm_tpu_torch.models import image_classifier as ic

    torch.manual_seed(0)
    model = ic.init_image_classifier(img["crop"] + (img["image_shape"][2],), img["classes"],
                                     hidden=img["hidden"], conv_features=img["conv_features"],
                                     device=device)
    return model, ic.make_image_train_step(model, img["lr"])


def _image_service_loader(service_source, img, device, sink):
    """``source`` → the digest tap → ``TorchDataLoader(device_stage=...)``."""
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    return TorchDataLoader(None, _DigestingSource(service_source, sink), device=device,
                           device_stage=DeviceStage(normalize=(127.5, 127.5), crop=img["crop"],
                                                    flip=True))


def _image_step(step, batch, device):
    import torch

    from petastorm_tpu_torch.torch_utils.batcher import PAD_MASK_KEY

    images = batch["image"]
    mask = batch.get(PAD_MASK_KEY)
    if mask is None:
        mask = torch.ones(images.shape[0], dtype=torch.bool, device=images.device)
    return step(images, batch["label"], mask), images.shape[0]


def _epoch_digests_ok(digests, local_digests, per_epoch, epochs):
    """The epochs whose digest multiset is not the local reader's."""
    if len(digests) != epochs * per_epoch:
        return list(range(epochs))
    return [e for e in range(epochs)
            if collections.Counter(digests[e * per_epoch:(e + 1) * per_epoch])
            != local_digests]


def _cli_node(args, cuda_visible=""):
    """``python -m petastorm_tpu_torch.service ...`` started without the card;
    its first stdout line is the bound address."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cuda_visible,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-m", "petastorm_tpu_torch.service"] + args,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    return child


def _stop_children(children):
    for child in children:
        child.terminate()
    for child in children:
        try:
            child.wait(timeout=20)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=10)
        child.stdout.close()
        child.stderr.close()


def control_phase(smi, cfg=CONTROL, device="cuda"):
    """Phase 15 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a small dry run on the host; the run on
    the card uses the defaults."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import failpoints, service
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.service.cli import collect_fleet_trace
    from petastorm_tpu_torch.telemetry import critical_path, tracing
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    device = torch.device(device)
    img = cfg["image"]
    per_epoch = img["rows"]
    batches_per_epoch = -(-per_epoch // img["batch"])
    on_card = "cuda:0" if device.type == "cuda" else "cpu"
    lines, t_parts = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_control_")
    fa.reset_launch_counts()
    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=img["rows"],
                                  image_shape=img["image_shape"], num_classes=img["classes"],
                                  rows_per_row_group=img["rows_per_row_group"])
        with make_reader(url, schema_fields=["image", "label"], num_epochs=1,
                         shuffle_row_groups=False, workers_count=1) as reader:
            local_digests = collections.Counter(_image_digest(r.image, r.label)
                                                for r in reader)

        # (a) The dispatcher killed mid-epoch and restarted from its journal.
        t0 = time.perf_counter()
        journal_dir = os.path.join(tmp, "journal")
        epochs = cfg["epochs"]
        disp = service.Dispatcher(journal_dir=journal_dir, num_epochs=epochs).start()
        port = disp.address[1]
        state = {"disp": disp}
        workers = []
        # Every send is slowed (the slow-peer failpoint, no key) from the
        # first batch until the client's resync: the workers cannot run
        # ahead of the restart, so the first epoch's streams outlive one
        # client heartbeat after it and the fence reaches a live drain.
        slow = failpoints.FaultSchedule(
            cfg["seed"], points=["slow-peer"], delay_s=cfg["restart_slow_s"],
            fires={"slow-peer": {i: "delay" for i in range(4 * batches_per_epoch)}})
        try:
            for i in range(cfg["workers"]):
                workers.append(service.BatchWorker(
                    url, dispatcher_address=disp.address, batch_size=img["batch"],
                    reader_factory="row", worker_id=f"ctl-{i}",
                    heartbeat_interval_s=cfg["heartbeat_s"],
                    reader_kwargs={"workers_count": cfg["workers_count"]}).start())
            model, step = _image_trainer(img, device)
            source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                heartbeat_interval_s=cfg["heartbeat_s"],
                                                max_retries=6, backoff_base=0.05,
                                                backoff_max=0.5)
            digests, losses, devices = [], [], set()
            loader = _image_service_loader(source, img, device, digests)
            restart = {}
            failpoints.arm(slow)
            t_run = time.perf_counter()
            with loader:
                for i, batch in enumerate(loader):
                    if "at" in restart and "next_batch_s" not in restart:
                        restart["next_batch_s"] = time.perf_counter() - restart["at"]
                    devices.update(str(t.device) for t in batch.values()
                                   if torch.is_tensor(t))
                    loss, _ = _image_step(step, batch, device)
                    losses.append(loss)
                    if failpoints.ACTIVE is slow \
                            and source.diagnostics["recovery"]["resyncs"] >= 1:
                        failpoints.disarm()
                    if i + 1 == cfg["restart_after"]:
                        restart["fencing_before"] = disp.state_snapshot()["fencing_epoch"]
                        disp.stop()
                        disp.drop_connections()
                        restart["at"] = time.perf_counter()
                        state["disp"] = service.Dispatcher(
                            port=port, journal_dir=journal_dir, num_epochs=epochs).start()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            run_s = time.perf_counter() - t_run
            if failpoints.ACTIVE is slow:
                failpoints.disarm()
            status = source.dispatcher_status()
            recovery = source.diagnostics["recovery"]
            diag = loader.diagnostics
        finally:
            if failpoints.ACTIVE is slow:
                failpoints.disarm()
            _stop_fleet(state["disp"], workers)
            disp.stop()
        losses = [float(x) for x in losses]
        bad = _epoch_digests_ok(digests, local_digests, per_epoch, epochs)
        if bad:
            fail(f"control (a): {len(digests)} images over {epochs} epochs across the "
                 f"dispatcher restart; epochs {bad} differ from the local reader's multiset")
        if devices != {on_card} or not all(math.isfinite(x) for x in losses):
            fail(f"control (a): batches on {sorted(devices)}, losses {losses[:4]}...")
        if status["recovery"]["journal_replays"] != 1 \
                or not status["fencing_epoch"] > restart["fencing_before"]:
            fail(f"control (a): the restarted dispatcher shows journal_replays "
                 f"{status['recovery']['journal_replays']}, fencing epoch "
                 f"{status['fencing_epoch']} (was {restart['fencing_before']})")
        if recovery["resyncs"] < 1:
            fail(f"control (a): the client never resynced: {recovery}")
        t_parts["a"] = time.perf_counter() - t0
        lines.append(
            f"control (a): image path ({cfg['workers']} row workers x "
            f"{cfg['workers_count']} threads, batch {img['batch']}, credits {cfg['credits']}, "
            f"heartbeats {cfg['heartbeat_s']} s) -> CNN, {epochs} epochs; the dispatcher "
            f"(journal_dir) stopped after {cfg['restart_after']} of {batches_per_epoch} "
            f"batches and restarted on its port from the journal, sends slowed "
            f"{cfg['restart_slow_s']} s from the start until the resync: "
            f"restart_to_next_batch_s="
            f"{restart['next_batch_s']:.4f} images_per_s_over_run="
            f"{len(digests) / run_s:.1f} run_s={run_s:.2f} journal_replays="
            f"{status['recovery']['journal_replays']} fencing {restart['fencing_before']}"
            f"->{status['fencing_epoch']} resyncs={recovery['resyncs']} streams_retired="
            f"{recovery['streams_retired']} heartbeat_failures="
            f"{recovery['heartbeat_failures']} duplicates_dropped="
            f"{recovery['duplicates_dropped']} input_stall_pct={diag['input_stall_pct']} "
            f"loss_first={losses[0]:.4f} loss_last={losses[-1]:.4f} epoch_digests=local "
            f"x{epochs}")
        del model, step, loader

        # (b) Hedging a slow peer; a breaker tripped on one worker.
        t0 = time.perf_counter()
        tab_url = f"file://{tmp}/criteo"
        rows = td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        outcomes = {}
        for case in ("hedge", "breaker"):
            torch.manual_seed(0)
            model = td.init_dlrm(device=device)
            step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
            disp, workers = _service_fleet(service, tab_url, dict(cfg, workers=2), "batch",
                                           cfg["tab_batch"], cfg["tab_workers_count"],
                                           mode="static")
            slow_wid = workers[1].worker_id
            if case == "hedge":
                schedule = failpoints.FaultSchedule(
                    cfg["seed"], points=["slow-peer", "hedge-race"],
                    delay_s=cfg["hedge_delay_s"], targets={"slow-peer": slow_wid},
                    fires={"slow-peer": {i: "delay" for i in cfg["hedge_at"]}})
                # The 0.9 quantile: with tens of gaps a 0.99 fit is the
                # largest one, a stream's first (its reader's start-up).
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    ordered=True, hedging=True,
                                                    hedge_quantile=cfg["hedge_quantile"])
            else:
                schedule = failpoints.FaultSchedule(
                    cfg["seed"], points=["breaker-trip"],
                    fires={"breaker-trip": {i: "reset" for i in range(8)}})
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    ordered=True, breaker_threshold=2,
                                                    max_retries=1, backoff_base=0.02,
                                                    backoff_max=0.1)
            try:
                with failpoints.armed(schedule), \
                        TorchDataLoader(None, source, device=device) as loader:
                    if case == "breaker":
                        loader = _DroppingLoader(loader, workers[1], cfg["drop_after"])
                    rate, ids, losses, devices = _dlrm_epoch(loader, device, step)
                if case == "breaker":
                    deadline = time.monotonic() + 5
                    while time.monotonic() < deadline:
                        status = source.dispatcher_status()
                        if slow_wid in status["fleet"]["breaker_open"]:
                            break
                        time.sleep(0.05)
                    with FramedConnection.connect(disp.address, timeout=10.0) as conn:
                        routed = conn.request({"type": "get_assignment",
                                               "client_id": "ctl-late", "client_index": 0,
                                               "num_clients": 1, "epoch": 1})[0]
                    outcomes[case] = {"status": status, "routed": routed}
                diag = source.diagnostics
            finally:
                _stop_fleet(disp, workers)
            counts = np.bincount(ids, minlength=rows)
            if len(ids) != rows or counts.max() != 1:
                fail(f"control (b) {case}: {len(ids)} rows delivered for {rows}, "
                     f"{int((counts > 1).sum())} more than once, "
                     f"{int((counts == 0).sum())} never")
            if not all(math.isfinite(x) for x in losses) or devices != [on_card]:
                fail(f"control (b) {case}: losses {losses[:4]}..., devices {devices}")
            outcomes.setdefault(case, {}).update(rate=rate, diag=diag, wid=slow_wid,
                                                 log=schedule.log_snapshot())
            del model, step
        hedge = outcomes["hedge"]["diag"]["resilience"]["hedge_counts"]
        if hedge["launched"] < 1:
            fail(f"control (b) hedge: no hedge launched against the slow peer: {hedge}")
        dedup = outcomes["hedge"]["diag"]["recovery"]["duplicates_dropped"]
        if hedge["won"] and not dedup:
            # A won race leaves the slow primary's late batches of the piece
            # to the watermark dedup.
            fail(f"control (b) hedge: {hedge['won']} hedges won but no loser's batch was "
                 "dropped")
        breaker = outcomes["breaker"]
        b_state = breaker["diag"]["resilience"]["breakers"].get(breaker["wid"], {})
        if b_state.get("state") != "open" \
                or breaker["wid"] not in breaker["status"]["fleet"]["breaker_open"]:
            fail(f"control (b) breaker: the client's breaker {b_state}, the dispatcher's "
                 f"breaker_open {sorted(breaker['status']['fleet']['breaker_open'])}")
        if breaker["wid"] in breaker["routed"]["workers"]:
            fail(f"control (b) breaker: a new grant went to the breaker-open worker: "
                 f"{breaker['routed']['workers']}")
        t_parts["b"] = time.perf_counter() - t0
        lines.append(
            f"control (b): Criteo-shaped store ({rows} rows) -> DLRM one epoch each, "
            f"batch {cfg['tab_batch']}, 2 workers x {cfg['tab_workers_count']} threads, "
            f"credits {cfg['credits']}, ordered: slow peer (slow-peer "
            f"{cfg['hedge_delay_s']} s at its sends {list(cfg['hedge_at'])}, hedging at "
            f"quantile {cfg['hedge_quantile']}) "
            f"rows_per_s={outcomes['hedge']['rate']:.1f} hedges launched={hedge['launched']} "
            f"won={hedge['won']} lost={hedge['lost']} threshold_s="
            f"{outcomes['hedge']['diag']['resilience']['hedge_threshold_s']} "
            f"duplicates_dropped={dedup}; breaker (one worker's connections dropped after "
            f"{cfg['drop_after']} batches, its reconnects reset, threshold 2) rows_per_s="
            f"{breaker['rate']:.1f} breaker={b_state.get('state')} dispatcher_breaker_open="
            f"{sorted(breaker['status']['fleet']['breaker_open'])} takeovers="
            f"{breaker['diag']['recovery']['takeovers']} new_grant_workers="
            f"{sorted(breaker['routed']['workers'])}; every row exactly once in both")

        # (c) A fleet trace of the image path: a dispatcher and two workers in
        # processes of their own, the trainer here.
        t0 = time.perf_counter()
        children = []
        try:
            disp_proc = _cli_node(["dispatcher", "--port", "0", "--num-epochs", "1"])
            children.append(disp_proc)
            hello = json.loads(disp_proc.stdout.readline() or "{}")
            if "port" not in hello:
                fail(f"control (c): the dispatcher process did not start: "
                     f"{disp_proc.stderr.read()[-2000:]}")
            address = ("127.0.0.1", hello["port"])
            for i in range(cfg["workers"]):
                children.append(_cli_node(
                    ["worker", "--dispatcher", f"127.0.0.1:{hello['port']}", "--dataset-url",
                     url, "--reader", "row", "--batch-size", str(img["batch"]),
                     "--workers-count", str(cfg["workers_count"]), "--worker-id",
                     f"trace-{i}", "--heartbeat-interval", str(cfg["heartbeat_s"])]))
            for child in children[1:]:
                if not json.loads(child.stdout.readline() or "{}").get("worker_id"):
                    fail(f"control (c): a worker process did not start: "
                         f"{child.stderr.read()[-2000:]}")
            with FramedConnection.connect(address, timeout=10.0) as conn:
                conn.request({"type": "trace", "action": "arm"})
            time.sleep(3 * cfg["heartbeat_s"])  # the workers arm on a heartbeat
            model, step = _image_trainer(img, device)
            source = service.ServiceBatchSource(address, credits=cfg["credits"],
                                                heartbeat_interval_s=cfg["heartbeat_s"])
            digests = []
            loader = _image_service_loader(source, img, device, digests)
            tracing.COLLECTOR.acquire()  # from the first batch on
            try:
                with loader:
                    for batch in loader:
                        _image_step(step, batch, device)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    stall = loader.diagnostics["input_stall_pct"]
            finally:
                tracing.COLLECTOR.release()
            doc = collect_fleet_trace(address)
            with FramedConnection.connect(address, timeout=10.0) as conn:
                conn.request({"type": "trace", "action": "disarm"})
        finally:
            _stop_children(children)
        if _epoch_digests_ok(digests, local_digests, per_epoch, 1):
            fail(f"control (c): the traced epoch's {len(digests)} images differ from the "
                 "local reader's")
        alignment = doc["otherData"]["clock_alignment"]
        peers = {source.client_id, "trace-0", "trace-1"}
        names = set(critical_path.process_names(doc["traceEvents"]).values())
        offsets = {p: (alignment.get(p) or {}).get("offset_us") for p in peers}
        if not peers <= set(alignment) or "dispatcher" not in names or not all(
                o is not None and math.isfinite(o) for o in offsets.values()):
            fail(f"control (c): the fleet trace holds {sorted(names)}, alignment "
                 f"{alignment}")
        report = critical_path.diagnose(doc["traceEvents"], measured_stall_pct=stall)
        profile = " ".join(f"{name}:{p['count']}x{p['mean_us'] / 1000:.3f}ms"
                           for name, p in sorted(report["stage_profile"].items()))
        ranked = " ".join(f"{r['stage']}@{r['peer']}:{r['share_pct']:.1f}%"
                          for r in report["bottlenecks"][:5])
        t_parts["c"] = time.perf_counter() - t0
        lines.append(
            f"control (c): one traced epoch of (a)'s image path, dispatcher and 2 workers "
            f"in processes of their own: events={len(doc['traceEvents'])} dropped="
            f"{doc['otherData']['dropped_events']} offsets_us="
            + ",".join(f"{p}:{offsets[p]:.1f}" for p in sorted(peers))
            + f" min_rtt_us=" + ",".join(
                f"{p}:{(alignment[p].get('min_rtt_us') or 0.0):.1f}" for p in sorted(peers))
            + f" measured_input_stall_pct={stall} wait_ms={report['wait_total_us'] / 1000:.1f}"
            f" coverage_pct={report['coverage_pct']} bottlenecks: {ranked}; "
            f"stage_profile: {profile}")
        del model, step, loader
    finally:
        if failpoints.ACTIVE is not None:
            failpoints.disarm()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"control: a flash kernel ran on the control-plane path: {launches}")
    print("\n".join(lines), flush=True)
    print(f"control: gpu={smi!r} parts_s=" + ",".join(f"{k}:{v:.1f}" for k, v in t_parts.items())
          + f" flash_launches={launches}", flush=True)
    return {"restart_to_next_batch_s": restart["next_batch_s"]}


class _DroppingLoader:
    """Iterates ``loader`` and drops ``worker``'s connections after
    ``after`` batches (the stream break the breaker case starts from)."""

    def __init__(self, loader, worker, after):
        self._loader, self._worker, self._after = loader, worker, after

    def __iter__(self):
        for i, batch in enumerate(self._loader):
            if i == self._after:
                self._worker.drop_connections()
            yield batch


def _image_run(source, img, device, epochs, local_digests, part, phase="dynamic", stamps=None):
    """Phase 4's CNN fed by ``source`` through the device stage for
    ``epochs`` epochs: images/s after the first epoch, the loader's
    diagnostics, losses; fails unless each epoch's digests are the local
    reader's, every batch is on the card and every loss finite (the
    failure names ``phase`` and ``part``). A list given as ``stamps`` gets
    the ``perf_counter`` at which each batch arrived."""
    import torch

    per_epoch = img["rows"]
    model, step = _image_trainer(img, device)
    digests, losses, devices, timed, t_start = [], [], set(), 0, None
    warm = -(-per_epoch // img["batch"])
    with _image_service_loader(source, img, device, digests) as loader:
        for i, batch in enumerate(loader):
            if i == warm:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t_start = time.perf_counter()
            if stamps is not None:
                stamps.append(time.perf_counter())
            devices.update(str(t.device) for t in batch.values() if torch.is_tensor(t))
            loss, n = _image_step(step, batch, device)
            losses.append(loss)
            if t_start is not None:
                timed += n
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t_start if t_start is not None else float("nan")
        diag = loader.diagnostics
    bad = _epoch_digests_ok(digests, local_digests, per_epoch, epochs)
    if bad:
        fail(f"{phase} ({part}): {len(digests)} images over {epochs} epochs; epochs {bad} "
             "differ from the local reader's digest multiset")
    on_card = "cuda:0" if device.type == "cuda" else "cpu"
    losses = [float(x) for x in losses]
    if devices != {on_card} or not all(math.isfinite(x) for x in losses):
        fail(f"{phase} ({part}): batches on {sorted(devices)}, losses {losses[:4]}...")
    return {"images_per_s": timed / elapsed, "diag": diag, "losses": losses}


def _engine_served(workers):
    """Pieces the workers' streaming engines served, over their finished
    streams' final diagnostics."""
    return sum(int(stream.get("engine_pieces_served", 0))
               for worker in workers
               for stream in worker.diagnostics_snapshot()["completed_streams"].values())


def dynamic_phase(smi, image, service_result, cfg=DYNAMIC, device="cuda"):
    """Phase 16 (see the module docstring); fails the run on any check.
    ``image`` is phase 4's result and ``service_result`` phase 14's (their
    images/s are reported beside this phase's). ``cfg`` and ``device`` exist
    for a small dry run on the host; the run on the card uses the
    defaults."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import failpoints, service
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader

    device = torch.device(device)
    img = cfg["image"]
    per_epoch = img["rows"]
    pieces = -(-per_epoch // img["rows_per_row_group"])
    on_card = "cuda:0" if device.type == "cuda" else "cpu"
    lines, t_parts = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dynamic_")
    fa.reset_launch_counts()
    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=img["rows"],
                                  image_shape=img["image_shape"], num_classes=img["classes"],
                                  rows_per_row_group=img["rows_per_row_group"])
        with make_reader(url, schema_fields=["image", "label"], num_epochs=1,
                         shuffle_row_groups=False, workers_count=1) as reader:
            local_rows = [(r.image, r.label) for r in reader]
        local_digests = collections.Counter(_image_digest(i, lab) for i, lab in local_rows)

        # (a) One skewed fleet, static then dynamic.
        t0 = time.perf_counter()
        skew = {}
        for mode in ("static", "dynamic"):
            disp = service.Dispatcher(mode=mode, num_epochs=cfg["epochs"]).start()
            workers = []
            try:
                for i, threads in enumerate(cfg["threads"]):
                    workers.append(service.BatchWorker(
                        url, dispatcher_address=disp.address, batch_size=img["batch"],
                        reader_factory="row", worker_id=f"skew-{mode}-{i}",
                        reader_kwargs={"workers_count": threads}).start())
                source = service.ServiceBatchSource(
                    disp.address, credits=cfg["credits"],
                    dynamic_sync_interval_s=cfg["sync_s"])
                run = _image_run(source, img, device, cfg["epochs"], local_digests,
                                 f"a {mode}")
                status = source.dispatcher_status()
            finally:
                _stop_fleet(disp, workers)
            recovery = source.diagnostics["recovery"]
            per_worker = (status["dynamic"] or {}).get("per_worker", {})
            run.update(
                steals={wid: f"{e['steals_in']}/{e['steals_out']}"
                        for wid, e in sorted(per_worker.items())},
                pieces={wid: c.get("pieces", 0)
                        for wid, c in sorted(source.diagnostics["per_worker"].items())},
                counters={k: recovery[k] for k in ("steals_applied", "steals_failed",
                                                   "dedup_dropped")})
            skew[mode] = run
        if skew["dynamic"]["counters"]["dedup_dropped"] or \
                skew["static"]["counters"]["steals_applied"]:
            fail(f"dynamic (a): counters {skew['dynamic']['counters']} "
                 f"static {skew['static']['counters']}")
        t_parts["a"] = time.perf_counter() - t0
        lines.append(
            f"dynamic (a): phase 4's store, {cfg['epochs']} epochs, 2 row workers with "
            f"{cfg['threads'][0]} and {cfg['threads'][1]} decode threads, credits "
            f"{cfg['credits']}: static_images_per_s={skew['static']['images_per_s']:.1f} "
            f"dynamic_images_per_s={skew['dynamic']['images_per_s']:.1f} "
            f"dynamic_over_static="
            f"{skew['dynamic']['images_per_s'] / skew['static']['images_per_s']:.3f} "
            f"static_stall_pct={skew['static']['diag']['input_stall_pct']} "
            f"dynamic_stall_pct={skew['dynamic']['diag']['input_stall_pct']} "
            f"steals_in/out={skew['dynamic']['steals']} "
            f"pieces static={skew['static']['pieces']} dynamic={skew['dynamic']['pieces']} "
            f"{' '.join(f'{k}={v}' for k, v in skew['dynamic']['counters'].items())} "
            f"epoch_digests=local x{cfg['epochs']} both")

        # (b) The tabular shape, ordered, on a journaled dynamic dispatcher:
        # a worker joins mid-epoch; the first sync reply granting it steals
        # is lost after they were journaled, and the dispatcher restarts
        # from its journal on the same port.
        t0 = time.perf_counter()
        tab_url = f"file://{tmp}/criteo"
        rows = td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        journal = os.path.join(tmp, "journal")
        disp = service.Dispatcher(mode="dynamic", num_epochs=1, journal_dir=journal,
                                  lease_timeout_s=None).start()
        port = disp.address[1]
        workers, restarted, corrective = [], None, []
        lost = threading.Event()
        joined = "tab-join"

        def losing(handler):
            def handle(header):
                if lost.is_set():
                    raise ConnectionError("the dispatcher is going down")
                reply = handler(header)
                if any(d["to"] == joined for d in reply.get("steals", ())):
                    lost.set()  # journaled, never answered
                    raise ConnectionError("the reply is lost with the dispatcher")
                return reply
            return handle

        disp._handle_dynamic_sync = losing(disp._handle_dynamic_sync)
        try:
            for i in range(2):
                workers.append(service.BatchWorker(
                    tab_url, dispatcher_address=disp.address, batch_size=cfg["tab_batch"],
                    reader_factory="batch", worker_id=f"tab-{i}",
                    batch_delay_s=cfg["tab_delay_s"],
                    reader_kwargs={"workers_count": cfg["tab_workers_count"]}).start())
            torch.manual_seed(0)
            model = td.init_dlrm(device=device)
            step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
            source = service.ServiceBatchSource(
                ("127.0.0.1", port), credits=cfg["credits"], ordered=True,
                dynamic_sync_interval_s=cfg["sync_s"], heartbeat_interval_s=cfg["sync_s"])
            ids, losses, devices, t_restart = [], [], set(), None
            t_run = time.perf_counter()
            with TorchDataLoader(None, source, device=device) as loader:
                for i, batch in enumerate(loader):
                    devices.update(str(t.device) for t in batch.values()
                                   if torch.is_tensor(t))
                    dense, sparse, labels = td.collate_dlrm(batch)
                    mask = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
                    losses.append(step(dense, sparse, labels, mask))
                    ids.append(batch["sample_index"])
                    if i == cfg["join_after"]:
                        workers.append(service.BatchWorker(
                            tab_url, dispatcher_address=disp.address,
                            batch_size=cfg["tab_batch"], reader_factory="batch",
                            worker_id=joined,
                            reader_kwargs={"workers_count": cfg["tab_workers_count"]}).start())
                    if lost.is_set() and restarted is None:
                        t_restart = time.perf_counter()
                        disp.stop()
                        restarted = service.Dispatcher(port=port, mode="dynamic",
                                                       num_epochs=1, journal_dir=journal,
                                                       lease_timeout_s=None)
                        handler = restarted._handle_dynamic_sync

                        def watch(header, handler=handler, server=restarted):
                            generation = server._generation
                            reply = handler(header)
                            corrective.extend(d for d in reply.get("steals", ())
                                              if d["generation"] <= generation)
                            return reply
                        restarted._handle_dynamic_sync = watch
                        restarted.start()
                        t_restart = time.perf_counter() - t_restart
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tab_rate = rows / (time.perf_counter() - t_run)
            status = (restarted or disp)._handle({"type": "status"})
            final = (restarted or disp).state_snapshot()
        finally:
            for worker in workers:
                worker.stop()
            (restarted or disp).stop()
        ids = torch.cat(ids).cpu().numpy()
        counts = np.bincount(ids, minlength=rows)
        owner = {p: (w, g) for dyn in final["dyn"].values() for p, w, g in dyn["owner"]}
        applied = [d for d in corrective if owner.get(d["piece"]) == (d["to"], d["generation"])]
        recovery = source.diagnostics["recovery"]
        pieces_by = {wid: c.get("pieces", 0)
                     for wid, c in sorted(source.diagnostics["per_worker"].items())}
        if len(ids) != rows or counts.max() != 1:
            fail(f"dynamic (b): {len(ids)} rows delivered for {rows}, "
                 f"{int((counts > 1).sum())} more than once, {int((counts == 0).sum())} never")
        if restarted is None or status["recovery"]["journal_replays"] != 1:
            fail(f"dynamic (b): the dispatcher was not restarted from its journal once "
                 f"(lost={lost.is_set()}, replays "
                 f"{status['recovery']['journal_replays'] if restarted else None})")
        if not applied or pieces_by.get(joined, 0) < 1:
            fail(f"dynamic (b): corrective deltas {corrective}, applied {applied}, pieces "
                 f"by worker {pieces_by}")
        if not all(math.isfinite(float(x)) for x in losses) or devices != {on_card}:
            fail(f"dynamic (b): losses {losses[:4]}..., devices {sorted(devices)}")
        t_parts["b"] = time.perf_counter() - t0
        steals = status["dynamic"]["per_worker"]
        lines.append(
            f"dynamic (b): Criteo-shaped store ({rows} rows, {cfg['tab_days']} row groups) -> "
            f"DLRM one epoch, ordered, batch {cfg['tab_batch']}, 2 workers x "
            f"{cfg['tab_workers_count']} threads (sends slowed {cfg['tab_delay_s']} s), "
            f"journaled dynamic dispatcher: {joined} joined after batch {cfg['join_after']}; "
            f"the sync reply granting it steals lost after journaling, the dispatcher "
            f"restarted from its journal on the same port in {t_restart:.3f} s: "
            f"journal_replays={status['recovery']['journal_replays']} "
            f"corrective_deltas={len(corrective)} applied={len(applied)} "
            f"steals_in/out={ {w: (e['steals_in'], e['steals_out']) for w, e in steals.items()} } "
            f"pieces={pieces_by} steals_applied={recovery['steals_applied']} "
            f"steals_failed={recovery['steals_failed']} "
            f"dedup_dropped={recovery['dedup_dropped']} "
            f"heartbeat_failures={recovery['heartbeat_failures']} "
            f"rows_per_s={tab_rate:.1f} every row exactly once")

        # (c) A tagged static image stream with a poison piece, quarantined.
        t0 = time.perf_counter()
        poison = cfg["poison"]
        with failpoints.armed(failpoints.FaultSchedule(0, poison_pieces={poison})):
            disp = service.Dispatcher(mode="static", num_epochs=1).start()
            workers = []
            try:
                for i in range(2):
                    workers.append(service.BatchWorker(
                        url, dispatcher_address=disp.address, batch_size=img["batch"],
                        reader_factory="row", worker_id=f"poison-{i}",
                        on_piece_error="quarantine",
                        reader_kwargs={"workers_count": cfg["threads"][1]}).start())
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    on_piece_error="quarantine")
                model, step = _image_trainer(img, device)
                digests, losses, devices = [], [], set()
                with _image_service_loader(source, img, device, digests) as loader:
                    for batch in loader:
                        devices.update(str(t.device) for t in batch.values()
                                       if torch.is_tensor(t))
                        losses.append(float(_image_step(step, batch, device)[0]))
                status = disp._handle({"type": "status"})
            finally:
                _stop_fleet(disp, workers)
        poisoned = collections.Counter(_image_digest(i, lab) for i, lab in
                                       local_rows[poison * img["rows_per_row_group"]:
                                                  (poison + 1) * img["rows_per_row_group"]])
        want = local_digests - poisoned
        quarantined = source.diagnostics["quarantined_pieces"]
        if collections.Counter(digests) != want or len(digests) != sum(want.values()):
            fail(f"dynamic (c): {len(digests)} images, want {sum(want.values())} once each")
        if [q["piece"] for q in quarantined] != [poison] \
                or sorted(status["quarantined"]) != [str(poison)]:
            fail(f"dynamic (c): quarantined {quarantined}, dispatcher "
                 f"{sorted(status['quarantined'])}")
        if devices != {on_card} or not all(math.isfinite(x) for x in losses):
            fail(f"dynamic (c): batches on {sorted(devices)}, losses {losses[:4]}...")
        t_parts["c"] = time.perf_counter() - t0
        lines.append(
            f"dynamic (c): static tagged image stream, 2 workers on_piece_error='quarantine', "
            f"FaultSchedule(poison_pieces={{{poison}}}): piece {poison} reported once by "
            f"{quarantined[0]['worker_id']} and journaled, {len(digests)} images "
            f"({pieces - 1} pieces) each delivered once to {on_card}, {len(losses)} steps")

        # (d) Phase 14's image path on the streaming engine.
        t0 = time.perf_counter()
        disp, workers = _service_fleet(service, url, SERVICE, "row", img["batch"],
                                       SERVICE["workers_count"], num_epochs=img["epochs"])
        try:
            source = service.ServiceBatchSource(disp.address, credits=SERVICE["credits"])
            engine = _image_run(source, img, device, img["epochs"], local_digests, "d")
            served = _engine_served(workers)
        finally:
            _stop_fleet(disp, workers)
        if served != pieces * img["epochs"]:
            fail(f"dynamic (d): the engines served {served} pieces, want "
                 f"{pieces * img['epochs']}")
        t_parts["d"] = time.perf_counter() - t0
        lines.append(
            f"dynamic (d): phase 14's image path ({SERVICE['workers']} workers x "
            f"{SERVICE['workers_count']} threads, credits {SERVICE['credits']}, "
            f"{img['epochs']} epochs) on the streaming piece engine ({served} pieces served by "
            f"it): images_per_s={engine['images_per_s']:.1f} "
            f"local_phase4_images_per_s={image['images_per_s']:.1f} "
            f"ratio={engine['images_per_s'] / image['images_per_s']:.3f} "
            f"phase14_images_per_s={service_result['images_per_s']:.1f} "
            f"input_stall_pct={engine['diag']['input_stall_pct']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"dynamic: a flash kernel ran on the dynamic-sharding path: {launches}")
    print("\n".join(lines), flush=True)
    print(f"dynamic: gpu={smi!r} parts_s=" + ",".join(f"{k}:{v:.1f}" for k, v in t_parts.items())
          + f" flash_launches={launches}", flush=True)
    return {"static_images_per_s": skew["static"]["images_per_s"],
            "dynamic_images_per_s": skew["dynamic"]["images_per_s"]}


def _mirror_images(batch):
    """Phase 17's worker-side batch transform: each image mirrored left to
    right (a copy, so a cached or aliased batch is never changed)."""
    import numpy as np

    out = dict(batch)
    out["image"] = np.ascontiguousarray(np.asarray(batch["image"])[:, :, ::-1])
    return out


class _TunedDigestingSource(_DigestingSource):
    """The digest tap, passing every other attribute to the service source,
    so the autotuner's graph binds the source's knobs through it."""

    def __getattr__(self, name):
        return getattr(self._source, name)


def _handoff_seconds():
    from petastorm_tpu_torch.telemetry.metrics import WORKER_HANDOFF_SECONDS

    return sum(child.value for child in WORKER_HANDOFF_SECONDS.children().values())


def _shm_frames():
    from petastorm_tpu_torch.telemetry.metrics import SHM_FRAMES

    return {path: SHM_FRAMES.labels(path).value for path in ("mapped", "copied", "spilled")}


def _plane_image_pass(source, img, device):
    """One pass of ``source`` into phase 4's CNN: the images' digests in
    delivery order, the losses and the batches' devices."""
    import torch

    model, step = _image_trainer(img, device)
    digests, losses, devices = [], [], set()
    with _image_service_loader(source, img, device, digests) as loader:
        for batch in loader:
            devices.update(str(t.device) for t in batch.values() if torch.is_tensor(t))
            losses.append(float(_image_step(step, batch, device)[0]))
    return digests, losses, devices


class _LateWakeups(threading.Thread):
    """Sleeps ``tick_s`` at a time until :meth:`halt` and records how late
    each wake-up resumed: past the kernel's timer slack, the lateness is
    the time this thread waited for the GIL behind the process's others."""

    def __init__(self, tick_s):
        super().__init__(daemon=True, name="gil-probe")
        self.tick_s, self.late, self._halt = tick_s, [], threading.Event()

    def run(self):
        while not self._halt.is_set():
            t0 = time.perf_counter()
            time.sleep(self.tick_s)
            self.late.append(time.perf_counter() - t0 - self.tick_s)

    def halt(self):
        """Stops the thread: ``{"ticks", "mean_ms", "p99_ms", "max_ms"}``."""
        self._halt.set()
        self.join()
        late = sorted(self.late) or [float("nan")]
        return {"ticks": len(self.late), "mean_ms": 1e3 * statistics.fmean(late),
                "p99_ms": 1e3 * late[min(len(late) - 1, int(0.99 * len(late)))],
                "max_ms": 1e3 * late[-1]}


def _epoch_gaps(stamps, per_epoch):
    """Mean ms between batches across an epoch boundary (the old streams'
    end, the new streams' set-up, their first batch; from the second warm
    epoch on) and within an epoch, over the arrival times ``stamps``."""
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    cross = [g for j, g in enumerate(gaps) if (j + 1) % per_epoch == 0 and j + 1 >= 2 * per_epoch]
    within = [g for j, g in enumerate(gaps) if (j + 1) % per_epoch and j >= per_epoch]
    return statistics.fmean(cross or [float("nan")]), statistics.fmean(within or [float("nan")])


def _shm_recv_messages():
    from petastorm_tpu_torch.telemetry.metrics import TRANSPORT_MESSAGES

    return TRANSPORT_MESSAGES.labels("recv", "shm").value


def _plane_fleet_counts(metrics, by_epoch):
    """``(shm streams, tcp streams, hits, misses, epoch-0 misses)`` over the
    workers' metrics snapshots and per-epoch cache stats."""
    return (sum(int(m["transport_streams_shm_total"]) for m in metrics),
            sum(int(m["transport_streams_tcp_total"]) for m in metrics),
            sum(int(m["cache_hits_total"]) for m in metrics),
            sum(int(m["cache_misses_total"]) for m in metrics),
            sum(e.get(0, {}).get("misses", 0) for e in by_epoch))


class _StreamRequests:
    """Counts the pieces that every stream ``source`` opens names, first
    requests and the re-serves of a broken stream alike: each is one cache
    lookup on the stream's worker once the stream reaches its engine."""

    def __init__(self, source):
        self.pieces, self._lock, inner = 0, threading.Lock(), source._stream

        def counted(wid, address, pieces, *args, **kwargs):
            with self._lock:
                self.pieces += len(pieces)
            return inner(wid, address, pieces, *args, **kwargs)

        source._stream = counted


def _plane_check(part, transport, counts, frames, recv_shm, cfg, epochs, pieces, requested):
    """Fails unless every stream took ``transport``'s tier, every piece
    missed once (its cold epoch) and every warm lookup hit, and the frames
    went the way of the tier (``frames`` and ``recv_shm`` are None for
    workers in their own processes, whose frame counters live there).
    ``requested``: the pieces the client's streams named; beyond one per
    piece and epoch, a re-opened stream's (its worker looks those up
    again), so the hits are exactly the warm pieces' when none was."""
    shm, tcp, hits, misses, cold = counts
    if (shm, tcp) != ((shm + tcp, 0) if transport == "shm" else (0, shm + tcp)) \
            or shm + tcp < cfg["workers"] * epochs:
        fail(f"dataplane ({part}) {transport}: streams shm={shm} tcp={tcp}")
    warm, again = pieces * (epochs - 1), requested - pieces * epochs
    if misses != pieces or not warm <= hits <= warm + again or cold not in (None, pieces):
        fail(f"dataplane ({part}) {transport}: cache hits {hits} misses {misses} (epoch 0 "
             f"misses {cold}), want {warm} (+ up to {again} named again by re-opened "
             f"streams) / {pieces}")
    if (recv_shm > 0) != (transport == "shm"):
        fail(f"dataplane ({part}) {transport}: {recv_shm} messages received over shm")
    if frames is not None and transport == "shm" and not frames["mapped"]:
        fail(f"dataplane ({part}) shm: no frame served mapped from the pool: {frames}")
    if frames is not None and transport == "tcp" and any(frames.values()):
        fail(f"dataplane ({part}) tcp: frames went through a ring: {frames}")


def _plane_process_run(service, url, cfg, img, device, transport, tag, local_digests,
                       pieces):
    """(a)'s image path with the two cached workers in processes of their
    own (``--cache mem``, no card), the dispatcher and the trainer here."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    mode = "tcp" if transport == "tcp" else "auto"
    epochs = cfg["a_epochs"]
    disp = service.Dispatcher(num_epochs=epochs).start()
    children = []
    try:
        for i in range(cfg["workers"]):
            children.append(_cli_node(
                ["worker", "--dispatcher", f"127.0.0.1:{disp.address[1]}", "--dataset-url",
                 url, "--reader", "row", "--batch-size", str(img["batch"]), "--workers-count",
                 str(cfg["workers_count"]), "--worker-id", f"{tag}-{i}", "--cache", "mem",
                 "--cache-mem-mb", str(cfg["cache_mb"]), "--transport", mode]))
        for child in children:
            if not json.loads(child.stdout.readline() or "{}").get("worker_id"):
                fail(f"dataplane (a) {tag}: a worker process did not start: "
                     f"{child.stderr.read()[-2000:]}")
        recv0 = _shm_recv_messages()
        source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                            transport=mode)
        requested = _StreamRequests(source)
        stamps = []
        run = _image_run(source, img, device, epochs, local_digests, f"a {tag}",
                         phase="dataplane", stamps=stamps)
        recv_shm = _shm_recv_messages() - recv0
        with FramedConnection.connect(disp.address, timeout=10.0) as conn:
            _, diagnostics = conn.request({"type": "worker_diagnostics"})
    finally:
        _stop_children(children)
        disp.stop()
    metrics = [(diagnostics.get(f"{tag}-{i}") or {}).get("metrics") or {}
               for i in range(cfg["workers"])]
    if not all(metrics):
        fail(f"dataplane (a) {tag}: no diagnostics from every worker: {sorted(diagnostics)}")
    counts = _plane_fleet_counts(metrics, ())[:4] + (None,)
    _plane_check("a", transport, counts, None, recv_shm, cfg, epochs, pieces,
                 requested.pieces)
    run.update(streams=counts[0] + counts[1], hits=counts[2],
               again=requested.pieces - pieces * epochs,
               gaps=_epoch_gaps(stamps, -(-img["rows"] // img["batch"])))
    return run


def _plane_traced_epochs(source, img, device, local_digests, epochs, tick_s):
    """One cold epoch of ``source`` into phase 4's CNN, then ``epochs`` - 1
    warm ones with the trace armed and a :class:`_LateWakeups` probe
    running: ``(trace report, the warm epochs' wall s, the probe's
    lateness)``."""
    import torch

    from petastorm_tpu_torch.telemetry import critical_path, tracing

    model, step = _image_trainer(img, device)
    warm = -(-img["rows"] // img["batch"])
    digests, probe, t0 = [], _LateWakeups(tick_s), None
    try:
        with _image_service_loader(source, img, device, digests) as loader:
            for i, batch in enumerate(loader):
                if i == warm:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    tracing.COLLECTOR.acquire()
                    probe.start()
                    t0 = time.perf_counter()
                _image_step(step, batch, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
    finally:
        if t0 is not None:
            tracing.COLLECTOR.release()
            late = probe.halt()
    if t0 is None or _epoch_digests_ok(digests, local_digests, img["rows"], epochs):
        fail(f"dataplane (a): the traced run's {len(digests)} images differ from the local "
             "reader's")
    return critical_path.diagnose(tracing.COLLECTOR.events()), t1 - t0, late


def dataplane_phase(smi, image, service_result, cfg=DATAPLANE, device="cuda"):
    """Phase 17 (see the module docstring); fails the run on any check.
    ``image`` is phase 4's result and ``service_result`` phase 14's (their
    images/s are reported beside this phase's). ``cfg`` and ``device`` exist
    for a small dry run on the host; the run on the card uses the
    defaults."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from petastorm_tpu_torch import service
    from petastorm_tpu_torch.cache_impl import BatchCache
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.models import tabular_dlrm as td
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.predicates import ColumnPredicate
    from petastorm_tpu_torch.reader.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.service.shm_ring import live_shm_counts
    from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader, make_torch_dataloader

    device = torch.device(device)
    img = cfg["image"]
    per_epoch = img["rows"]
    pieces = -(-per_epoch // img["rows_per_row_group"])
    on_card = "cuda:0" if device.type == "cuda" else "cpu"
    lines, t_parts = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dataplane_")
    shm_before = live_shm_counts()
    fa.reset_launch_counts()

    def cache():
        return BatchCache(mem_budget_bytes=cfg["cache_mb"] << 20)

    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=img["rows"],
                                  image_shape=img["image_shape"], num_classes=img["classes"],
                                  rows_per_row_group=img["rows_per_row_group"])
        with make_reader(url, schema_fields=["image", "label"], num_epochs=1,
                         shuffle_row_groups=False, workers_count=1) as reader:
            local_rows = [(r.image, r.label) for r in reader]
        local_digests = collections.Counter(_image_digest(i, lab) for i, lab in local_rows)

        # (a) Phase 14 (a)'s image path, each worker with a memory batch cache
        # (warm epochs from the frame pool on shm): TCP and shm in turns, with
        # the workers here and then in processes of their own; then traced
        # warm epochs on each transport.
        t0 = time.perf_counter()
        epochs = cfg["a_epochs"]
        plane = {"here": {}, "procs": {}}
        for k, transport in enumerate(cfg["a_order"]):
            mode = "tcp" if transport == "tcp" else "auto"
            frames0, recv0 = _shm_frames(), _shm_recv_messages()
            disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                           cfg["workers_count"], num_epochs=epochs,
                                           tag=f"a-{transport}-{k}", transport=mode,
                                           batch_cache=cache)
            try:
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    transport=mode)
                requested = _StreamRequests(source)
                stamps = []
                run = _image_run(source, img, device, epochs, local_digests,
                                 f"a {transport}", phase="dataplane", stamps=stamps)
                metrics = [w.diagnostics_snapshot()["metrics"] for w in workers]
                by_epoch = [w.cache_stats_by_epoch() for w in workers]
            finally:
                _stop_fleet(disp, workers)
            frames = {k: v - frames0[k] for k, v in _shm_frames().items()}
            counts = _plane_fleet_counts(metrics, by_epoch)
            _plane_check("a", transport, counts, frames, _shm_recv_messages() - recv0, cfg,
                         epochs, pieces, requested.pieces)
            run.update(streams=counts[0] + counts[1], frames=frames, hits=counts[2],
                       again=requested.pieces - pieces * epochs,
                       gaps=_epoch_gaps(stamps, -(-per_epoch // img["batch"])))
            plane["here"].setdefault(transport, []).append(run)
        for k, transport in enumerate(cfg["a_order"]):
            plane["procs"].setdefault(transport, []).append(_plane_process_run(
                service, url, cfg, img, device, transport, f"a-proc-{transport}-{k}",
                local_digests, pieces))
        traced = {}
        for transport in ("tcp", "shm"):
            mode = "tcp" if transport == "tcp" else "auto"
            disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                           cfg["workers_count"],
                                           num_epochs=cfg["a_traced_epochs"],
                                           tag=f"a-traced-{transport}", transport=mode,
                                           batch_cache=cache)
            try:
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    transport=mode)
                traced[transport] = _plane_traced_epochs(
                    source, img, device, local_digests, cfg["a_traced_epochs"],
                    cfg["probe_tick_s"])
            finally:
                _stop_fleet(disp, workers)
        t_parts["a"] = time.perf_counter() - t0
        # Pair k is the k-th tcp run with the k-th shm run: (tcp, shm) first,
        # then (shm, tcp), so an effect of order shows as their difference.
        pairs = {where: [s["images_per_s"] / t["images_per_s"]
                         for t, s in zip(runs["tcp"], runs["shm"])]
                 for where, runs in plane.items()}

        def rates(runs):
            return ",".join(f"{r['images_per_s']:.1f}" for r in runs)

        def stalls(runs):
            return ",".join(f"{r['diag']['input_stall_pct']}" for r in runs)

        def gaps(runs):
            return ",".join(f"{r['gaps'][0]:.2f}/{r['gaps'][1]:.2f}" for r in runs)

        def again(runs):
            return ",".join(str(r["again"]) for r in runs)

        shm_run = plane["here"]["shm"][0]
        lines.append(
            f"dataplane (a): phase 14 (a)'s image path ({cfg['workers']} workers x "
            f"{cfg['workers_count']} threads, credits {cfg['credits']}, {epochs} "
            f"epochs), each worker with BatchCache(mem {cfg['cache_mb']} MiB), runs in the "
            f"order {'/'.join(cfg['a_order'])}: workers_here tcp_images_per_s="
            f"{rates(plane['here']['tcp'])} shm_images_per_s={rates(plane['here']['shm'])} "
            f"shm_over_tcp_pairs=" + ",".join(f"{x:.3f}" for x in pairs["here"])
            + f" tcp_stall_pct={stalls(plane['here']['tcp'])} "
            f"shm_stall_pct={stalls(plane['here']['shm'])} gap_ms_across/within_epoch "
            f"tcp={gaps(plane['here']['tcp'])} shm={gaps(plane['here']['shm'])}; "
            f"workers_in_processes "
            f"tcp_images_per_s={rates(plane['procs']['tcp'])} "
            f"shm_images_per_s={rates(plane['procs']['shm'])} shm_over_tcp_pairs="
            + ",".join(f"{x:.3f}" for x in pairs["procs"])
            + f" tcp_stall_pct={stalls(plane['procs']['tcp'])} "
            f"shm_stall_pct={stalls(plane['procs']['shm'])} gap_ms_across/within_epoch "
            f"tcp={gaps(plane['procs']['tcp'])} shm={gaps(plane['procs']['shm'])}; "
            f"each shm run: "
            f"transport_streams_shm_total={shm_run['streams']} (all streams) "
            f"cache_hits={shm_run['hits']} (every warm piece) "
            f"shm_frames mapped/copied/spilled={shm_run['frames']['mapped']:.0f}/"
            f"{shm_run['frames']['copied']:.0f}/{shm_run['frames']['spilled']:.0f} "
            f"phase4_images_per_s={image['images_per_s']:.1f} "
            f"phase14_images_per_s={service_result['images_per_s']:.1f} "
            f"epoch_digests=local x{epochs} every run; pieces named again by re-opened "
            f"streams workers_here tcp={again(plane['here']['tcp'])} "
            f"shm={again(plane['here']['shm'])} workers_in_processes "
            f"tcp={again(plane['procs']['tcp'])} shm={again(plane['procs']['shm'])}")
        for transport, (report, wall, late) in traced.items():
            profile = " ".join(f"{name}:{p['count']}x{p['mean_us'] / 1000:.3f}ms"
                               for name, p in sorted(report["stage_profile"].items()))
            ranked = " ".join(f"{r['stage']}:{r['share_pct']:.1f}%"
                              for r in report["bottlenecks"][:4])
            lines.append(
                f"dataplane (a) traced warm epochs {transport} (workers here, "
                f"{cfg['a_traced_epochs'] - 1} after a cold one): wall_s={wall:.4f} "
                f"images_per_s={per_epoch * (cfg['a_traced_epochs'] - 1) / wall:.1f} "
                f"wait_ms={report['wait_total_us'] / 1000:.1f} coverage_pct="
                f"{report['coverage_pct']} wait_on: {ranked or 'none'}; stage_profile: "
                f"{profile}; gil_probe ticks={late['ticks']} late_mean_ms="
                f"{late['mean_ms']:.3f} late_p99_ms={late['p99_ms']:.3f} "
                f"late_max_ms={late['max_ms']:.3f}")

        # (b) The Criteo-shaped store with a ColumnPredicate and the DLRM's
        # projection: hoisted to the workers, then on the client, then the
        # local reader with the same predicate.
        t0 = time.perf_counter()
        tab_url = f"file://{tmp}/criteo"
        rows = td.make_tabular_dataset(tab_url, rows=cfg["tab_rows"], days=cfg["tab_days"])
        predicate = ColumnPredicate("cat_0", "mod-eq", 0, modulus=cfg["tab_keep_mod"])
        projection = (["label", "sample_index"] + [f"dense_{i}" for i in range(td.NUM_DENSE)]
                      + [f"cat_{i}" for i in range(td.NUM_SPARSE)])
        table = pq.read_table(os.path.join(tmp, "criteo", "part-00000.parquet"),
                              columns=projection)
        keep = table.column("cat_0").to_numpy() % cfg["tab_keep_mod"] == 0
        want = {name: table.column(name).to_numpy()[keep] for name in projection}
        order = np.argsort(want["sample_index"])
        want = {name: column[order] for name, column in want.items()}
        arms = {}
        for arm in ("worker", "client", "local"):
            torch.manual_seed(0)
            model = td.init_dlrm(device=device)
            step = td.make_dlrm_train_step(model, td.LEARNING_RATE)
            workers, sent = [], None
            if arm == "local":
                reader = make_batch_reader(tab_url, num_epochs=1, shuffle_row_groups=False,
                                           workers_count=cfg["tab_workers_count"],
                                           predicate=predicate, schema_fields=projection)
                loader = make_torch_dataloader(reader, cfg["tab_batch"], last_batch="keep",
                                               device=device)
            else:
                disp, workers = _service_fleet(service, tab_url, cfg, "batch",
                                               cfg["tab_batch"], cfg["tab_workers_count"],
                                               tag=f"b-{arm}")
                source = service.ServiceBatchSource(
                    disp.address, credits=cfg["credits"], predicate=predicate,
                    projection=projection, filter_placement=arm)
                loader = TorchDataLoader(None, source, device=device)
            got, losses, devices, n, t_first = {k: [] for k in projection}, [], set(), 0, None
            try:
                with loader:
                    for batch in loader:
                        if t_first is None and losses:
                            if device.type == "cuda":
                                torch.cuda.synchronize(device)
                            t_first = time.perf_counter()
                        devices.update(str(t.device) for t in batch.values()
                                       if torch.is_tensor(t))
                        dense, sparse, labels = td.collate_dlrm(batch)
                        mask = torch.ones(labels.shape[0], dtype=torch.bool,
                                          device=labels.device)
                        losses.append(float(step(dense, sparse, labels, mask)))
                        for name in projection:
                            got[name].append(batch[name].cpu().numpy())
                        if t_first is not None:
                            n += labels.shape[0]
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                rate = n / (time.perf_counter() - t_first) if t_first else 0.0
                if workers:
                    sent = sum(int(w.diagnostics_snapshot()["metrics"]["rows_sent_total"])
                               for w in workers)
            finally:
                if workers:
                    _stop_fleet(disp, workers)
            got = {k: np.concatenate(v) for k, v in got.items()}
            order = np.argsort(got["sample_index"], kind="stable")
            if sorted(batch) != sorted(projection) or any(
                    not np.array_equal(got[k][order], want[k]) for k in projection):
                fail(f"dataplane (b) {arm}: {len(got['sample_index'])} rows, want "
                     f"{len(want['sample_index'])}: the rows differ from the predicate's "
                     f"survivors")
            if devices != {on_card} or not all(math.isfinite(x) for x in losses):
                fail(f"dataplane (b) {arm}: batches on {sorted(devices)}, losses "
                     f"{losses[:4]}...")
            arms[arm] = {"rate": rate, "sent": sent, "batches": len(losses)}
            del model, step
        survivors = len(want["sample_index"])
        if arms["worker"]["sent"] != survivors or arms["client"]["sent"] != rows:
            fail(f"dataplane (b): rows sent hoisted {arms['worker']['sent']} (want "
                 f"{survivors}), client {arms['client']['sent']} (want {rows})")
        t_parts["b"] = time.perf_counter() - t0
        lines.append(
            f"dataplane (b): Criteo-shaped store ({rows} rows, {cfg['tab_days']} row groups, "
            f"42 columns) -> DLRM one epoch, batch {cfg['tab_batch']}, {cfg['workers']} "
            f"workers x {cfg['tab_workers_count']} threads, credits {cfg['credits']}, "
            f"{predicate!r} with the DLRM's {len(projection)}-column projection: "
            f"worker_filter_rows_per_s={arms['worker']['rate']:.1f} "
            f"client_filter_rows_per_s={arms['client']['rate']:.1f} "
            f"local_reader_rows_per_s={arms['local']['rate']:.1f} "
            f"worker_over_client={arms['worker']['rate'] / arms['client']['rate']:.3f} "
            f"rows_sent hoisted={arms['worker']['sent']} client={arms['client']['sent']} "
            f"batches hoisted={arms['worker']['batches']} client={arms['client']['batches']} "
            f"local={arms['local']['batches']}: every arm the same {survivors} rows, "
            f"column for column")

        # (c) Stage fusion off and on with the transform on the workers, then
        # the cache placement flipped from post-transform to post-decode.
        t0 = time.perf_counter()
        mirrored = collections.Counter(
            _image_digest(np.ascontiguousarray(i[:, ::-1]), lab) for i, lab in local_rows)
        passes, handoff = {}, {}
        disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                       cfg["workers_count"], tag="c-fusion",
                                       batch_transform=_mirror_images)
        try:
            for fusion in ("off", "fused"):
                before = _handoff_seconds()
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    ordered=True, transform=_mirror_images,
                                                    stage_fusion=fusion)
                passes[fusion] = _plane_image_pass(source, img, device)
                handoff[fusion] = _handoff_seconds() - before
        finally:
            _stop_fleet(disp, workers)
        stats = []
        disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                       cfg["workers_count"], tag="c-cache",
                                       batch_cache=cache, batch_transform=_mirror_images)
        try:
            for placement in ("post-transform", "post-decode"):
                source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                                    ordered=True, transform=_mirror_images,
                                                    cache_placement=placement)
                passes[placement] = _plane_image_pass(source, img, device)
                stats.append(sum(int(w.cache_stats()["misses"]) for w in workers))
        finally:
            _stop_fleet(disp, workers)
        for name, (digests, losses, devices) in passes.items():
            if digests != passes["off"][0]:
                fail(f"dataplane (c): the {name} pass's {len(digests)} digests differ from "
                     "the unfused pass's, in order")
            if devices != {on_card} or not all(math.isfinite(x) for x in losses):
                fail(f"dataplane (c) {name}: batches on {sorted(devices)}, losses "
                     f"{losses[:4]}...")
        if collections.Counter(passes["off"][0]) != mirrored:
            fail("dataplane (c): the transformed images are not the local rows mirrored")
        if not handoff["off"] > 0 or handoff["fused"] != 0:
            fail(f"dataplane (c): hand-off seconds unfused {handoff['off']}, fused "
                 f"{handoff['fused']} (want > 0 and 0)")
        if stats != [pieces, 2 * pieces]:
            fail(f"dataplane (c): cache misses after each placement {stats}, want "
                 f"{[pieces, 2 * pieces]} (the flip refills)")
        t_parts["c"] = time.perf_counter() - t0
        lines.append(
            f"dataplane (c): the image path, worker transform (mirror), ordered, one epoch "
            f"a pass: stage_fusion off/fused digests identical in order, "
            f"handoff_s off={handoff['off']:.4f} fused={handoff['fused']:.4f}; "
            f"cache_placement post-transform -> post-decode: misses {stats[0]} -> "
            f"{stats[1]} (refilled), digests identical; {len(passes['off'][0])} images a pass "
            f"on {on_card}")

        # (d) An autotuned run of the image path with the rewrites armed.
        t0 = time.perf_counter()
        disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                       cfg["workers_count"], num_epochs=cfg["tune_epochs"],
                                       tag="d")
        try:
            source = service.ServiceBatchSource(disp.address, credits=cfg["credits"])
            model, step = _image_trainer(img, device)
            digests, devices, losses = [], set(), []
            loader = TorchDataLoader(
                None, _TunedDigestingSource(source, digests), device=device,
                device_stage=DeviceStage(normalize=(127.5, 127.5), crop=img["crop"], flip=True),
                autotune=dict(cfg["tune"]))
            with _window_classes() as classes:
                with loader:
                    for batch in loader:
                        devices.update(str(t.device) for t in batch.values()
                                       if torch.is_tensor(t))
                        losses.append(float(_image_step(step, batch, device)[0]))
            report = loader.autotune.report()
            running = loader.autotune.running
            rewrites = {name: getattr(source, name) for name in
                        ("stage_fusion", "filter_placement", "cache_placement",
                         "reader_family")}
            knobs = sorted(loader.autotune.graph.knobs)
        finally:
            _stop_fleet(disp, workers)
        bad = _epoch_digests_ok(digests, local_digests, per_epoch, cfg["tune_epochs"])
        if bad or devices != {on_card} or running \
                or not all(math.isfinite(x) for x in losses):
            fail(f"dataplane (d): epochs {bad} differ from the local reader's, batches on "
                 f"{sorted(devices)}, controller running={running}")
        if not {"stage_fusion", "reader_family"} <= set(knobs):
            fail(f"dataplane (d): the rewrite knobs are not bound: {knobs}")
        decisions = [(e["round"], d) for e in report["trail"] for d in e["decisions"]]
        tagged = [f"r{r} {d['knob']} {d['direction']} {d['from']}->{d['to']} "
                  f"({d.get('reason', '')})" for r, d in decisions if d.get("rewrite")]
        t_parts["d"] = time.perf_counter() - t0
        lines.append(
            f"dataplane (d): autotune {cfg['tune']} over the image path, "
            f"{cfg['tune_epochs']} epochs, knobs {knobs}: rounds={report['rounds']} "
            f"classes: {_classes_text(classes)}; rewrite decisions: "
            f"{'; '.join(tagged) or 'none'}; all decisions: {_trail_text(report) or 'none'}; "
            f"rewrites for the next iteration {rewrites}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"dataplane: a flash kernel ran on the data plane's path: {launches}")
    if live_shm_counts() != shm_before:
        fail(f"dataplane: shared memory left mapped: {live_shm_counts()} (was {shm_before})")
    print("\n".join(lines), flush=True)
    print(f"dataplane: gpu={smi!r} parts_s=" + ",".join(f"{k}:{v:.1f}" for k, v in t_parts.items())
          + f" flash_launches={launches}", flush=True)
    return {"tcp_images_per_s": plane["here"]["tcp"][0]["images_per_s"],
            "shm_images_per_s": plane["here"]["shm"][0]["images_per_s"]}


class _FleetTap:
    """Phase 18's batch source tap: each batch's ids and a ``StreamDigest``
    of it as the workers sent it (image and label, in delivery order), then
    the batch on. ``after_epoch`` is set once a whole epoch went through,
    ``marked`` once ``mark`` rows did."""

    def __init__(self, source, per_epoch, mark=1):
        from petastorm_tpu_torch.service.chaos import StreamDigest

        self._source, self._per_epoch, self._mark = source, per_epoch, mark
        self.ids = []
        self.after_epoch = threading.Event()
        self.marked = threading.Event()
        self.stream = StreamDigest()

    def __call__(self):
        return _FleetTapIterator(self._source(), self)


class _FleetTapIterator(_DigestingIterator):
    def __init__(self, inner, tap):
        super().__init__(inner, None)
        self._tap = tap

    def __next__(self):
        batch = next(self._inner)
        tap = self._tap
        tap.ids.extend(int(i) for i in batch["id"])
        tap.stream.update({"image": batch["image"], "label": batch["label"]})
        if len(tap.ids) >= tap._mark:
            tap.marked.set()
        if len(tap.ids) >= tap._per_epoch:
            tap.after_epoch.set()
        return batch


@contextlib.contextmanager
def _chaos_from_mark(tap, injector):
    """Run ``injector`` from the moment ``tap`` passed its mark (the streams
    are up) until the block ends."""
    starter = threading.Thread(target=lambda: tap.marked.wait(300) and injector.start(),
                               daemon=True)
    starter.start()
    try:
        yield injector
    finally:
        tap.marked.set()  # a block that failed early must not leave it waiting
        starter.join()
        injector.stop()


def _fleet_slow_batch(batch):
    """Phase 18 (b)'s worker batch transform (``--batch-transform
    chip_smoke:_fleet_slow_batch``): the identity after a pause, a heavy
    augmentation's cost, so one worker's cold epoch keeps a backlog."""
    time.sleep(FLEET["b_transform_s"])
    return batch


def _fleet_job_run(tap, img, device, epochs, local_digests, part):
    """Phase 4's CNN fed by ``tap`` (:func:`_image_run`: images/s after the
    first epoch, each epoch's digests the local reader's, every batch on the
    card); fails unless the loss fell from its first quarter to its last."""
    run = _image_run(tap, img, device, epochs, local_digests, part, phase="fleet")
    first, last = run["quarters"] = quarter_means(run["losses"])
    if not last < first:
        fail(f"fleet ({part}): the loss did not fall: quarter means {first:.4f} -> "
             f"{last:.4f}")
    return run


def _fleet_wait(what, predicate, timeout_s, poll_s=0.05):
    """Poll ``predicate`` until it returns a true value (returned), or fail."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = predicate()
        if value:
            return value
        if time.monotonic() > deadline:
            fail(f"fleet: timed out after {timeout_s:.0f}s waiting for {what}")
        time.sleep(poll_s)


def _fleet_owner_tag(service, url, img, cfg, prefix):
    """A worker-id tag for ``_service_fleet`` under which every piece the
    dynamic plan gives the second worker is owned by it on the ring
    (:func:`~petastorm_tpu_torch.cache_impl.hash_ring.placement` over the two
    workers): those entries stay on the worker that decodes them (no
    write-through copy), so each one stolen to the first worker in a warm
    epoch is served from its peer."""
    from petastorm_tpu_torch.cache_impl.hash_ring import placement

    probe = service.BatchWorker(url, batch_size=img["batch"], reader_factory="row",
                                reader_kwargs={"workers_count": cfg["workers_count"]})
    probe.num_pieces = probe._count_pieces()
    keys = [probe._piece_cache_key(p, family="row") for p in range(probe.num_pieces)]
    for k in range(1 << 14):
        tag = f"{prefix}{k}"
        ids = [f"svc-{tag}-{i}" for i in range(2)]
        owners = placement(keys[1::2], ids)
        if set(owners.values()) == {ids[1]}:
            return tag
    fail("fleet (a): no worker-id tag gives the second worker's pieces to it on the ring")


def _fleet_cli_arm(service, url, cfg, img, device, local_digests, tmp, planner):
    """(b): the dispatcher (``--autoscale``, journaled) and two fleet-cache
    workers, one ``--standby``, as ``python -m petastorm_tpu_torch.service``
    processes without the card; jobs train through them here."""
    from petastorm_tpu_torch.reader_impl.framed_socket import FramedConnection

    disp_args = ["dispatcher", "--port", "0", "--mode", "dynamic", "--num-epochs",
                 str(cfg["b_epochs"]), "--shuffle-seed", str(cfg["seed"]), "--journal-dir",
                 os.path.join(tmp, f"journal-{planner}"), "--lease-timeout",
                 str(cfg["b_lease_s"]), "--autoscale", "--autoscale-interval",
                 str(cfg["autoscale_interval_s"]), "--autoscale-planner", planner]
    children = []

    def request(address, header):
        with FramedConnection.connect(address, timeout=10.0) as conn:
            return conn.request(header)

    def fleet_status(address):
        return request(address, {"type": "status"})[0]

    def start(args, key):
        child = _cli_node(args)
        children.append(child)
        ready = json.loads(child.stdout.readline() or "{}")
        if not ready.get(key):
            fail(f"fleet (b) {planner}: a {args[0]} process did not start: "
                 f"{child.stderr.read()[-2000:]}")
        return child, ready

    def run_job(address, job, part):
        with service.JobHandle(address, job):
            tap = _FleetTap(service.ServiceBatchSource(address, job_id=job,
                                                       credits=cfg["credits"],
                                                       dynamic_sync_interval_s=cfg["sync_s"]),
                            img["rows"])
            return _fleet_job_run(tap, img, device, cfg["b_epochs"], local_digests, part)

    out = {}
    try:
        _, ready = start(disp_args, "port")
        address = ("127.0.0.1", ready["port"])
        workers = {}
        # The serving worker registers first: a fleet with no serving worker
        # admits a standby one at once.
        for i in range(2):
            wid = f"fleet-b-{planner}-{i}"
            workers[wid], _ = start(
                ["worker", "--dispatcher", f"127.0.0.1:{address[1]}", "--dataset-url", url,
                 "--reader", "row", "--batch-size", str(img["batch"]), "--workers-count",
                 str(cfg["workers_count"]), "--worker-id", wid, "--cache", "mem",
                 "--cache-mem-mb", str(cfg["cache_mb"]), "--fleet-cache",
                 "--heartbeat-interval", str(cfg["b_heartbeat_s"]), "--batch-transform",
                 "chip_smoke:_fleet_slow_batch"] + (["--standby"] if i else []), "worker_id")
        states = fleet_status(address)["fleet"]["workers_by_state"]
        if states["serving"] != [f"fleet-b-{planner}-0"] \
                or states["standby"] != [f"fleet-b-{planner}-1"]:
            fail(f"fleet (b) {planner}: workers by state {states}")
        out["job1_images_per_s"] = run_job(address, f"fleet-b-{planner}-1",
                                           f"b {planner} job 1")["images_per_s"]
        if planner == "model":
            plans = _fleet_wait("a journaled fleet_plan",
                                lambda: fleet_status(address)["fleet"]["fleet_plans"], 15.0)
            out["fleet_plans"] = len(plans)
            out["last_plan"] = {k: plans[-1].get(k) for k in ("action", "worker_id",
                                                              "predicted_rows_s",
                                                              "whatif_error")}
        else:
            if fleet_status(address)["fleet"]["autoscale"]["admit"] < 1:
                fail(f"fleet (b) streak: the standby worker was not admitted under the "
                     f"job's backlog: {fleet_status(address)['fleet']}")

            def settled():
                fleet = fleet_status(address)["fleet"]
                states = fleet["workers_by_state"]
                if fleet["autoscale"]["retire"] < 1 or len(states["serving"]) != 1 \
                        or states["draining"] or not states["standby"]:
                    return None
                drained = states["standby"][0]
                handoffs = [h for h in fleet["cache_handoffs"] if h["worker_id"] == drained]
                return (fleet, drained, handoffs[-1]) if handoffs else None

            # The job ended and the fleet idles: a worker is drained, ships its
            # memory tier and is retired to standby.
            fleet, drained, handoff = _fleet_wait(
                "a drain, its hand-off and a retire", settled, 30.0)
            if not handoff["entries"] > 0 or handoff["errors"] or handoff["torn"]:
                fail(f"fleet (b) streak: the hand-off shipped nothing or failed: {handoff}")
            survivor = fleet["workers_by_state"]["serving"][0]
            # The retired worker leaves the pool (its process stops and its
            # lease expires): the next job is the survivor's alone.
            _stop_children([workers[drained]])
            _fleet_wait("the stopped worker's lease to expire",
                        lambda: not fleet_status(address)["workers"][drained]["alive"],
                        5.0 * cfg["b_lease_s"])
            before = request(address, {"type": "worker_diagnostics"})[1][survivor]["metrics"]
            run2 = run_job(address, f"fleet-b-{planner}-2", f"b {planner} job 2")
            after = request(address, {"type": "worker_diagnostics"})[1][survivor]["metrics"]
            if after["cache_misses_total"] != before["cache_misses_total"]:
                fail(f"fleet (b) streak: the job after the hand-off decoded "
                     f"{after['cache_misses_total'] - before['cache_misses_total']} pieces")
            out.update(autoscale=fleet["autoscale"], handoff=handoff, survivor=survivor,
                       job2_images_per_s=run2["images_per_s"],
                       misses=after["cache_misses_total"],
                       hits=after["cache_hits_total"] - before["cache_hits_total"])
        live = fleet_status(address)["fleet"]
        _stop_children(children[:1])  # SIGTERM: the dispatcher stops and closes its journal
        _, ready = start(disp_args, "port")
        again = fleet_status(("127.0.0.1", ready["port"]))["fleet"]
        if planner == "streak":
            same = all(again[k] == live[k] for k in ("autoscale", "cache_handoffs",
                                                      "fleet_plans"))
        else:  # the model planner may decide between the reading and the stop
            same = (again["fleet_plans"][:len(live["fleet_plans"])] == live["fleet_plans"]
                    and all(again["autoscale"][k] >= v for k, v in live["autoscale"].items()))
        if not same:
            fail(f"fleet (b) {planner}: the dispatcher restarted from its journal reports "
                 f"{again}, the live one {live}")
        out["restart_autoscale"] = again["autoscale"]
        out["restart_handoffs"] = len(again["cache_handoffs"])
    finally:
        _stop_children([c for c in children if c.returncode is None])
    return out


def fleet_phase(smi, image, cfg=None, device="cuda"):
    """Phase 18 (see the module docstring); fails the run on any check.
    ``image`` is phase 4's result (its images/s are reported beside the
    jobs'). ``cfg`` and ``device`` exist for a small dry run on the host;
    the run on the card uses the defaults."""
    import torch

    from petastorm_tpu_torch import failpoints, service
    from petastorm_tpu_torch.cache_impl import BatchCache
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec
    from petastorm_tpu_torch.service import chaos
    from petastorm_tpu_torch.service.fleet import open_job_registrations
    from petastorm_tpu_torch.telemetry.metrics import FLEET_JOB_ROWS

    cfg = cfg or FLEET
    device = torch.device(device)
    img = cfg["image"]
    per_epoch = img["rows"]
    pieces = -(-per_epoch // img["rows_per_row_group"])
    figures, t_parts = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    fa.reset_launch_counts()

    def cache():
        return BatchCache(mem_budget_bytes=cfg["cache_mb"] << 20)

    try:
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=img["rows"],
                                  image_shape=img["image_shape"], num_classes=img["classes"],
                                  rows_per_row_group=img["rows_per_row_group"])
        with make_reader(url, schema_fields=["id", "image", "label"], num_epochs=1,
                         shuffle_row_groups=False, workers_count=1) as reader:
            local = [(int(r.id), _image_digest(r.image, r.label)) for r in reader]
        local_digests = collections.Counter(d for _, d in local)
        local_ids = [i for i, _ in local]

        # (a) Two weighted jobs training at once on the card through one
        # dynamic fleet of two fleet-cache workers.
        t0 = time.perf_counter()
        epochs = cfg["a_epochs"]
        tag = _fleet_owner_tag(service, url, img, cfg, "fleet-a")
        disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                       cfg["workers_count"], tag=tag,
                                       dispatcher=service.Dispatcher(
                                           mode="dynamic", num_epochs=epochs,
                                           shuffle_seed=cfg["seed"]).start(),
                                       batch_cache=cache, fleet_cache=True,
                                       heartbeat_interval_s=cfg["heartbeat_s"])
        jobs = {"fleet-a": cfg["weights"][0], "fleet-b": cfg["weights"][1]}
        runs, errors, scales = {}, [], {job: [] for job in jobs}
        try:
            _fleet_wait("every worker's ring to hold both peers",
                        lambda: all(w.cache_stats()["peers"] == len(workers) for w in workers),
                        10.0)
            rows0 = {job: FLEET_JOB_ROWS.labels(job).value for job in jobs}

            class _Source(service.ServiceBatchSource):
                def _dispatcher_request(self, header, retries=None):
                    reply = super()._dispatcher_request(header, retries)
                    if header.get("type") == "dynamic_plan":
                        scales[self.job_id].append(reply.get("credit_scale"))
                    return reply

            # In its cold epoch fleet-a syncs only when a worker's deque drains
            # (each piece is decoded where planned: a steal's revoke of a piece
            # in decode would decode it twice); later epochs, like fleet-b's,
            # rebalance each sync.
            taps = {job: _FleetTap(_Source(disp.address, job_id=job, credits=cfg["credits"],
                                           dynamic_sync_interval_s=sync), per_epoch)
                    for job, sync in (("fleet-a", cfg["a_sync_s"]),
                                      ("fleet-b", cfg["sync_s"]))}

            def train(job):
                try:
                    runs[job] = _fleet_job_run(taps[job], img, device, epochs, local_digests,
                                               f"a {job}")
                except BaseException as exc:  # fail() in a thread raises SystemExit
                    errors.append((job, exc))
                finally:
                    taps[job].after_epoch.set()

            # From the warm epochs on, the second worker's sends are slowed
            # (the slow-peer failpoint, keyed to it): steals move its pieces
            # to the first worker, which serves them from its peer.
            slow = failpoints.FaultSchedule(
                cfg["seed"], points=["slow-peer"], delay_s=cfg["a_slow_s"],
                targets={"slow-peer": workers[1].worker_id},
                fires={"slow-peer": {i: "delay" for i in range(100_000)}})
            with service.JobHandle(disp.address, "fleet-a", weight=jobs["fleet-a"]), \
                    service.JobHandle(disp.address, "fleet-b", weight=jobs["fleet-b"]):
                first = threading.Thread(target=train, args=("fleet-a",))
                first.start()
                # fleet-b starts once fleet-a's cold epoch filled the cache.
                taps["fleet-a"].after_epoch.wait(timeout=300)
                taps["fleet-a"]._source._dynamic_sync_interval_s = cfg["sync_s"]
                with failpoints.armed(slow):
                    second = threading.Thread(target=train, args=("fleet-b",))
                    second.start()
                    first.join()
                    second.join()
                stats = [w.cache_stats() for w in workers]
                by_job = [w.cache_stats_by_job() for w in workers]
        finally:
            _stop_fleet(disp, workers)
        if errors:
            fail(f"fleet (a): {errors}")
        cold = sum(s["misses"] for s in stats)
        remote = sum(s["remote_hits"] for s in stats)
        if cold != pieces:
            fail(f"fleet (a): the fleet decoded {cold} pieces for two jobs of {epochs} epochs "
                 f"over {pieces} pieces (want {pieces}: each once); lookups by job {by_job}")
        if not remote > 0:
            fail(f"fleet (a): no remote warm serve between the workers: {stats}")
        delivered = {job: len(taps[job].ids) for job in jobs}
        job_rows = {job: FLEET_JOB_ROWS.labels(job).value - rows0[job] for job in jobs}
        if job_rows != delivered:
            fail(f"fleet (a): petastorm_fleet_job_rows_total {job_rows}, rows delivered "
                 f"{delivered}")
        if not scales["fleet-a"] or set(scales["fleet-a"]) != {1.0} \
                or 0.5 not in scales["fleet-b"] or not set(scales["fleet-b"]) <= {0.5, 1.0}:
            fail(f"fleet (a): plan credit scales {scales} (want fleet-a's 1.0, fleet-b's "
                 "0.5 while fleet-a has a backlog)")
        rates = {job: runs[job]["images_per_s"] for job in jobs}
        t_parts["a"] = time.perf_counter() - t0
        figures.append(
            f"(a) 2 jobs x {epochs} epochs on {device} (weights {jobs['fleet-a']:g}:"
            f"{jobs['fleet-b']:g}, dynamic, 2 fleet-cache workers {tag}): images_per_s "
            f"fleet-a={rates['fleet-a']:.1f} fleet-b={rates['fleet-b']:.1f} "
            f"ratio={rates['fleet-a'] / rates['fleet-b']:.3f} (phase 4 alone "
            f"{image['images_per_s']:.1f}); cold decodes {cold} of {pieces} pieces; "
            f"remote warm serves {remote}; plan credit_scale {scales}; lookups by job "
            f"{by_job}; job rows {job_rows}; loss quarters "
            + " ".join(f"{job}={r['quarters'][0]:.4f}->{r['quarters'][1]:.4f}"
                       for job, r in runs.items()))

        # (b) The autoscaler over the CLI: the streak planner, then the model's.
        t0 = time.perf_counter()
        arms = {planner: _fleet_cli_arm(service, url, cfg, img, device, local_digests, tmp,
                                        planner)
                for planner in ("streak", "model")}
        t_parts["b"] = time.perf_counter() - t0
        streak, model = arms["streak"], arms["model"]
        figures.append(
            f"(b) streak: autoscale {streak['autoscale']} (equal after a journal restart, "
            f"{streak['restart_handoffs']} hand-off(s)), hand-off {streak['handoff']}, the "
            f"next job's {cfg['b_epochs']} epochs on {streak['survivor']} decoded 0 "
            f"({streak['hits']} hits), images_per_s job1={streak['job1_images_per_s']:.1f} "
            f"job2={streak['job2_images_per_s']:.1f}; model: {model['fleet_plans']} "
            f"fleet_plan(s), last {model['last_plan']}, autoscale after a journal restart "
            f"{model['restart_autoscale']}, images_per_s {model['job1_images_per_s']:.1f}")

        # (c) Chaos on one job's epochs: a worker killed, a job cancelled, a
        # worker drained (at least once); then a dispatcher restart alone
        # (exactly once, and the stream a clean run's).
        t0 = time.perf_counter()
        epochs = cfg["c_epochs"]
        disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                       cfg["workers_count"], workers=cfg["c_workers"],
                                       tag="fleet-c",
                                       dispatcher=service.Dispatcher(
                                           mode="dynamic", num_epochs=epochs,
                                           shuffle_seed=cfg["seed"]).start(),
                                       batch_delay_s=cfg["c_delay_s"])
        try:
            with service.JobHandle(disp.address, "fleet-c"):
                tap = _FleetTap(service.ServiceBatchSource(
                    disp.address, job_id="fleet-c", credits=cfg["credits"],
                    dynamic_sync_interval_s=cfg["sync_s"]), per_epoch)
                injector = chaos.ChaosInjector(
                    [("worker-kill", chaos.worker_kill_action(workers, min_survivors=2)),
                     ("job-cancel", chaos.job_cancel_action(lambda: disp.address)),
                     ("worker-drain", chaos.worker_drain_action(lambda: disp, min_serving=1))],
                    interval_s=cfg["c_interval_s"], initial_delay_s=0.0, seed=cfg["c_seed"])
                with _chaos_from_mark(tap, injector):
                    _fleet_job_run(tap, img, device, epochs, local_digests, "c chaos")
        finally:
            _stop_fleet(disp, workers)
        faults = chaos.delivery_invariants(local_ids * epochs, tap.ids, allow_duplicates=True)
        events = [label for _, label in injector.events]
        if not faults["ok"] or injector.errors or not events:
            fail(f"fleet (c) chaos: {faults}, events {events}, errors {injector.errors}")
        taps = {}
        for arm in ("clean", "restart"):
            journal = os.path.join(tmp, f"journal-c-{arm}")

            def factory(host, port, journal=journal):
                return service.Dispatcher(host=host, port=port, mode="dynamic",
                                          num_epochs=epochs, shuffle_seed=cfg["seed"],
                                          journal_dir=journal)

            holder = [factory("127.0.0.1", 0).start()]
            disp, workers = _service_fleet(service, url, cfg, "row", img["batch"],
                                           cfg["workers_count"], tag=f"fleet-c-{arm}",
                                           dispatcher=holder[0],
                                           batch_delay_s=cfg["c_delay_s"])
            try:
                taps[arm] = _FleetTap(service.ServiceBatchSource(
                    disp.address, credits=cfg["credits"], ordered=True,
                    dynamic_sync_interval_s=cfg["sync_s"], heartbeat_interval_s=0.25),
                    per_epoch, mark=cfg["c_restart_after"] * img["batch"])
                with contextlib.ExitStack() as stack:
                    if arm == "restart":
                        restarts = stack.enter_context(_chaos_from_mark(
                            taps[arm], chaos.ChaosInjector(
                                [("dispatcher-restart",
                                  chaos.dispatcher_restart_action(holder, factory))],
                                initial_delay_s=0.0, max_events=1)))
                    _fleet_job_run(taps[arm], img, device, epochs, local_digests, f"c {arm}")
                replays = holder[0].state_snapshot()["recovery"]["journal_replays"]
            finally:
                for worker in workers:
                    worker.stop()
                holder[0].stop()
        restart_faults = chaos.delivery_invariants(local_ids * epochs, taps["restart"].ids,
                                                   allow_duplicates=False)
        if not restart_faults["ok"] or restarts.errors or len(restarts.events) != 1 \
                or replays < 1:
            fail(f"fleet (c) restart: {restart_faults}, events {restarts.events}, errors "
                 f"{restarts.errors}, journal replays {replays}")
        digest = taps["restart"].stream.hexdigest()
        if digest != taps["clean"].stream.hexdigest():
            fail("fleet (c) restart: the stream digest differs from the clean run's")
        t_parts["c"] = time.perf_counter() - t0
        figures.append(
            f"(c) chaos (seed {cfg['c_seed']}, {cfg['c_workers']} workers, {epochs} epochs) "
            f"events {events} -> {faults}; a dispatcher restart alone after "
            f"{cfg['c_restart_after']} batches -> {restart_faults}, journal_replays {replays}, "
            f"stream digest {digest} equal to the clean run's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        fail(f"fleet: a flash kernel ran on the fleet's path: {launches}")
    if open_job_registrations():
        fail(f"fleet: job registrations left open: {open_job_registrations()}")
    print(f"fleet: gpu={smi!r} " + "; ".join(figures) + "; parts_s="
          + ",".join(f"{k}:{v:.1f}" for k, v in t_parts.items())
          + f" flash_launches={launches}", flush=True)
    return {"images_per_s": rates}


class _LlmTap:
    """Phase 19's batch source tap: every batch as the source yielded it
    (host arrays), in order; every other attribute is the source's, so the
    autotuner's graph binds the source's knobs through the tap."""

    def __init__(self, source):
        self._source = source
        self.batches = []

    def __call__(self):
        return _LlmTapIterator(self._source(), self.batches)

    def __getattr__(self, name):
        return getattr(self._source, name)


class _LlmTapIterator:
    def __init__(self, inner, sink):
        self._inner, self._sink = inner, sink
        self.prefetched = getattr(inner, "prefetched", False)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._inner)
        self._sink.append(dict(batch))
        return batch

    def close(self):
        close = getattr(self._inner, "close", None)
        if callable(close):
            close()


def _llm_sequences(batches):
    """The sorted multiset of the documents in packed batches."""
    from petastorm_tpu_torch.torch_utils.packing import unpack

    return sorted(tuple(int(x) for x in seq) for batch in batches
                  for seq in unpack(batch, "tokens"))


def _llm_digest(batches):
    """One blake2b over every array of every batch, in order."""
    import hashlib

    import numpy as np

    h = hashlib.blake2b(digest_size=16)
    for batch in batches:
        for key in sorted(batch):
            arr = np.ascontiguousarray(np.asarray(batch[key]))
            h.update(key.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _llm_fill(batches, cfg):
    """Real tokens over the slots' capacity, over all ``batches``."""
    from petastorm_tpu_torch.service.packing_stage import packed_token_count

    tokens = sum(packed_token_count(b) for b in batches)
    return tokens / max(1, len(batches) * cfg["slots"] * cfg["slot_len"])


def _llm_model(cfg, device):
    from petastorm_tpu_torch.models.long_context_lm import init_lm_params, make_lm_train_step

    model = init_lm_params(0, d_model=cfg["d_model"], num_heads=cfg["heads"],
                           slot_len=cfg["slot_len"], device=device)
    return make_lm_train_step(model)


def _llm_pass(loader, step, tap, device, warm_from):
    """One pass of ``loader`` through the LM's SGD ``step``: the losses,
    the warm steps/s and real tokens/s (from a sync before step
    ``warm_from`` to one after the last step; None for a shorter pass),
    the devices the batches arrived on and the loader's diagnostics."""
    import torch

    from petastorm_tpu_torch.service.packing_stage import packed_token_count
    from petastorm_tpu_torch.torch_utils.packing import PACK_POSITION_KEY, PACK_SEGMENT_KEY

    first = len(tap.batches)
    losses, devices, t_warm = [], set(), None
    with loader:
        for packed in loader:
            if len(losses) == warm_from:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t_warm = time.perf_counter()
            devices.update(str(t.device) for t in packed.values() if torch.is_tensor(t))
            losses.append(step(packed["tokens"], packed[PACK_POSITION_KEY],
                               packed[PACK_SEGMENT_KEY]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        diagnostics = loader.diagnostics
    losses = [float(x) for x in losses]
    warm = len(losses) - warm_from
    tokens = sum(packed_token_count(b) for b in tap.batches[first + warm_from:])
    return {"losses": losses, "devices": devices, "diagnostics": diagnostics,
            "steps_per_s_warm": warm / (t_end - t_warm) if t_warm and warm > 0 else None,
            "tokens_per_s_warm": tokens / (t_end - t_warm) if t_warm and warm > 0 else None}


def _llm_workers(service, urls, disp, cfg, tag):
    """One started worker a ``(url, corpus)`` on ``disp``."""
    workers = []
    try:
        for i, (url, corpus) in enumerate(urls):
            workers.append(service.BatchWorker(
                url, dispatcher_address=disp.address, batch_size=cfg["batch"],
                reader_factory="row", corpus=corpus, worker_id=f"llm-{tag}-{i}",
                reader_kwargs={"workers_count": cfg["workers_count"]}).start())
    except BaseException:
        _stop_fleet(disp, workers)
        raise
    return workers


def llm_phase(smi, cfg=None, device="cuda"):
    """Phase 19 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a dry run on the host; the run on the
    card uses the defaults."""
    import torch

    from petastorm_tpu_torch import service
    from petastorm_tpu_torch.models.long_context_lm import corpus_rows, generate_corpus
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.pipeline.graph import build_loader_graph
    from petastorm_tpu_torch.reader.reader import make_columnar_reader
    from petastorm_tpu_torch.service.fleet import open_job_registrations
    from petastorm_tpu_torch.service.mixture import open_mixture_passes
    from petastorm_tpu_torch.service.shm_ring import live_shm_counts
    from petastorm_tpu_torch.telemetry.metrics import PACKING_FILL_RATIO
    from petastorm_tpu_torch.torch_utils.loader import TorchDataLoader
    from petastorm_tpu_torch.torch_utils.packing import make_packed_torch_dataloader

    cfg = cfg or LLM
    device = torch.device(device)
    on_card = "cuda:0" if device.type == "cuda" else "cpu"
    warm_from = cfg["warm_from"]
    spec = service.PackingSpec(slot_len=cfg["slot_len"], slots=cfg["slots"],
                               sequence_fields=["tokens"], length_field="length")
    seed_a, seed_b = cfg["corpus_seeds"]
    documents = sorted(tuple(int(x) for x in row["tokens"][:row["length"]])
                       for row in corpus_rows(cfg["docs"], cfg["max_len"], seed_a))
    figures, t_parts, launches = [], {}, {}
    shm_before = live_shm_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_llm_")
    try:
        url = generate_corpus(f"file://{tmp}/corpus", cfg["docs"], cfg["max_len"], seed=seed_a)

        # (a) Worker-placed packing feeds the LM for 2 epochs; the other
        # placements' multisets; a second run's digest.
        t0 = time.perf_counter()
        disp = service.Dispatcher(mode="static", num_epochs=cfg["epochs"],
                                  shuffle_seed=cfg["seed"]).start()
        workers = _llm_workers(service, [(url, "")] * cfg["workers"], disp, cfg, "a")
        try:
            tap = _LlmTap(service.ServiceBatchSource(disp.address, packing=spec, ordered=True))
            loader = TorchDataLoader(None, batch_source=tap, device=device)
            fa.reset_launch_counts()
            run = _llm_pass(loader, _llm_model(cfg, device), tap, device, warm_from)
            launches = dict(fa.LAUNCHES)
            fill_gauge = {"worker": PACKING_FILL_RATIO.labels("worker").value}
            full = tap.batches
            starts = [count for count, _ in tap.diagnostics["epoch_starts"]]
            again = list(service.ServiceBatchSource(disp.address, packing=spec, ordered=True)())
            trainer = list(service.PackedBatchSource(
                service.ServiceBatchSource(disp.address, ordered=True), spec,
                placement="trainer")())
            fill_gauge["trainer"] = PACKING_FILL_RATIO.labels("trainer").value
            with make_columnar_reader(url, num_epochs=1, shuffle_row_groups=False,
                                      workers_count=1) as reader:
                local = [{k: v.cpu().numpy() for k, v in batch.items()}
                         for batch in make_packed_torch_dataloader(
                             reader, cfg["slot_len"], cfg["slots"], ["tokens"],
                             length_field="length", device=device)]
            t_parts["a"] = time.perf_counter() - t0

            # (b) Resume in the middle of a pack: cut after k packed batches,
            # rebuild the source from its state, continue.
            t0 = time.perf_counter()
            n = len(full)
            cuts = [k if k > 0 else n + k for k in cfg["cuts"]]
            resumed_ok = {}
            for k in cuts:
                source = service.ServiceBatchSource(disp.address, packing=spec, ordered=True)
                it = source()
                got = [next(it) for _ in range(k)]
                state = source.state_dict(yielded_batches=k)
                it.close()
                got += list(service.ServiceBatchSource(disp.address, packing=spec,
                                                       ordered=True, resume_state=state)())
                resumed_ok[k] = len(got) == n and _llm_digest(got) == _llm_digest(full)
            other = service.PackingSpec(slot_len=cfg["slot_len"] // 2, slots=cfg["slots"] * 2,
                                        sequence_fields=["tokens"], length_field="length")
            try:
                service.ServiceBatchSource(disp.address, packing=other, ordered=True,
                                           resume_state=state)
                refusal = None
            except ValueError as exc:
                refusal = str(exc)
            t_parts["b"] = time.perf_counter() - t0
        finally:
            _stop_fleet(disp, workers)
        # The source records the next epoch's start when an epoch ends.
        starts = [count for count in starts if count < n]
        bounds = starts + [n]
        per_epoch = [_llm_sequences(full[lo:hi]) == documents
                     for lo, hi in zip(bounds, bounds[1:])]
        losses = run["losses"]
        first, last = quarter_means(losses)
        if len(starts) != cfg["epochs"] or not all(per_epoch):
            fail(f"llm (a): an epoch's documents differ from the corpus's (epoch starts "
                 f"{starts} of {n} batches, equal {per_epoch})")
        if _llm_sequences(trainer) != sorted(documents * cfg["epochs"]) \
                or _llm_sequences(local) != documents:
            fail("llm (a): the trainer placement's or make_packed_torch_dataloader's "
                 "documents differ from the corpus's")
        if _llm_digest(again) != _llm_digest(full):
            fail("llm (a): a second worker-placed run's stream digest differs")
        if run["devices"] != {on_card} or not all(math.isfinite(x) for x in losses) \
                or not last < first:
            fail(f"llm (a): batches on {sorted(run['devices'])}, loss quarters "
                 f"{first:.4f} -> {last:.4f}")
        if device.type == "cuda" and min(launches.values()) < 1:
            # (On the host the wrappers run their plain versions: nothing launches.)
            fail(f"llm (a): a flash kernel was not launched on the LLM path: {launches}")
        if not all(resumed_ok.values()):
            fail(f"llm (b): a resume mid-pack is not the uninterrupted stream: {resumed_ok}")
        if refusal is None or "packing mismatch" not in refusal:
            fail(f"llm (b): a resume under another spec was not refused: {refusal!r}")
        fills = {"worker": _llm_fill(full, cfg), "trainer": _llm_fill(trainer, cfg),
                 "local": _llm_fill(local, cfg)}
        figures.append(
            f"(a) LM d_model {cfg['d_model']} x {cfg['heads']} heads, slot_len "
            f"{cfg['slot_len']} x {cfg['slots']} slots on {on_card}, {cfg['epochs']} epochs "
            f"of {cfg['docs']} documents from {cfg['workers']} worker-packing workers: "
            f"{n} steps, steps_per_s_warm={run['steps_per_s_warm']:.2f} (from step "
            f"{warm_from}), real_tokens_per_s_warm={run['tokens_per_s_warm']:.0f}, "
            f"input_stall_pct={run['diagnostics'].get('input_stall_pct')}, loss quarters "
            f"{first:.4f} -> {last:.4f}; fill worker={fills['worker']:.4f} trainer="
            f"{fills['trainer']:.4f} local={fills['local']:.4f} (petastorm_packing_fill_ratio "
            f"worker={fill_gauge['worker']} trainer={fill_gauge['trainer']}); batches worker="
            f"{n} trainer={len(trainer)} local={len(local)}; every epoch's documents the "
            f"corpus's, trainer and local multisets equal, second run digest equal; "
            f"flash launches {launches}")
        figures.append(f"(b) resumes after {cuts} packed batches bit-equal; another spec "
                       f"refused ({refusal.split(':')[0]})")

        # (c) A mixture of the corpus written with two seeds over one
        # journaled dispatcher, a weight change journaled before pass 2.
        t0 = time.perf_counter()
        url_b = generate_corpus(f"file://{tmp}/corpus_b", cfg["docs"], cfg["max_len"],
                                seed=seed_b)
        journal = os.path.join(tmp, "journal-c")
        w0, w1 = cfg["weights"]
        disp = service.Dispatcher(mode="static", num_epochs=1, shuffle_seed=cfg["seed"],
                                  journal_dir=journal).start()
        workers = _llm_workers(service, [(url, "a"), (url_b, "b")], disp, cfg, "c")

        def mixture(address):
            def factory(corpus):
                return lambda: service.ServiceBatchSource(address, corpus=corpus,
                                                          ordered=True, packing=spec)
            return service.MixedBatchSource({"a": factory("a"), "b": factory("b")},
                                            weights=w0, seed=cfg["mix_seed"],
                                            exhaustion="stop", dispatcher_address=address,
                                            factories=True)

        try:
            mix = mixture(disp.address)
            tap_c = _LlmTap(mix)
            loader = TorchDataLoader(None, batch_source=tap_c, device=device)
            step = _llm_model(cfg, device)
            mix_losses, draws, passes = [], [], []
            for pass_index in range(2):
                if pass_index == 1:
                    reply = service.set_mixture_weights(disp.address, w1, effective_epoch=1)
                mixed = _llm_pass(loader, step, tap_c, device, warm_from)
                mix_losses += mixed["losses"]
                draws.append(dict(mix.diagnostics["mixture"]["draws"]))
                passes.append(mixed)
            weights_after = mix.diagnostics["mixture"]["weights"]
            replay = mixture(disp.address)
            replayed = list(replay()) + list(replay())
            log = service.get_mixture_weights(disp.address)["entries"]
        finally:
            _stop_fleet(disp, workers)
        restarted = service.Dispatcher(mode="static", num_epochs=1, shuffle_seed=cfg["seed"],
                                       journal_dir=journal).start()
        try:
            restored = service.get_mixture_weights(restarted.address)["entries"]
        finally:
            restarted.stop()
        shares = [{name: count / max(1, sum(d.values())) for name, count in d.items()}
                  for d in draws]
        # A pass of n draws under "stop" serves the seed tree's first n draws:
        # each share is within cfg["mix_tol"] of its weight, or within three
        # binomial standard errors of it for a pass too short for that band.
        tols, seeded = [], []
        for i, weights in enumerate((w0, w1)):
            n_draws = sum(draws[i].values())
            tols.append(max(cfg["mix_tol"], max(3 * math.sqrt(w * (1 - w) / max(1, n_draws))
                                                for w in weights.values())))
            sampler = service.MixtureSampler(cfg["mix_seed"], weights, epoch=i)
            seeded.append(dict(collections.Counter(sampler.draw() for _ in range(n_draws))))
        off = [abs(shares[i].get(name, 0.0) - weights[name])
               for i, weights in enumerate((w0, w1)) for name in weights]
        if any(abs(shares[i].get(name, 0.0) - weights[name]) > tols[i]
               for i, weights in enumerate((w0, w1)) for name in weights) \
                or seeded != draws or weights_after != w1 or reply["seq"] != 1:
            fail(f"llm (c): draws {draws} (shares {shares}, the seed tree's {seeded}) against "
                 f"weights {w0} then {w1} (tolerances {tols}); weights after pass 2 "
                 f"{weights_after}")
        if _llm_digest(replayed) != _llm_digest(tap_c.batches):
            fail("llm (c): a second run from the same seed and weight log differs")
        if restored != log or len(log) != 1:
            fail(f"llm (c): the restarted dispatcher's log {restored} is not {log}")
        if not all(math.isfinite(x) for x in mix_losses) \
                or any(p["devices"] != {on_card} for p in passes):
            fail(f"llm (c): losses {mix_losses}")
        t_parts["c"] = time.perf_counter() - t0
        figures.append(
            f"(c) mixture seed {cfg['mix_seed']} of corpora seeded {seed_a}/{seed_b} with "
            f"packing, weights {w0} then {w1} from pass 2 (seq {reply['seq']}): draws "
            f"{draws} (the seed tree's), shares "
            + " ".join("{" + ", ".join(f"{k}: {v:.3f}" for k, v in s.items()) + "}"
                       for s in shares)
            + f" (|share - weight| max {max(off):.3f}, tolerances "
            + "/".join(f"{t:.3f}" for t in tols)
            + f"), {len(mix_losses)} LM steps (loss {mix_losses[0]:.4f} -> "
            f"{mix_losses[-1]:.4f}, steps_per_s_warm "
            + "/".join(f"{p['steps_per_s_warm']:.2f}" if p["steps_per_s_warm"] else "n/a"
                       for p in passes)
            + f"); second run digest equal; journal restart log equal ({len(restored)} entry)")

        # (d) The pack stage and its knob in the loader's graph; an
        # autotuned run started at trainer placement (reported).
        t0 = time.perf_counter()
        disp = service.Dispatcher(mode="static", num_epochs=cfg["tune_epochs"],
                                  shuffle_seed=cfg["seed"]).start()
        workers = _llm_workers(service, [(url, "")] * cfg["workers"], disp, cfg, "d")
        try:
            declared = build_loader_graph(TorchDataLoader(
                None, batch_source=service.PackedBatchSource(
                    service.ServiceBatchSource(disp.address), spec, placement="worker"),
                device=device))
            pack = declared.node("pack")
            knob = declared.knobs.get("packing_placement")
            edges = [e for e in declared.edges if "pack" in e]
            packed = service.PackedBatchSource(service.ServiceBatchSource(disp.address), spec,
                                               placement="trainer")
            tap_d = _LlmTap(packed)
            loader = TorchDataLoader(None, batch_source=tap_d, device=device,
                                     autotune=dict(cfg["tune"]))
            with _window_classes() as classes:
                tuned = _llm_pass(loader, _llm_model(cfg, device), tap_d, device, warm_from)
            report = loader.autotune.report()
            running = loader.autotune.running
            knobs = sorted(loader.autotune.graph.knobs)
            placement_next = packed.packing_placement
        finally:
            _stop_fleet(disp, workers)
        if pack.placement != "worker" or knob is None \
                or tuple(knob.descriptor()["choices"]) != ("worker", "trainer") \
                or sorted(edges) != [("collate", "pack"), ("pack", "serialize")]:
            fail(f"llm (d): the graph declares pack {pack.placement}, knob {knob}, edges "
                 f"{edges}")
        if running or "packing_placement" not in knobs \
                or _llm_sequences(tap_d.batches) != sorted(documents * cfg["tune_epochs"]):
            fail(f"llm (d): controller running={running}, knobs {knobs}, or the tuned run's "
                 "documents differ from the corpus's")
        moves = [f"r{e['round']} {d['knob']} {d['from']}->{d['to']}"
                 for e in report["trail"] for d in e["decisions"]
                 if d["knob"] == "packing_placement"]
        t_parts["d"] = time.perf_counter() - t0
        figures.append(
            f"(d) graph: pack at {pack.placement}, edges {edges}, knob choices "
            f"{knob.descriptor()['choices']}; autotune {cfg['tune']} from trainer placement, "
            f"{cfg['tune_epochs']} epochs, {len(tuned['losses'])} steps, knobs {knobs}: "
            f"rounds={report['rounds']} classes: {_classes_text(classes)}; "
            f"packing_placement decisions: {'; '.join(moves) or 'none'} (next iteration: "
            f"{placement_next}); all decisions: {_trail_text(report) or 'none'}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if open_mixture_passes() or open_job_registrations():
        fail(f"llm: mixture passes ({open_mixture_passes()}) or job registrations "
             f"({open_job_registrations()}) left open")
    if live_shm_counts() != shm_before:
        fail(f"llm: shared memory left mapped: {live_shm_counts()} (was {shm_before})")
    print(f"llm: gpu={smi!r} " + "; ".join(figures) + "; parts_s="
          + ",".join(f"{k}:{v:.1f}" for k, v in t_parts.items()), flush=True)
    return {"launches": launches, "steps_per_s_warm": run["steps_per_s_warm"]}


def _bench_child(argv, out_path, err_path):
    """One phase-20 run: ``python argv`` (``["-m", module, *args]`` or
    ``["-c", code]``) from the checkout's root, its stdout and stderr into
    files, its exit code the run's."""
    import runpy
    import traceback

    os.chdir(REPO)
    with open(out_path, "w") as out, open(err_path, "w") as err:
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
    code = 0
    try:
        if argv[0] == "-m":
            sys.argv = argv[1:]
            runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
        else:
            sys.argv = ["-c"]
            exec(compile(argv[1], "<string>", "exec"), {"__name__": "__main__"})
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else int(exc.code is not None)
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # the run's own threads end with it


def _bench_run(ctx, label, argv, timeout_s):
    """Run ``python argv`` as its own process, forked from ``ctx``'s server;
    ``(last stdout line, seconds)``, or fail the run on a non-zero exit, no
    exit in ``timeout_s`` or no output."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_bench_run_")
    out_path, err_path = os.path.join(out_dir, "out"), os.path.join(out_dir, "err")
    try:
        t0 = time.perf_counter()
        proc = ctx.Process(target=_bench_child, args=(argv, out_path, err_path),
                           name=f"bench-{label}")
        proc.start()
        proc.join(timeout_s)
        seconds = time.perf_counter() - t0
        if proc.is_alive():
            proc.kill()
            proc.join()
            fail(f"bench ({label}): no exit within {timeout_s} s")
        with open(out_path) as f:
            stdout = f.read()
        with open(err_path) as f:
            stderr = f.read()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    lines = stdout.strip().splitlines()
    if proc.exitcode != 0 or not lines:
        fail(f"bench ({label}): exit {proc.exitcode}, stdout {stdout[-400:]!r}, "
             f"stderr {stderr[-2000:]}")
    return lines[-1], seconds


def _bench_json(label, line):
    try:
        return json.loads(line)
    except ValueError:
        fail(f"bench ({label}): the last line is not JSON: {line[:300]!r}")


def bench_phase(smi, cfg=BENCH_RUNS, device="cuda"):
    """Phase 20 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a dry run on the host; the run on the
    card uses the defaults."""
    import re

    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec

    import multiprocessing

    # Every run is its own process, forked from a server that imported torch
    # and nothing else (no phase's state): on an H100 host importing torch
    # takes seconds a process, and the phase runs 14 of them.
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    t0 = time.perf_counter()
    warm = ctx.Process(target=os.getpid)
    warm.start()
    warm.join()
    server_s = time.perf_counter() - t0
    module = ["-m", "petastorm_tpu_torch.benchmark"]
    runs = []  # (label, seconds, last line's length, headline)

    def record(label, line, seconds, headline):
        runs.append((label, seconds, len(line), headline))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        # (a) reader_throughput through the loader onto the card.
        url = f"file://{tmp}/images"
        ic.generate_image_dataset(url, CompressedImageCodec(IMAGE_CODEC), rows=IMAGE["rows"],
                                  image_shape=IMAGE["image_shape"],
                                  num_classes=IMAGE["classes"],
                                  rows_per_row_group=IMAGE["rows_per_row_group"])
        line, seconds = _bench_run(ctx, "a", module + [
            url, "--torch-loader", "--torch-batch-size", str(cfg["batch"]), "-w",
            str(cfg["warmup"]), "-m", str(cfg["measure"]), "--device", device],
            cfg["timeout_s"])
        got = re.fullmatch(r"([\d.]+) rows/sec \((\d+) rows in ([\d.]+)s, "
                           r"input_stall=([\d.]+)%\)", line)
        if got is None or int(got.group(2)) != cfg["measure"] * cfg["batch"]:
            fail(f"bench (a): not {cfg['measure']} batches of {cfg['batch']} rows with a "
                 f"stall: {line!r}")
        record("a throughput --torch-loader", line, seconds,
               f"rows_per_s={got.group(1)} rows={got.group(2)} "
               f"input_stall_pct={got.group(4)}")

        # (b) the seven scenarios at the JAX defaults.
        frames, window, per_group = 2_000, 5, 256
        windows = sum(max(0, min(per_group, frames - start) - window + 1)
                      for start in range(0, frames, per_group))
        want = {
            "tabular": {"rows": 40_000, "full_scan_rowgroups": 8, "pushdown_rowgroups": 1},
            "ngram": {"frames": frames, "windows": windows},
            "image": {"rows": 1_024, "loader_batches": 8, "device_stage": "on"},
            "weighted": {"rows_drawn": 4_096},
            "converter_mixing": {"batches": 24, "rows_drawn": 24 * 256},
            "packed": {"docs": 2_048},
            "service": {"rows": 40_000, "duplicates_dropped": 0},
        }
        headline = {
            "tabular": ("full_scan_rows_per_sec", "pushdown_rows_per_sec",
                        "rowgroups_pruned_pct"),
            "ngram": ("windows", "windows_per_sec"),
            "image": ("row_decode_images_per_sec", "columnar_decode_images_per_sec",
                      "loader_input_stall_pct", "device_stage_images_per_sec",
                      "device_stage_input_stall_pct", "dispatch_overlap_pct",
                      "h2d_bytes_per_image"),
            "weighted": ("rows_per_sec", "empirical_mix"),
            "converter_mixing": ("rows_per_sec", "empirical_mix"),
            "packed": ("tokens_per_sec", "batches", "packed_utilization",
                       "padded_utilization"),
            "service": ("service_rows_per_sec", "local_rows_per_sec", "vs_baseline",
                        "loader_input_stall_pct", "transport"),
        }
        for name, expected in want.items():
            extra = (["--device-stage", "on", "--device", device] if name == "image" else [])
            line, seconds = _bench_run(ctx, f"b {name}", module + ["scenario", name] + extra,
                                       cfg["timeout_s"])
            result = _bench_json(f"b {name}", line)
            wrong = {k: result.get(k) for k, v in expected.items() if result.get(k) != v}
            if wrong:
                fail(f"bench (b) {name}: {wrong} where {expected} was expected")
            if name == "image":
                image_bytes = IMAGE["image_shape"][0] * IMAGE["image_shape"][1] * 3
                h2d = result["h2d_bytes_per_image"]
                if device == "cuda" and not image_bytes <= h2d < 2 * image_bytes:
                    fail(f"bench (b) image: {h2d} H2D bytes per image, not uint8 staging")
            if name == "packed" and not (result["packed_utilization"]
                                         > result["padded_utilization"]):
                fail(f"bench (b) packed: packing did not beat padding: {result}")
            record(f"b {name}", line, seconds,
                   " ".join(f"{k}={result[k]}" for k in headline[name]))

        # (c) the ordered stream twice over TCP, once over shm.
        digests = []
        for i, transport in enumerate(("tcp", "tcp", "shm")):
            line, seconds = _bench_run(ctx, f"c {transport}", module + [
                "scenario", "service", "--shuffle-seed", str(cfg["seed"]), "--ordered",
                "--transport", transport], cfg["timeout_s"])
            result = _bench_json(f"c {transport}", line)
            if result["rows"] != 40_000 or result["transport"] != transport:
                fail(f"bench (c) {transport}: rows {result['rows']}, transport "
                     f"{result['transport']}")
            digests.append(result["stream_digest"])
            record(f"c{i + 1} service ordered {transport}", line, seconds,
                   f"service_rows_per_sec={result['service_rows_per_sec']} "
                   f"digest={result['stream_digest']}")
        if len(set(digests)) != 1:
            fail(f"bench (c): the ordered digests differ across runs or transports: {digests}")

        # (d) brownout armed, through the function (the CLI's worker count).
        line, seconds = _bench_run(ctx, "d brownout", ["-c", (
            "import json; from petastorm_tpu_torch.benchmark.scenarios import "
            "service_loopback_scenario as run; print(json.dumps(run(workers=3, "
            f"shuffle_seed={cfg['seed']}, ordered=True, brownout=True)))")],
            cfg["timeout_s"])
        result = _bench_json("d brownout", line)
        level = result["telemetry"]["registry"].get("petastorm_fleet_brownout_level", {})
        levels = [series["value"] for series in level.get("series", [])]
        if result["rows"] != 40_000 or result["stream_digest"] != digests[0] \
                or result["duplicates_dropped"] != 0:
            fail(f"bench (d): rows {result['rows']}, digest {result['stream_digest']} "
                 f"against (c)'s {digests[0]}")
        record("d service brownout", line, seconds,
               f"service_rows_per_sec={result['service_rows_per_sec']} "
               f"brownout_level={levels} digest=(c)'s")

        # (e) the device stage's scaling at the card's one device.
        line, seconds = _bench_run(ctx, "e scaling", ["-c", (
            "import json; from petastorm_tpu_torch.benchmark.device_scaling import "
            "measure_device_stage_scaling as m; "
            f"print(json.dumps(m(device_counts=(1,), device={device!r})))")],
            cfg["timeout_s"])
        result = _bench_json("e scaling", line)
        if result["device_platform"] != device or result["scaling"] != 1.0 \
                or not result["rows_per_sec"]["1"] > 0:
            fail(f"bench (e): {result}")
        record("e device_stage_scaling", line, seconds,
               f"rows_per_sec={result['rows_per_sec']['1']} decode_kernel_rows_per_sec="
               f"{result['decode_kernel_rows_per_sec']['1']} "
               f"platform={result['device_platform']}")

        # (f) one fuzz seed, replayed for determinism.
        line, seconds = _bench_run(ctx, "f fuzz", ["-c", (
            "import json; from petastorm_tpu_torch.service.fuzz import fuzz; "
            f"print(json.dumps(fuzz([{cfg['fuzz_seed']}], check_determinism=True)))")],
            cfg["timeout_s"])
        result = _bench_json("f fuzz", line)
        if result["failures"] or result["runs"] != 2:
            fail(f"bench (f): {result}")
        record("f fuzz", line, seconds, f"seeds={result['seeds']} runs={result['runs']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"bench: gpu={smi!r} fork server (imports torch) {server_s:.1f} s; " + "; ".join(
        f"({label}) {seconds:.1f} s, last line {length} chars: {headline}"
        for label, seconds, length, headline in runs), flush=True)
    return {label: {"seconds": seconds, "chars": length} for label, seconds, length, _ in runs}


def trainer_cases():
    """Kernel cases at the shapes and dtypes the sequence trainers (phases 5
    and 6) give the kernels, ``(name, case, dlse)``: B=16, H=4, D=8 windows
    of 5 frames, unmasked, bf16; ragged B=16 T=24 causal with
    ``kv_lengths``, bf16; packed B=4 T=48 causal with segment ids (-1
    padded tails), f32; and the sp = 2 ring's blocks of the last two (T=12
    and T=24, strict causal, per-block ``kv_lengths`` or a ``(q_ids,
    kv_ids)`` pair, with an lse cotangent)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(50)
    out = []
    frames = make_case(16, 5, 4, 8, torch.bfloat16, seed=51)
    frames[1]["causal"] = False
    out.append(("seq frames B=16 T=5 D=8 bf16", frames, None))
    for t, offset, tag in ((24, 0, "ragged B=16 T=24"), (12, -1, "ragged ring block B=16 T=12")):
        tensors, kw = make_case(16, t, 4, 8, torch.bfloat16, seed=52 + t)
        kw["causal_offset"] = offset
        kw["kv_lengths"] = torch.randint(0, t + 1, (16,), device="cuda", generator=g).int()
        dlse = torch.randn(16 * 4, t, device="cuda", generator=g) if offset else None
        out.append((f"seq {tag} causal+kv_lengths D=8 bf16", (tensors, kw), dlse))
    out.append(("seq packed B=4 T=48 causal+seg D=8 f32",
                make_case(4, 48, 4, 8, torch.float32, seg="tail_pad", seed=54), None))
    tensors, kw = make_case(4, 24, 4, 8, torch.float32, seg="tail_pad", seed=55)
    kw["causal_offset"] = -1
    kw["kv_seg"] = kw["q_seg"].flip(0).contiguous()  # another row's ids: a pair
    out.append(("seq packed ring block B=4 T=24 strict causal+seg pair D=8 f32", (tensors, kw),
                torch.randn(4 * 4, 24, device="cuda", generator=g)))
    return out


def _distribution_version(name):
    """The installed distribution's version, or ``absent``; the package is
    not imported."""
    from importlib import metadata

    for dist in (name, f"{name}-cpu", f"{name}-gpu"):
        try:
            return metadata.version(dist)
        except metadata.PackageNotFoundError:
            continue
    return "absent"


def adapters_phase(smi, cfg=ADAPTERS, device="cuda"):
    """Phase 21 (see the module docstring); fails the run on any check.
    ``cfg`` and ``device`` exist for a dry run on the host; the run on the
    card uses the defaults."""
    import importlib.util
    import uuid

    import fsspec
    import numpy as np
    import torch

    from petastorm_tpu_torch.etl.metadata import materialize_rows
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader
    from petastorm_tpu_torch.torch_utils.sharding import global_step_count

    t_start = time.perf_counter()
    on_card = "cuda:0" if torch.device(device).type == "cuda" else "cpu"
    group, parts, batch = cfg["rows_per_row_group"], list(cfg["parts"]), cfg["batch"]
    schema = Unischema("AdaptersSchema", [
        UnischemaField("idx", np.int64, (), ScalarCodec(), False),
        UnischemaField("part", np.int64, (), ScalarCodec(), False),
        UnischemaField("vec", np.float32, (cfg["width"],), NdarrayCodec(), False)])
    vecs = np.random.RandomState(cfg["seed"]).rand(cfg["rows"], cfg["width"]).astype(np.float32)
    memory = fsspec.filesystem("memory")
    base = f"/chip-smoke-adapters-{uuid.uuid4().hex[:8]}"
    url, opts = f"memory://{base}/store", {"skip_instance_cache": False}
    want = sorted(i for i in range(cfg["rows"]) if i // group in parts)

    def selected_reader():
        return make_reader(url, schema_fields=["idx", "vec"], storage_options=opts,
                           rowgroup_selector=SingleIndexSelector("by_part", parts),
                           shuffle_row_groups=False, workers_count=2, num_epochs=1)

    try:
        t0 = time.perf_counter()
        materialize_rows(url, schema, ({"idx": i, "part": i // group, "vec": vecs[i]}
                                       for i in range(cfg["rows"])),
                         rows_per_row_group=group, storage_options=opts)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = build_rowgroup_index(url, [SingleFieldIndexer("by_part", "part")],
                                     storage_options=opts)
        index_s = time.perf_counter() - t0
        if index["by_part"].get_row_group_indexes(parts[0]) != {parts[0]}:
            fail(f"adapters: the index maps part {parts[0]} to "
                 f"{index['by_part'].get_row_group_indexes(parts[0])}")
        steps = global_step_count(url, batch, 1, filters=[("part", "in", parts)],
                                  storage_options=opts)
        t0 = time.perf_counter()
        got_idx, got_vec, devices = [], [], set()
        with selected_reader() as reader:
            for b in make_torch_dataloader(reader, batch, device=device):
                devices.add(str(b["idx"].device))
                got_idx.append(b["idx"].cpu())
                got_vec.append(b["vec"].cpu())
        loader_s = time.perf_counter() - t0
        got_idx, got_vec = torch.cat(got_idx).numpy(), torch.cat(got_vec).numpy()
        if devices != {on_card}:
            fail(f"adapters: batches arrived on {sorted(devices)}, not {on_card}")
        if sorted(got_idx.tolist()) != want:
            fail(f"adapters: the card got {len(got_idx)} rows, not the selector's {len(want)} "
                 f"(parts {parts})")
        if not np.array_equal(got_vec, vecs[got_idx]):
            fail("adapters: the vectors on the card differ from the rows written")
        if steps != len(want) // batch or len(got_idx) // batch != steps:
            fail(f"adapters: global_step_count gives {steps}, the loader "
                 f"{len(got_idx) // batch} batches of {batch}")
        if importlib.util.find_spec("tensorflow") is None:
            tf_note = "tf: not run, tensorflow not installed on this host"
        else:
            import tensorflow as tf

            from petastorm_tpu_torch.tf_utils import make_petastorm_dataset

            tf.config.set_visible_devices([], "GPU")  # the card is the port's
            t0 = time.perf_counter()
            with selected_reader() as reader:
                rows = [(int(r.idx.numpy()), r.vec.numpy())
                        for r in make_petastorm_dataset(reader)]
            tf_idx = np.array([i for i, _ in rows])
            if sorted(tf_idx.tolist()) != want or not np.array_equal(
                    np.stack([v for _, v in rows]), vecs[tf_idx]):
                fail("adapters: make_petastorm_dataset gave other rows than the selector's")
            tf_note = (f"tf: {tf.__version__} make_petastorm_dataset {len(rows)} rows equal "
                       f"the selector's in {time.perf_counter() - t0:.2f}s")
    finally:
        if memory.exists(base):
            memory.rm(base, recursive=True)
    print(f"adapters: memory:// store rows={cfg['rows']} groups={cfg['rows'] // group} "
          f"write_s={write_s:.3f} index_build_s={index_s:.3f}; selector parts={parts} -> "
          f"{len(got_idx)} rows on {on_card} in {len(got_idx) // batch} batches of {batch} "
          f"(global_step_count={steps}) loader_s={loader_s:.3f}; {tf_note}; hdfs:// and "
          f"Spark: held by the CPU tests (no namenode or Spark here); "
          f"phase_s={time.perf_counter() - t_start:.2f} ({smi})", flush=True)
    return {"rows": len(got_idx), "steps": steps}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "petastorm_tpu_torch", "ops", "csrc")):
        fail(f"{REPO} holds no petastorm_tpu_torch package: run this script "
             "from the root of a checkout")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from petastorm_tpu_torch.models.long_context_lm import (
        WARM_FROM_STEP,
        generate_corpus,
        train_lm,
    )
    from petastorm_tpu_torch.ops import _build
    from petastorm_tpu_torch.ops import flash_attention as fa
    from petastorm_tpu_torch.ops.segment_layouts import SEGMENT_KINDS

    # -- 1. env ------------------------------------------------------------
    t_start = t_phase = time.perf_counter()
    phase_s = {}
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    try:
        nvcc = _build.find_nvcc()
        nvcc_version = sh([nvcc, "--version"]).splitlines()[-1]
    except RuntimeError as exc:
        fail(str(exc))
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    cutlass = os.path.isdir("/usr/local/cutlass/include/cutlass")
    try:
        import zmq
        pyzmq_version = f"{zmq.__version__} (libzmq {zmq.zmq_version()})"
    except ImportError:
        pyzmq_version = None
    try:
        import cloudpickle
        cloudpickle_version = cloudpickle.__version__
    except ImportError:
        cloudpickle_version = None
    tensorflow_version, pyspark_version = (_distribution_version(name)
                                           for name in ("tensorflow", "pyspark"))
    t0 = time.perf_counter()
    count_dir = tempfile.mkdtemp(prefix="chip_smoke_count_")
    counting = {  # kernel -> (source, switch, entry point)
        "fwd": ("flash_fwd.cu", "PTT_FWD_COUNT_TILES=1", "ptt_flash_fwd"),
        "dq": ("flash_bwd_dq.cu", "PTT_DQ_COUNT_TILES=1", "ptt_flash_bwd_dq"),
        "dkv": ("flash_bwd_dkv.cu", "PTT_DKV_COUNT_TILES=1", "ptt_flash_bwd_dkv"),
    }
    procs = {}
    try:
        for kernel, (src, define, _) in counting.items():
            so = os.path.join(count_dir, f"lib{kernel}_count.so")
            procs[kernel] = (so, _build.compile_source(src, so, defines=(define,)))
        _build.build_all()
    finally:
        outs = {kernel: proc.communicate()[0] for kernel, (_, proc) in procs.items()}
    count_libs = {}
    for kernel, (so, proc) in procs.items():
        src, _, symbol = counting[kernel]
        if proc.returncode != 0:
            fail(f"nvcc failed for the counting build of {src}:\n{outs[kernel].decode()}")
        count_libs[kernel] = (_build.load(so, symbol), _build.load(so, symbol + "_tile_counts"))
    shutil.rmtree(count_dir, ignore_errors=True)  # loaded: the mappings stay
    build_s = time.perf_counter() - t0
    print(f"env: gpu={smi!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"nvcc={nvcc_version!r} triton={triton_version} cutlass_headers={cutlass} "
          f"pyzmq={pyzmq_version} cloudpickle={cloudpickle_version} "
          f"tensorflow={tensorflow_version} pyspark={pyspark_version} "
          f"kernels_built_in_s={build_s:.2f}", flush=True)

    # -- 2. kernels ----------------------------------------------------------
    phase_s["env"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    B, T, H, D = BENCH["B"], BENCH["T"], BENCH["H"], BENCH["D"]
    cases = [
        ("bench causal+seg f32", make_case(B, T, H, D, torch.float32, seg=True)),
        ("bench causal bf16", make_case(B, T, H, D, torch.bfloat16)),
        ("bench causal gqa(hkv=2) f32", make_case(B, T, H, D, torch.float32, Hkv=2)),
        ("bench kv_lengths f32", make_case(B, T, H, D, torch.float32, lens=True)),
    ]
    for i, kind in enumerate(SEGMENT_KINDS):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            cases.append((f"T=1024 {kind} {tag}",
                          make_case(B, 1024, H, D, dtype, seg=kind, seed=i)))
    for d in (16, 32, 64):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            cases.append((f"D={d} T=512 tail_pad {tag}",
                          make_case(B, 512, H, d, dtype, seg="tail_pad", seed=d)))
    # Strict causal (causal_offset -1: the striped ring's blocks whose key
    # shard sits after the query shard) and the lse cotangent through the dQ
    # kernel (every ring backward carries one), at the ring's block shapes:
    # the LM's at sp = 2 (T=64, D=16) and the sequence family's (D=8, which
    # the kernels take zero-padded to 16, see ``kernel_layout``); and D=8 on
    # the tile-tripping ids.
    cases = [(name, case, None) for name, case in cases]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases.append((f"D=8 T=512 tail_pad {tag}",
                      make_case(B, 512, H, 8, dtype, seg="tail_pad", seed=8), None))
        for d in (16, 8):
            (tensors, kw) = make_case(LM["B"], LM["T"] // 2, LM["H"], d, dtype, seg=True,
                                      seed=30 + d)
            kw["causal_offset"] = -1
            g = torch.Generator(device="cuda").manual_seed(d)
            dlse = torch.randn(LM["B"] * LM["H"], LM["T"] // 2, device="cuda", generator=g)
            cases.append((f"D={d} T={LM['T'] // 2} strict causal+seg dlse {tag}",
                          (tensors, kw), dlse))
    (tensors, kw) = make_case(B, 1024, H, D, torch.float32, seg=True, seed=21)
    kw["causal_offset"] = -1
    cases.append(("T=1024 strict causal+seg f32", (tensors, kw), None))
    cases += trainer_cases()
    cases.append(("lm D=16 causal+seg f32", make_case(LM["B"], LM["T"], LM["H"], LM["D"],
                                                      torch.float32, seg=True), None))
    checked = [check_case(name, *kernel_layout(case), count_libs, dlse)
               for name, case, dlse in cases]
    errs = [line for line, _ in checked]
    max_err = checked[-1][1]  # the main path's shape: the LM case
    del cases
    timed = {}
    for label, shape in (("lm", LM), ("bench", BENCH)):
        timing, pairs, counts = measure(shape, count_libs)
        timed[label] = timing
        errs.append(
            f"| {label} causal+seg f32 {shape}: "
            + "; ".join(f"{n} ms={t['ms']:.4f} host_ms={t['host_ms']:.4f} "
                        f"plain_ms={t['plain_ms']:.4f} "
                        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})"
                        for n, t in timing.items())
            + f"; sdpa fwd ms={timing['fwd']['library_ms']:.4f} "
            f"sdpa bwd (dq+dk+dv) ms={timing['bwd']['library_ms']:.4f}; "
            f"visible pairs={pairs}; counted on the card: "
            + " ".join(f"{k}={v}" for k, v in counts.items()))
    sparse = sparse_sgd_case()
    errs.append(
        f"| sparse_sgd {len(CRITEO_CARDINALITIES)} x {SPARSE_SGD['rows']} x "
        f"{SPARSE_SGD['dim']} f32, batch {SPARSE_SGD['batch']}, Zipf({SPARSE_SGD['zipf']}): "
        f"bit-equal to plain, touched={sparse['rows_named']} of lookups={sparse['lookups']} "
        f"longest_run={sparse['longest_run']}; ms={sparse['ms']:.4f} "
        f"host_ms={sparse['host_ms']:.4f} plain_ms={sparse['plain_ms']:.4f} "
        f"bound_ms={sparse['bound_ms']:.4f} (bytes) "
        f"longest_run_alone_ms={sparse['longest_run_ms']:.4f}")
    errs.append(f"| timing batches still short of spin: {SPIN_SHORT}")
    print("kernels: " + "; ".join(errs), flush=True)

    # -- 3. train ------------------------------------------------------------
    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        url = f"file://{tmp}/corpus"
        generate_corpus(url)
        fa.reset_launch_counts()
        result = train_lm(url, slot_len=128, slots=4, steps=TRAIN_STEPS,
                          num_heads=4, d_model=64, epochs=8, device="cuda")
        launches = dict(fa.LAUNCHES)
        # The card's busy share in the warm window, from a trace of a second,
        # identical run: a packed batch is three int32 [4, 128] copies
        # (tokens, positions, segment ids) of 2,048 bytes each.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = train_lm(url, slot_len=128, slots=4, steps=TRAIN_STEPS,
                              num_heads=4, d_model=64, epochs=8, device="cuda")
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        lm_busy = device_busy_pct(trace, 4 * 128 * 4, WARM_FROM_STEP, copies_per_batch=3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = result["losses"]
    if len(losses) < TRAIN_STEPS:
        fail(f"trained {len(losses)} steps, expected {TRAIN_STEPS}")
    if result["batch_devices"] != ["cuda:0"]:
        fail(f"loader batches arrived on {result['batch_devices']}, not the card")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"loss not finite and falling: {losses}")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the training path: {launches}")
    if not result["logit_parity"] <= PARITY_TOL:
        fail(f"flash vs dense logits differ by {result['logit_parity']:.3e}")
    diag = result["diagnostics"]
    print(f"train: steps={len(losses)} losses={[round(x, 4) for x in losses]} "
          f"steps_per_s={result['steps_per_s']:.2f} "
          f"steps_per_s_warm={result['steps_per_s_warm']:.2f} (from step {WARM_FROM_STEP}) "
          f"traced_steps_per_s_warm={traced['steps_per_s_warm']:.2f} "
          f"device_busy_pct_traced={lm_busy} "
          f"input_stall_pct={diag['input_stall_pct']} h2d_bytes={diag['h2d_bytes']} "
          f"peak_mem_mb={result['peak_memory_bytes'] / 2**20:.1f} "
          f"logit_parity={result['logit_parity']:.2e} launches={launches}",
          flush=True)

    # -- 4. image ... 21. adapters ------------------------------------------
    phase_s["train"] = time.perf_counter() - t_phase
    out = {}
    for name, run in (("image", lambda: image_phase(smi)), ("seq", seq_phase),
                      ("sp", lambda: sp_phase(result["steps_per_s"])),
                      ("tabular", lambda: tabular_phase(smi)),
                      ("reader", lambda: reader_phase(smi)),
                      ("loader", lambda: loader_phase(smi, out["image"]["images_per_s"])),
                      ("etl", lambda: etl_phase(smi)),
                      ("pool", lambda: pool_phase(smi, out["image"])),
                      ("parallel", lambda: parallel_phase(smi)),
                      ("autotune", lambda: autotune_phase(smi)),
                      ("service", lambda: service_phase(smi, out["image"])),
                      ("control", lambda: control_phase(smi)),
                      ("dynamic", lambda: dynamic_phase(smi, out["image"], out["service"])),
                      ("dataplane", lambda: dataplane_phase(smi, out["image"],
                                                            out["service"])),
                      ("fleet", lambda: fleet_phase(smi, out["image"])),
                      ("llm", lambda: llm_phase(smi)),
                      ("bench", lambda: bench_phase(smi)),
                      ("adapters", lambda: adapters_phase(smi))):
        t_phase = time.perf_counter()
        out[name] = run()
        phase_s[name] = time.perf_counter() - t_phase
    print("phases: " + " ".join(f"{name}_s={sec:.1f}" for name, sec in phase_s.items())
          + f" total_s={time.perf_counter() - t_start:.1f}", flush=True)

    source = "petastorm_tpu_torch/ops/csrc/"
    replaces = {"fwd": "petastorm_tpu/ops/flash_attention.py:96",
                "dq": "petastorm_tpu/ops/flash_attention.py:522",
                "dkv": "petastorm_tpu/ops/flash_attention.py:593"}
    files = {"fwd": "flash_fwd.cu", "dq": "flash_bwd_dq.cu", "dkv": "flash_bwd_dkv.cu"}
    record = {"kernels": [
        {"name": f"flash_{name}", "route": "cuda", "source": source + files[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max_err[name], **timed["lm"][name]}
        for name in ("fwd", "dq", "dkv")],
        "backward": {"name": "flash_dq+flash_dkv", "launches": launches["dq"] + launches["dkv"],
                     **timed["lm"]["bwd"]},
        "sparse_sgd": {"name": "sparse_sgd", "route": "cuda", "source": source + "sparse_sgd.cu",
                       "replaces": None, "launches": out["tabular"]["sparse_sgd_launches"],
                       **sparse}}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
