"""``chip_smoke.py`` phase 17 (a)'s cache accounting, on the CPU.

Each piece is looked up once a stream that names it reaches its worker, so
the hits are the warm pieces' plus the pieces that streams the client
re-opened after a break named again, and every piece misses once, in its
cold epoch. The counts are ints and compared exactly.
"""

import collections

import pytest

import chip_smoke

CFG = dict(chip_smoke.DATAPLANE, workers=2)
EPOCHS, PIECES = 4, 8
WARM = PIECES * (EPOCHS - 1)


@pytest.mark.parametrize("hits, misses, requested, holds", [
    (WARM, PIECES, PIECES * EPOCHS, True),            # no stream re-opened
    (WARM + 3, PIECES, PIECES * EPOCHS + 3, True),    # one re-opened, 3 pieces named again
    (WARM + 2, PIECES, PIECES * EPOCHS + 3, True),    # a retry that never reached its worker
    (WARM + 1, PIECES, PIECES * EPOCHS, False),       # a hit no stream asked for
    (WARM + 4, PIECES, PIECES * EPOCHS + 3, False),   # more hits than pieces named again
    (WARM - 1, PIECES + 1, PIECES * EPOCHS, False),   # a warm piece missed
    (WARM, PIECES + 1, PIECES * EPOCHS + 1, False),   # a piece decoded twice
])
def test_plane_check_counts_reopened_streams(hits, misses, requested, holds):
    counts = (EPOCHS * CFG["workers"], 0, hits, misses, None)
    if holds:
        chip_smoke._plane_check("a", "shm", counts, None, 1, CFG, EPOCHS, PIECES, requested)
    else:
        with pytest.raises(SystemExit):
            chip_smoke._plane_check("a", "shm", counts, None, 1, CFG, EPOCHS, PIECES,
                                    requested)


@pytest.mark.parametrize("seed", [1, 2])
def test_injected_detach_hits_equal_the_pieces_named_again(tmp_path, seed):
    """Workers in this process over shm with ``shm-detach`` armed: a stream
    the producer detaches from is re-opened on its worker, whose hits then
    rise by exactly the pieces the new stream named; delivery stays the
    local reader's, epoch by epoch."""
    import torch

    from petastorm_tpu_torch import failpoints, service
    from petastorm_tpu_torch.cache_impl import BatchCache
    from petastorm_tpu_torch.models import image_classifier as ic
    from petastorm_tpu_torch.reader.reader import make_reader
    from petastorm_tpu_torch.schema.codecs import CompressedImageCodec

    img = dict(chip_smoke.IMAGE, rows=PIECES * 32, rows_per_row_group=32,
               image_shape=(16, 16, 3), batch=32, crop=(12, 12), hidden=64, conv_features=8)
    cfg = dict(CFG, image=img, workers_count=2)
    url = f"file://{tmp_path}/images"
    ic.generate_image_dataset(url, CompressedImageCodec(chip_smoke.IMAGE_CODEC),
                              rows=img["rows"], image_shape=img["image_shape"],
                              num_classes=img["classes"],
                              rows_per_row_group=img["rows_per_row_group"])
    with make_reader(url, schema_fields=["image", "label"], num_epochs=1,
                     shuffle_row_groups=False, workers_count=1) as reader:
        local = collections.Counter(chip_smoke._image_digest(r.image, r.label)
                                    for r in reader)
    disp, workers = chip_smoke._service_fleet(
        service, url, cfg, "row", img["batch"], cfg["workers_count"], num_epochs=EPOCHS,
        tag=f"detach-{seed}", transport="auto",
        batch_cache=lambda: BatchCache(mem_budget_bytes=64 << 20))
    try:
        source = service.ServiceBatchSource(disp.address, credits=cfg["credits"],
                                            transport="auto")
        requested = chip_smoke._StreamRequests(source)
        with failpoints.armed(failpoints.FaultSchedule(seed, points=("shm-detach",))):
            chip_smoke._image_run(source, img, torch.device("cpu"), EPOCHS, local,
                                  "detach", phase="test")
        metrics = [w.diagnostics_snapshot()["metrics"] for w in workers]
        by_epoch = [w.cache_stats_by_epoch() for w in workers]
    finally:
        chip_smoke._stop_fleet(disp, workers)
    counts = chip_smoke._plane_fleet_counts(metrics, by_epoch)
    again = requested.pieces - PIECES * EPOCHS
    assert again >= 0
    assert counts[2:] == (WARM + again, PIECES, PIECES)
    chip_smoke._plane_check("a", "shm", counts, None, 1, cfg, EPOCHS, PIECES,
                            requested.pieces)
