"""NGram windows in the port against the JAX package: the port's
``make_reader(schema_fields=NGram(...))`` through its ``batch_iterator``
gives the same ``[B, T, ...]`` windows as the JAX ``make_reader`` through
``make_jax_dataloader`` on the same dataset (exact equality; one dummy pool
and no row-group shuffle on both sides, so the order is fixed)."""

import numpy as np
import pytest

from petastorm_tpu.benchmark.scenarios import make_ngram_dataset
from petastorm_tpu.jax_utils import make_jax_dataloader
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader.reader import make_columnar_reader as jax_make_columnar_reader
from petastorm_tpu.reader.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.models.sequence_training import generate_frames_dataset
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader.reader import make_columnar_reader, make_reader
from petastorm_tpu_torch.torch_utils.batcher import batch_iterator, collate_ngram_rows

FRAMES = 300  # two row groups of 256 and 44 frames


@pytest.fixture(scope="module")
def frames_url(tmp_path_factory):
    """The frames dataset with gaps in ``ts`` (each a window boundary under
    ``delta_threshold=1``), written by the JAX package."""
    url = f"file://{tmp_path_factory.mktemp('ngram')}/frames"
    make_ngram_dataset(url, frames=FRAMES, frame_shape=(4, 4, 1))
    return url


#: name -> (fields per offset, delta_threshold, timestamp_overlap)
SPECS = {
    "window5_all_fields": ({i: ["ts", "frame", "ego_speed"] for i in range(5)}, 1, True),
    "window3_no_overlap": ({i: ["ts", "frame", "ego_speed"] for i in range(3)}, 1, False),
    "fields_differ_per_offset": ({0: ["ts", "frame"], 1: ["ts", "ego_speed"],
                                  2: ["ts", "fr.*", "ego_speed"]}, 1, True),
    "negative_offsets_regex": ({-1: ["ts", "ego_.*"], 0: ["ts", "frame"]}, 5, True),
    "no_threshold": ({i: ["ts", "ego_speed"] for i in range(4)}, None, True),
}


def _ngram(cls, name):
    fields, delta, overlap = SPECS[name]
    return cls({k: list(v) for k, v in fields.items()}, delta_threshold=delta,
               timestamp_field="ts", timestamp_overlap=overlap)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_windows_match_the_jax_loader(frames_url, name):
    kw = dict(reader_pool_type="dummy", shuffle_row_groups=False, num_epochs=1)
    with make_reader(frames_url, schema_fields=_ngram(NGram, name), **kw) as reader:
        assert reader.ngram is not None
        got = list(batch_iterator(reader, 8, last_batch="keep"))
    with jax_make_reader(frames_url, schema_fields=_ngram(JaxNGram, name), **kw) as reader:
        with make_jax_dataloader(reader, 8, last_batch="keep",
                                 stage_to_device=False) as loader:
            want = [{k: np.asarray(v) for k, v in batch.items()} for batch in loader]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].shape == w[key].shape, key
            np.testing.assert_array_equal(g[key], w[key])


def test_windows_are_time_ordered_and_never_span_a_gap(frames_url):
    with make_reader(frames_url, schema_fields=_ngram(NGram, "window5_all_fields"),
                     reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        batches = list(batch_iterator(reader, 16, last_batch="keep"))
    ts = np.concatenate([b["ts"] for b in batches])
    assert ts.shape[1] == 5 and (np.diff(ts, axis=1) == 1).all()
    # windows stay inside a row group: 256 - 4 + 44 - 4 start positions
    assert len(ts) == 252 + 40
    assert batches[0]["frame"].shape == (16, 5, 4, 4, 1)


def test_port_frames_dataset_equals_the_jax_one(frames_url, tmp_path):
    url = f"file://{tmp_path}/frames"
    generate_frames_dataset(url, frames=FRAMES, frame_shape=(4, 4, 1))
    kw = dict(reader_pool_type="dummy", shuffle_row_groups=False)
    with make_reader(url, **kw) as mine, make_reader(frames_url, **kw) as theirs:
        for a, b in zip(mine, theirs, strict=True):
            for name in ("ts", "frame", "ego_speed"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_columnar_reader_refuses_ngram_as_jax_does(frames_url):
    with pytest.raises(ValueError) as jax_err:
        jax_make_columnar_reader(frames_url, schema_fields=_ngram(JaxNGram, "no_threshold"))
    with pytest.raises(ValueError) as port_err:
        make_columnar_reader(frames_url, schema_fields=_ngram(NGram, "no_threshold"))
    assert str(port_err.value) == str(jax_err.value)


def test_collate_ngram_rows_of_nothing_is_empty():
    assert collate_ngram_rows([]) == {}
