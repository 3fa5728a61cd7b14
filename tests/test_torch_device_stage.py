"""The port's ``DeviceStage`` against the JAX package's, on the CPU.

- routing and errors as the JAX stage's (``tests/test_device_stage.py``);
- cast and normalize bit for bit against JAX's ``host_reference`` with
  crop and flip off, in float32 and bfloat16;
- crop and flip as exact selections against a numpy mirror of the port's
  recorded draws (the draws are the port's own, a counter-based stream
  keyed by (seed, step, field), not JAX's threefry: a declared divergence
  under the same determinism contract);
- through the loader, the same outputs across prefetch depths and fresh
  instances, fresh draws in epoch 2, and the stage's diagnostics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu.jax_utils import DeviceStage as JaxDeviceStage
from petastorm_tpu_torch.etl.metadata import materialize_rows
from petastorm_tpu_torch.reader.reader import make_reader
from petastorm_tpu_torch.schema.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.torch_utils.device_stage import DeviceStage
from petastorm_tpu_torch.torch_utils.loader import make_torch_dataloader

IMG_SHAPE = (16, 12, 3)


def _batch(n=8, seed=0, shape=IMG_SHAPE):
    rng = np.random.RandomState(seed)
    return {"id": np.arange(n, dtype=np.int64),
            "image": rng.randint(0, 256, (n,) + shape, dtype=np.uint8),
            "weight": rng.rand(n).astype(np.float32)}


def _apply(stage, raw, step):
    return stage.apply({k: torch.from_numpy(a) for k, a in raw.items()}, step)


def _bits(x):
    """The raw bits of a float tensor or array, for bit-for-bit equality."""
    if torch.is_tensor(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    return np.asarray(x).view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _mirror(stage, raw, step, mean=None, std=None):
    """Numpy mirror of the port's stage from its recorded draws (float32)."""
    out = {}
    for i, name in enumerate(sorted(raw)):
        x = raw[name]
        d = stage.draws(step, i, x.shape)
        crop = stage.describe()["crop"]
        imgs = []
        for j, img in enumerate(x):
            if crop is not None:
                r, c = d["offsets"][j]
                img = img[r:r + crop[0], c:c + crop[1]]
            if d["flips"] is not None and d["flips"][j]:
                img = img[:, ::-1]
            imgs.append(img)
        y = np.stack(imgs).astype(np.float32)
        if mean is not None:
            y = (y - np.float32(mean)) * (np.float32(1.0) / np.float32(std))
        out[name] = y
    return out


# --- routing --------------------------------------------------------------


def test_split_infers_uint8_image_fields():
    raw, rest = DeviceStage().split(_batch())
    assert set(raw) == {"image"} and set(rest) == {"id", "weight"}


def test_split_explicit_fields_and_missing_field_error():
    raw, _ = DeviceStage(image_fields=("image",)).split(_batch())
    assert set(raw) == {"image"}
    with pytest.raises(KeyError, match="absent"):
        DeviceStage(image_fields=("nope",)).split(_batch())


def test_split_names_dtype_problem_for_object_columns():
    batch = _batch()
    ragged = np.empty(8, dtype=object)
    for i in range(8):
        ragged[i] = np.zeros((i + 1, 3), np.uint8)
    batch["image"] = ragged
    with pytest.raises(TypeError, match="object dtype"):
        DeviceStage(image_fields=("image",)).split(batch)


def test_stage_validates_bad_configs():
    with pytest.raises(ValueError, match="non-zero"):
        DeviceStage(normalize=(0.0, 0.0))
    with pytest.raises(ValueError, match="positive"):
        DeviceStage(crop=(0, 4))
    with pytest.raises(ValueError, match="scalars or 1-D"):
        DeviceStage(normalize=(np.zeros((2, 2)), 1.0))
    with pytest.raises(ValueError, match="larger than image"):
        _apply(DeviceStage(crop=(20, 4)), {"image": _batch()["image"]}, 0)
    with pytest.raises(ValueError, match="rank 3"):
        _apply(DeviceStage(crop=(4, 4)), {"image": _batch()["image"][..., 0]}, 0)


def test_describe_matches_the_jax_stage():
    kwargs = dict(normalize=(127.5, 127.5), crop=(8, 6), flip=True, seed=3)
    assert DeviceStage(**kwargs).describe() == JaxDeviceStage(**kwargs).describe()
    assert DeviceStage(output_dtype=torch.bfloat16).describe()["output_dtype"] == "bfloat16"


# --- cast / normalize: bit for bit against JAX's host reference -------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [None, (127.5, 127.5),
                                       ((10.0, 20.0, 30.0), (2.0, 4.0, 8.0)),
                                       (127.5, 63.75)])
def test_cast_normalize_bit_exact_vs_jax_host_reference(dtype, normalize):
    torch_dtype, jax_dtype = {"float32": (torch.float32, np.float32),
                              "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    raw = {"image": _batch()["image"]}
    got = _apply(DeviceStage(output_dtype=torch_dtype, normalize=normalize), raw, 5)["image"]
    want = JaxDeviceStage(output_dtype=jax_dtype, normalize=normalize).host_reference(
        raw, 5)["image"]
    assert got.dtype == torch_dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --- crop / flip: exact selections from the recorded draws ------------------


@pytest.mark.parametrize("crop,flip", [((8, 6), True), ((8, 6), False), (None, True),
                                       ((16, 12), True)])
def test_crop_flip_exact_selections_match_the_mirror(crop, flip):
    stage = DeviceStage(crop=crop, flip=flip, seed=5, normalize=(127.5, 127.5))
    raw = {"image": _batch()["image"], "other": _batch(seed=1)["image"]}
    got = _apply(stage, raw, 2)
    want = _mirror(stage, raw, 2, 127.5, 127.5)
    for name in raw:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))


def test_flip_of_channelless_batches_flips_the_width_axis():
    stage = DeviceStage(flip=True, seed=1)
    x = _batch()["image"][..., 0]
    got = _apply(stage, {"image": x}, 0)["image"].numpy()
    flips = stage.draws(0, 0, x.shape)["flips"]
    assert 0 < flips.sum() < len(flips)
    for img, out, flipped in zip(x, got, flips):
        np.testing.assert_array_equal(out, (img[:, ::-1] if flipped else img).astype(np.float32))


def test_draws_vary_per_image_step_and_field_and_are_pure():
    stage = DeviceStage(crop=(8, 6), flip=True, seed=0)
    shape = (16,) + IMG_SHAPE
    a = stage.draws(0, 0, shape)
    assert len({tuple(o) for o in a["offsets"]}) > 4 and 0 < a["flips"].sum() < 16
    assert (a["offsets"][:, 0] <= 8).all() and (a["offsets"][:, 1] <= 6).all()
    again = DeviceStage(crop=(8, 6), flip=True, seed=0).draws(0, 0, shape)
    np.testing.assert_array_equal(a["offsets"], again["offsets"])
    np.testing.assert_array_equal(a["flips"], again["flips"])
    for other in (stage.draws(1, 0, shape), stage.draws(0, 1, shape),
                  DeviceStage(crop=(8, 6), flip=True, seed=1).draws(0, 0, shape)):
        assert not np.array_equal(a["offsets"], other["offsets"])


# --- through the loader ----------------------------------------------------


@pytest.fixture(scope="module")
def url(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('stage')}/ds"
    schema = Unischema("Img", [
        UnischemaField("id", np.int64, (), ScalarCodec(), False),
        UnischemaField("image", np.uint8, IMG_SHAPE, CompressedImageCodec("png"), False),
    ])
    rng = np.random.RandomState(3)
    materialize_rows(url, schema, ({"id": np.int64(i),
                                    "image": rng.randint(0, 256, IMG_SHAPE, dtype=np.uint8)}
                                   for i in range(64)), rows_per_row_group=16)
    return url


def _epochs(url, stage, device_prefetch=2, num_epochs=1):
    reader = make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                         num_epochs=num_epochs)
    with make_torch_dataloader(reader, 16, device="cpu", device_prefetch=device_prefetch,
                               device_stage=stage) as loader:
        return [dict(b) for b in loader], loader.diagnostics


def test_loader_outputs_follow_the_step_ordinal(url):
    kwargs = dict(crop=(8, 6), flip=True, seed=7, normalize=(127.5, 127.5))
    got, diag = _epochs(url, DeviceStage(**kwargs), device_prefetch=1, num_epochs=2)
    deep, _ = _epochs(url, DeviceStage(**kwargs), device_prefetch=4, num_epochs=2)
    assert len(got) == len(deep) == 8
    for a, b in zip(got, deep):  # prefetch depth and a fresh instance change nothing
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["id"], b["id"])
    # Epoch 2 holds the same rows with fresh draws: batch i is step 4 + i.
    reader = make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False)
    with make_torch_dataloader(reader, 16, device="cpu") as raw_loader:
        raws = [b["image"].numpy() for b in raw_loader]
    stage = DeviceStage(**kwargs)
    for step, batch in enumerate(got):
        raw = raws[step % 4]
        want = _mirror(stage, {"image": raw}, step, 127.5, 127.5)["image"]
        np.testing.assert_array_equal(_bits(batch["image"]), _bits(want))
    assert not torch.equal(got[0]["image"], got[4]["image"])
    assert torch.equal(got[0]["id"], got[4]["id"])
    assert diag["device_decode_s"] > 0 and diag["raw_stage_s"] >= 0
    assert diag["device_dispatch_s"] >= diag["device_decode_s"]
    assert diag["rows"] == 128 and diag["h2d_bytes"] == 0  # nothing crosses to a card


def test_loader_hands_over_the_stage_dtype(url):
    got, _ = _epochs(url, DeviceStage(output_dtype=torch.bfloat16, normalize=(127.5, 127.5)))
    assert all(b["image"].dtype == torch.bfloat16 and b["image"].shape == (16,) + IMG_SHAPE
               for b in got)
    assert all(b["id"].dtype == torch.int64 for b in got)
