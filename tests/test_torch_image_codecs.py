"""The port's compressed codecs against the JAX package's: bytes encoded by
either package decode identically in the other (png, jpeg, compressed
ndarray, and png / jpeg through Pillow where cv2 is absent),
``decode_column`` equals per-row ``decode``, and the serialized schemas
match, so image datasets written by either package read in the other.
Equality is exact (png and npz are lossless, and both packages decode jpeg
bytes with the same cv2 call) except for jpeg decoded by Pillow against
cv2: within 8 levels, as two jpeg decoders may round differently."""

import numpy as np
import pytest

from petastorm_tpu.etl.metadata import unischema_to_json as jax_unischema_to_json
from petastorm_tpu.schema import codecs as jax_codecs
from petastorm_tpu.schema.unischema import Unischema as JaxUnischema
from petastorm_tpu.schema.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.etl.metadata import unischema_from_json, unischema_to_json
from petastorm_tpu_torch.schema import codecs
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField

SHAPE = (16, 16, 3)
KINDS = {  # name -> (port codec, JAX codec, lossless)
    "png": (lambda: codecs.CompressedImageCodec("png"),
            lambda: jax_codecs.CompressedImageCodec("png"), True),
    "jpeg": (lambda: codecs.CompressedImageCodec("jpeg", quality=90),
             lambda: jax_codecs.CompressedImageCodec("jpeg", quality=90), False),
    "npz": (codecs.CompressedNdarrayCodec, jax_codecs.CompressedNdarrayCodec, True),
}


def _images(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, SHAPE, dtype=np.uint8) for _ in range(n)]


def _fields(kind):
    port_codec, jax_codec, _ = KINDS[kind]
    return (UnischemaField("image", np.uint8, SHAPE, port_codec(), False),
            JaxField("image", np.uint8, SHAPE, jax_codec(), False))


@pytest.fixture
def no_cv2(monkeypatch):
    """The port's codecs as on a host without cv2 (the Pillow route)."""
    monkeypatch.setattr(codecs, "_CV2", [None])


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("encoded_by", ["jax", "port"])
def test_bytes_from_either_package_decode_identically_in_both(kind, encoded_by):
    port_field, jax_field = _fields(kind)
    lossless = KINDS[kind][2]
    for img in _images():
        if encoded_by == "jax":
            cell = jax_field.codec.encode(jax_field, img)
        else:
            cell = port_field.codec.encode(port_field, img)
        got = port_field.codec.decode(port_field, cell)
        want = jax_field.codec.decode(jax_field, cell)
        assert got.dtype == want.dtype == np.uint8 and got.shape == SHAPE
        np.testing.assert_array_equal(got, want)
        if lossless:
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_port_encodes_the_same_image_bytes(kind):
    port_field, jax_field = _fields(kind)
    img = _images(1)[0]
    assert port_field.codec.encode(port_field, img) == jax_field.codec.encode(jax_field, img)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_column_equals_per_row_decode(kind):
    port_field, jax_field = _fields(kind)
    cells = np.array([jax_field.codec.encode(jax_field, img) for img in _images()],
                     dtype=object)
    column = port_field.codec.decode_column(port_field, cells)
    assert column.shape == (len(cells),) + SHAPE and column.dtype == np.uint8
    for i, cell in enumerate(cells):
        np.testing.assert_array_equal(column[i], port_field.codec.decode(port_field, cell))
    np.testing.assert_array_equal(column, jax_field.codec.decode_column(jax_field, cells))


def test_decode_column_falls_back_for_nulls_and_ragged_images():
    field = UnischemaField("image", np.uint8, (None, None, 3),
                           codecs.CompressedImageCodec("png"), True)
    imgs = [np.zeros((4, 4, 3), np.uint8), np.ones((5, 4, 3), np.uint8)]
    cells = [field.codec.encode(field, img) for img in imgs] + [None]
    column = field.codec.decode_column(field, cells)
    assert column.dtype == object and column[2] is None
    for got, want in zip(column[:2], imgs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", ["png", "jpeg"])
def test_pillow_route_reads_and_writes_what_cv2_does(no_cv2, codec):
    port_field, jax_field = _fields(codec)
    imgs = _images(4, seed=1)
    for img in imgs:
        # Pillow-encoded bytes through JAX's cv2 decode, and back.
        cell = port_field.codec.encode(port_field, img)
        via_cv2 = jax_field.codec.decode(jax_field, cell)
        jax_cell = jax_field.codec.encode(jax_field, img)
        via_pil = port_field.codec.decode(port_field, jax_cell)
        if codec == "png":
            np.testing.assert_array_equal(via_cv2, img)
            np.testing.assert_array_equal(via_pil, img)
        else:  # two jpeg decoders may round differently: a few levels apart
            assert np.abs(via_pil.astype(int) - jax_field.codec.decode(
                jax_field, jax_cell).astype(int)).max() <= 8
    cells = [port_field.codec.encode(port_field, img) for img in imgs]
    column = port_field.codec.decode_column(port_field, cells)
    for i, cell in enumerate(cells):
        np.testing.assert_array_equal(column[i], port_field.codec.decode(port_field, cell))


def test_encode_rejects_wrong_dtype_and_shape():
    field = UnischemaField("image", np.uint8, SHAPE, codecs.CompressedImageCodec(), False)
    with pytest.raises(ValueError, match="expected dtype"):
        field.codec.encode(field, np.zeros(SHAPE, np.float32))
    with pytest.raises(ValueError, match="expected shape"):
        field.codec.encode(field, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="Unsupported image codec"):
        codecs.CompressedImageCodec("gif")


def test_schemas_with_both_codecs_serialize_as_the_jax_package_does():
    def fields(field_cls, mod):
        return [field_cls("image", np.uint8, SHAPE, mod.CompressedImageCodec("jpeg", 75), False),
                field_cls("mask", np.uint8, (4, 4), mod.CompressedNdarrayCodec(), False)]

    port = Unischema("Img", fields(UnischemaField, codecs))
    jax = JaxUnischema("Img", fields(JaxField, jax_codecs))
    assert unischema_to_json(port) == jax_unischema_to_json(jax)
    back = unischema_from_json(jax_unischema_to_json(jax))
    assert back.image.codec.image_codec == "jpeg" and back.image.codec._quality == 75
    assert isinstance(back.mask.codec, codecs.CompressedNdarrayCodec)
