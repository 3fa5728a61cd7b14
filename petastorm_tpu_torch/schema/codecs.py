"""Column codecs: tensor <-> Parquet-cell encodings.

The port's own copy of ``petastorm_tpu/schema/codecs.py``: ``ScalarCodec``
(native Parquet scalars), ``NdarrayCodec`` (``np.save`` bytes, with the
cached-header vectorized decode), ``CompressedNdarrayCodec``
(``np.savez_compressed`` bytes) and ``CompressedImageCodec`` (png / jpeg
through cv2, or Pillow where cv2 is absent, with the vectorized
``[N, H, W, C]`` column decode). The byte format is identical, so a dataset
written by either package reads in the other.
"""

from __future__ import annotations

import io
from abc import ABC, abstractmethod
from decimal import Decimal

import numpy as np
import pyarrow as pa


def numpy_to_arrow_type(numpy_dtype):
    """Map a field's numpy dtype (or Decimal / str / bytes) to an arrow type."""
    if numpy_dtype is Decimal or numpy_dtype in (str, np.str_):
        return pa.string()
    if numpy_dtype in (bytes, np.bytes_):
        return pa.binary()
    dtype = np.dtype(numpy_dtype)
    if dtype.kind in ("U", "S"):
        return pa.string() if dtype.kind == "U" else pa.binary()
    if dtype.kind == "M":
        unit = np.datetime_data(dtype)[0]
        if unit == "D":
            return pa.date32()
        return pa.timestamp(unit if unit in ("s", "ms", "us", "ns") else "us")
    return pa.from_numpy_dtype(dtype)


class DataframeColumnCodec(ABC):
    """How one Unischema field is stored in a Parquet cell."""

    @abstractmethod
    def encode(self, unischema_field, value):
        """Encode ``value`` into its storage cell."""

    @abstractmethod
    def decode(self, unischema_field, value):
        """Decode a storage cell into the field's numpy value."""

    def decode_column(self, unischema_field, cells):
        """Decode a whole column into one ``[N, *shape]`` array (object array
        when ragged or null)."""
        return _stack_decoded([self.decode(unischema_field, c) for c in cells])

    @abstractmethod
    def arrow_dtype(self):
        """The ``pyarrow.DataType`` of the stored column."""


class ScalarCodec(DataframeColumnCodec):
    """Stores a scalar natively in its Parquet column; the constructor takes
    an arrow type, a numpy dtype, or nothing (derived from the field)."""

    def __init__(self, arrow_type_or_dtype=None):
        if arrow_type_or_dtype is None or isinstance(arrow_type_or_dtype, pa.DataType):
            self._arrow_type = arrow_type_or_dtype
        else:
            self._arrow_type = numpy_to_arrow_type(arrow_type_or_dtype)

    def arrow_dtype(self):
        return self._arrow_type

    def arrow_dtype_for_field(self, unischema_field):
        if self._arrow_type is not None:
            return self._arrow_type
        return numpy_to_arrow_type(unischema_field.numpy_dtype)

    def encode(self, unischema_field, value):
        if unischema_field.shape:
            raise ValueError(
                f"ScalarCodec can only encode scalars; field {unischema_field.name!r} "
                f"has shape {unischema_field.shape}")
        if value is None:
            return None
        dtype = unischema_field.numpy_dtype
        if dtype is Decimal:
            return str(value if isinstance(value, Decimal) else Decimal(str(value)))
        if dtype in (str, np.str_):
            return str(value)
        if dtype in (bytes, np.bytes_):
            return bytes(value)
        if np.dtype(dtype).kind == "M":
            return value
        return np.dtype(dtype).type(value).item()

    def decode(self, unischema_field, value):
        if value is None:
            return None
        dtype = unischema_field.numpy_dtype
        if dtype is Decimal:
            return value if isinstance(value, Decimal) else Decimal(
                value.decode("utf-8") if isinstance(value, bytes) else value)
        if dtype in (str, np.str_):
            return value.decode("utf-8") if isinstance(value, bytes) else str(value)
        if dtype in (bytes, np.bytes_):
            return value
        if np.dtype(dtype).kind == "M":
            return np.datetime64(value).astype(np.dtype(dtype))
        return np.dtype(dtype).type(value)

    def decode_column(self, unischema_field, cells):
        """Numeric columns are one ``astype``; strings, Decimals and columns
        with nulls decode cell by cell."""
        dtype = unischema_field.numpy_dtype
        if dtype is Decimal or dtype in (str, np.str_, bytes, np.bytes_):
            return super().decode_column(unischema_field, cells)
        arr = np.asarray(cells)
        if arr.dtype == object:
            return super().decode_column(unischema_field, cells)
        target = np.dtype(dtype)
        if target.kind in "iub" and arr.dtype.kind == "f" and np.isnan(arr).any():
            # Arrow materializes int-with-nulls as float NaN: keep None cells.
            out = np.empty(len(arr), dtype=object)
            for i, v in enumerate(arr):
                out[i] = None if np.isnan(v) else target.type(v)
            return out
        return arr.astype(target, copy=False)


class NdarrayCodec(DataframeColumnCodec):
    """Stores an ndarray as ``np.save`` bytes in a binary column."""

    def arrow_dtype(self):
        return pa.binary()

    def encode(self, unischema_field, value):
        expected = np.dtype(unischema_field.numpy_dtype)
        if value.dtype != expected:
            raise ValueError(
                f"Field {unischema_field.name!r}: expected dtype {expected}, got {value.dtype}")
        _check_shape_compatible(unischema_field, value)
        memfile = io.BytesIO()
        np.save(memfile, value)
        return memfile.getvalue()

    def decode(self, unischema_field, value):
        if value is None:
            return None
        return _fast_npy_load(value)

    def decode_column(self, unischema_field, cells):
        """Parse each npy header once (cached) and ``frombuffer`` straight
        into a preallocated ``[N, *shape]`` array; the generic loop handles
        nulls, ragged shapes and exotic payloads."""
        out = None
        for i, cell in enumerate(cells):
            parsed = _fast_npy_parse(cell) if isinstance(cell, bytes) else None
            if parsed is None:
                return super().decode_column(unischema_field, cells)
            dtype, fortran, shape, offset = parsed
            if out is None:
                if dtype.hasobject:
                    return super().decode_column(unischema_field, cells)
                out = np.empty((len(cells),) + shape, dtype=dtype)
            elif shape != out.shape[1:] or dtype != out.dtype:
                return super().decode_column(unischema_field, cells)
            data = np.frombuffer(cell, dtype=dtype, offset=offset,
                                 count=int(np.prod(shape)) if shape else 1)
            out[i] = data.reshape(shape, order="F" if fortran else "C")
        return out if out is not None else np.empty((0,), dtype=object)


# np.load re-parses the same header dict for every cell of a fixed-shape
# field; cache the parse keyed by the raw header bytes.
_NPY_HEADER_CACHE = {}
_NPY_MAGIC = b"\x93NUMPY"


def _fast_npy_parse(value):
    """``np.save`` bytes → ``(dtype, fortran, shape, data_offset)``, or None
    when not a plain npy payload."""
    if not isinstance(value, bytes) or not value.startswith(_NPY_MAGIC):
        return None
    major = value[6]
    if major == 1:
        hlen, offset = int.from_bytes(value[8:10], "little"), 10
    elif major in (2, 3):
        hlen, offset = int.from_bytes(value[8:12], "little"), 12
    else:
        return None
    header = value[offset:offset + hlen]
    parsed = _NPY_HEADER_CACHE.get(header)
    if parsed is None:
        import ast

        spec = ast.literal_eval(header.decode("latin1"))
        parsed = (np.dtype(spec["descr"]), bool(spec["fortran_order"]),
                  tuple(spec["shape"]))
        if len(_NPY_HEADER_CACHE) < 4096:
            _NPY_HEADER_CACHE[header] = parsed
    dtype, fortran, shape = parsed
    return dtype, fortran, shape, offset + hlen


def _fast_npy_load(value):
    """Decode ``np.save`` bytes with a cached header parse + frombuffer; the
    result is a writable copy."""
    parsed = _fast_npy_parse(value)
    if parsed is None or parsed[0].hasobject:
        return np.load(io.BytesIO(value), allow_pickle=False)
    dtype, fortran, shape, offset = parsed
    data = np.frombuffer(value, dtype=dtype, offset=offset,
                         count=int(np.prod(shape)) if shape else 1)
    return data.reshape(shape, order="F" if fortran else "C").copy()


class CompressedNdarrayCodec(DataframeColumnCodec):
    """Stores an ndarray as ``np.savez_compressed`` bytes (zlib), under the
    archive key ``arr``."""

    def arrow_dtype(self):
        return pa.binary()

    def encode(self, unischema_field, value):
        expected = np.dtype(unischema_field.numpy_dtype)
        if value.dtype != expected:
            raise ValueError(
                f"Field {unischema_field.name!r}: expected dtype {expected}, got {value.dtype}")
        _check_shape_compatible(unischema_field, value)
        memfile = io.BytesIO()
        np.savez_compressed(memfile, arr=value)
        return memfile.getvalue()

    def decode(self, unischema_field, value):
        if value is None:
            return None
        with np.load(io.BytesIO(value), allow_pickle=False) as archive:
            keys = archive.files
            return archive["arr" if "arr" in keys else keys[0]]


class CompressedImageCodec(DataframeColumnCodec):
    """Stores an image ndarray as png or jpeg bytes, through cv2 or, where
    cv2 is absent, Pillow. Channel order is whatever the user stored (cv2's
    convention is BGR; the Pillow route swaps to and from RGB so both store
    the same bytes); decode keeps the stored depth and alpha
    (``IMREAD_UNCHANGED``)."""

    def __init__(self, image_codec="png", quality=80):
        if image_codec not in ("png", "jpeg", "jpg"):
            raise ValueError(f"Unsupported image codec: {image_codec!r}")
        self._image_codec = "jpeg" if image_codec == "jpg" else image_codec
        self._quality = quality

    @property
    def image_codec(self):
        return self._image_codec

    def arrow_dtype(self):
        return pa.binary()

    def encode(self, unischema_field, value):
        if not isinstance(value, np.ndarray):
            raise ValueError(
                f"Field {unischema_field.name!r}: CompressedImageCodec expects ndarray")
        if value.dtype != np.dtype(unischema_field.numpy_dtype):
            raise ValueError(
                f"Field {unischema_field.name!r}: expected dtype "
                f"{np.dtype(unischema_field.numpy_dtype)}, got {value.dtype}")
        _check_shape_compatible(unischema_field, value)
        cv2 = _cv2()
        if cv2 is None:
            return self._pil_encode(value)
        if self._image_codec == "png":
            ok, contents = cv2.imencode(".png", value)
        else:
            ok, contents = cv2.imencode(
                ".jpeg", value, [int(cv2.IMWRITE_JPEG_QUALITY), self._quality])
        if not ok:
            raise ValueError(f"cv2.imencode failed for field {unischema_field.name!r}")
        return contents.tobytes()

    def decode(self, unischema_field, value):
        if value is None:
            return None
        cv2 = _cv2()
        if cv2 is None:
            return self._pil_decode(value)
        return cv2.imdecode(np.frombuffer(value, dtype=np.uint8), cv2.IMREAD_UNCHANGED)

    def decode_column(self, unischema_field, cells):
        """imdecode each cell straight into a preallocated ``[N, H, W, C]``
        array; the generic loop handles nulls, undecodable bytes and ragged
        image shapes (and the Pillow route)."""
        cv2 = _cv2()
        if cv2 is None:
            return super().decode_column(unischema_field, cells)
        out = None
        for i, cell in enumerate(cells):
            if cell is None:
                return super().decode_column(unischema_field, cells)
            img = cv2.imdecode(np.frombuffer(cell, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
            if img is None:
                return super().decode_column(unischema_field, cells)
            if out is None:
                out = np.empty((len(cells),) + img.shape, dtype=img.dtype)
            elif img.shape != out.shape[1:] or img.dtype != out.dtype:
                return super().decode_column(unischema_field, cells)
            out[i] = img
        return out if out is not None else np.empty((0,), dtype=object)

    def _pil_encode(self, value):
        from PIL import Image

        memfile = io.BytesIO()
        img = value
        if img.ndim == 3 and img.shape[2] == 3:
            img = img[:, :, ::-1]
        Image.fromarray(img).save(
            memfile, format="PNG" if self._image_codec == "png" else "JPEG",
            quality=self._quality)
        return memfile.getvalue()

    def _pil_decode(self, value):
        from PIL import Image

        arr = np.asarray(Image.open(io.BytesIO(value)))
        if arr.ndim == 3 and arr.shape[2] == 3:
            arr = arr[:, :, ::-1]
        return arr


_CV2 = []


def _cv2():
    """The ``cv2`` module, or None where it is not installed (imported once,
    at first use)."""
    if not _CV2:
        try:
            import cv2
        except ImportError:
            cv2 = None
        _CV2.append(cv2)
    return _CV2[0]


def _stack_decoded(decoded):
    if not decoded:
        return np.empty((0,), dtype=object)
    first = decoded[0]
    if isinstance(first, np.ndarray) and first.dtype != object and all(
            isinstance(v, np.ndarray) and v.shape == first.shape
            and v.dtype == first.dtype for v in decoded):
        return np.stack(decoded)
    if isinstance(first, (int, float, bool, np.generic)) and all(
            v is not None for v in decoded):
        return np.asarray(decoded)
    out = np.empty(len(decoded), dtype=object)
    for i, v in enumerate(decoded):
        out[i] = v
    return out


def _check_shape_compatible(unischema_field, value):
    shape = unischema_field.shape
    if len(shape) != value.ndim:
        raise ValueError(
            f"Field {unischema_field.name!r}: expected rank {len(shape)}, "
            f"got rank {value.ndim}")
    for expected_dim, actual_dim in zip(shape, value.shape):
        if expected_dim is not None and expected_dim != actual_dim:
            raise ValueError(
                f"Field {unischema_field.name!r}: expected shape {shape}, "
                f"got {value.shape}")
