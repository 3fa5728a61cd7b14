"""Dataset metadata: materialization and schema persistence.

The port's own copy of ``petastorm_tpu/etl/metadata.py``: the pyarrow
writer (:func:`materialize_dataset` with the JAX signature, :func:`write_rows`
in every write form: rows or megabytes per group, files capped in rows,
compression, file names, parallel encoding), schema loading
(:func:`get_schema` from a metadata dict or a filesystem and path) and
inference (:func:`infer_or_load_unischema`), and row-group enumeration. The
on-disk format is the same — Parquet files plus a ``_common_metadata``
footer carrying the JSON-serialized Unischema, the row groups per file and
their row counts under the same keys — and the same rows and arguments
give byte-equal files in both packages. Datasets whose footer carries only
a schema pickled by the reference petastorm read through a restricted
unpickler (:func:`unischema_from_reference_pickle`), which rebuilds the
schema from an allowlist and imports no module the pickle names. The
writer takes ``storage_options``, ``filesystem`` and ``filesystem_factory``
as the JAX package does; a Spark session raises NotImplementedError.
"""

from __future__ import annotations

import importlib
import io
import json
import pickle
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from decimal import Decimal
from itertools import islice

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import PetastormMetadataError
from petastorm_tpu_torch.fs_utils import FilesystemResolver
from petastorm_tpu_torch.schema import codecs as codecs_mod
from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField, encode_row

ROW_GROUPS_PER_FILE_KEY = b"dataset-toolkit.num_row_groups_per_file.v1"
ROW_GROUP_ROW_COUNTS_KEY = b"petastorm-tpu.row_group_row_counts.v1"
UNISCHEMA_JSON_KEY = b"petastorm_tpu.unischema.json.v1"
#: The keys under which the reference petastorm pickles its Unischema.
UNISCHEMA_KEY = b"dataset-toolkit.unischema.v1"
UNISCHEMA_KEY_V2 = b"petastorm.unischema.v1"

_COMMON_METADATA = "_common_metadata"
_DEFAULT_ROWS_PER_ROW_GROUP = 4096
#: Rows encoded to convert ``row_group_size_mb`` into rows per group.
_DEFAULT_ROW_GROUP_PROBE = 64


# ---------------------------------------------------------------------------
# Unischema <-> JSON
# ---------------------------------------------------------------------------

_DTYPE_SPECIALS = {"str": str, "bytes": bytes, "decimal": Decimal}
_ARROW_SIMPLE = {
    "bool": pa.bool_(), "int8": pa.int8(), "int16": pa.int16(),
    "int32": pa.int32(), "int64": pa.int64(), "uint8": pa.uint8(),
    "uint16": pa.uint16(), "uint32": pa.uint32(), "uint64": pa.uint64(),
    "halffloat": pa.float16(), "float": pa.float32(), "double": pa.float64(),
    "string": pa.string(), "large_string": pa.large_string(),
    "binary": pa.binary(), "large_binary": pa.large_binary(),
    "date32[day]": pa.date32(), "date64[ms]": pa.date64(),
}


def _arrow_type_from_string(type_str):
    """The arrow type ``str(type)`` printed: the simple types, timestamps
    with unit and zone, and decimals."""
    if type_str in _ARROW_SIMPLE:
        return _ARROW_SIMPLE[type_str]
    if type_str.startswith("timestamp["):
        unit, *rest = [part.strip() for part in type_str[len("timestamp["):-1].split(",")]
        zones = [part[len("tz="):] for part in rest if part.startswith("tz=")]
        return pa.timestamp(unit, tz=zones[-1] if zones else None)
    for prefix, ctor in (("decimal128(", pa.decimal128), ("decimal256(", pa.decimal256)):
        if type_str.startswith(prefix):
            precision, scale = type_str[len(prefix):-1].split(",")
            return ctor(int(precision), int(scale))
    raise PetastormMetadataError(f"Cannot parse arrow type string {type_str!r}")


def _dtype_to_json(numpy_dtype):
    if numpy_dtype is Decimal:
        return "decimal"
    if numpy_dtype in (str, np.str_):
        return "str"
    if numpy_dtype in (bytes, np.bytes_):
        return "bytes"
    return np.dtype(numpy_dtype).str


def _codec_to_json(codec):
    if codec is None:
        return None
    if isinstance(codec, codecs_mod.ScalarCodec):
        arrow_type = codec.arrow_dtype()
        return {"codec": "ScalarCodec",
                "arrow_type": None if arrow_type is None else str(arrow_type)}
    if isinstance(codec, codecs_mod.CompressedImageCodec):
        return {"codec": "CompressedImageCodec", "image_codec": codec.image_codec,
                "quality": codec._quality}
    if isinstance(codec, (codecs_mod.NdarrayCodec, codecs_mod.CompressedNdarrayCodec)):
        return {"codec": type(codec).__name__}
    raise PetastormMetadataError(
        f"codec {type(codec).__name__} is not supported by this package yet")


def _codec_from_json(spec):
    if spec is None:
        return None
    name = spec["codec"]
    if name == "ScalarCodec":
        arrow_type = spec.get("arrow_type")
        if arrow_type is None:
            return codecs_mod.ScalarCodec()
        return codecs_mod.ScalarCodec(_arrow_type_from_string(arrow_type))
    if name == "NdarrayCodec":
        return codecs_mod.NdarrayCodec()
    if name == "CompressedNdarrayCodec":
        return codecs_mod.CompressedNdarrayCodec()
    if name == "CompressedImageCodec":
        return codecs_mod.CompressedImageCodec(spec.get("image_codec", "png"),
                                               spec.get("quality", 80))
    raise PetastormMetadataError(
        f"codec {name!r} in the serialized schema is not supported by this "
        "package yet")


def unischema_to_json(schema):
    """Serialize a Unischema to the JSON string stored in the footer."""
    fields = [{"name": f.name, "numpy_dtype": _dtype_to_json(f.numpy_dtype),
               "shape": list(f.shape), "codec": _codec_to_json(f.codec),
               "nullable": f.nullable}
              for f in schema.fields.values()]
    return json.dumps({"version": 1, "name": schema._name, "fields": fields})


def unischema_from_json(payload):
    """Inverse of :func:`unischema_to_json`."""
    if isinstance(payload, bytes):
        payload = payload.decode("utf-8")
    doc = json.loads(payload)
    return Unischema(doc.get("name", "schema"), [
        UnischemaField(
            f["name"],
            _DTYPE_SPECIALS.get(f["numpy_dtype"]) or np.dtype(f["numpy_dtype"]),
            tuple(f["shape"]), _codec_from_json(f["codec"]), f["nullable"])
        for f in doc["fields"]])


# ---------------------------------------------------------------------------
# Reference-pickled schemas (restricted unpickler)
# ---------------------------------------------------------------------------

class _RefState:
    """Absorbs the state of a pickled reference object (a Unischema, a
    codec, a pyspark type) without running any of its class's code."""

    target = None

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


def _standin(name, target=None):
    return type(name, (_RefState,), {"target": target})


_SPARK_NAME_TO_ARROW = {
    "BooleanType": pa.bool_(), "ByteType": pa.int8(), "ShortType": pa.int16(),
    "IntegerType": pa.int32(), "LongType": pa.int64(), "FloatType": pa.float32(),
    "DoubleType": pa.float64(), "StringType": pa.string(),
    "BinaryType": pa.binary(), "DecimalType": pa.string(),
    "DateType": pa.date32(), "TimestampType": pa.timestamp("us"),
}
_SPARK_STANDINS = {name: _standin(name, name) for name in _SPARK_NAME_TO_ARROW}


class _RefFieldStandin:
    """The reference's ``UnischemaField`` namedtuple pickles as
    ``cls.__new__(cls, *values)``: this returns the values as a marked dict
    that :func:`_convert_ref_field` turns into a field of this package."""

    def __new__(cls, *args, **kwargs):
        values = dict(zip(["name", "numpy_dtype", "shape", "codec", "nullable"], args))
        values.update(kwargs)
        return {"__ref_field__": True, **values}


_REF_UNISCHEMA = _standin("_RefUnischema")
_REF_CLASSES = {
    ("petastorm.unischema", "Unischema"): _REF_UNISCHEMA,
    ("petastorm.unischema", "UnischemaField"): _RefFieldStandin,
    ("petastorm.codecs", "ScalarCodec"): _standin("_RefScalarCodec", "ScalarCodec"),
    ("petastorm.codecs", "NdarrayCodec"): _standin("_RefNdarray", "NdarrayCodec"),
    ("petastorm.codecs", "CompressedNdarrayCodec"): _standin(
        "_RefCompressedNdarray", "CompressedNdarrayCodec"),
    ("petastorm.codecs", "CompressedImageCodec"): _standin(
        "_RefCompressedImage", "CompressedImageCodec"),
}

_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numerictypes", "numpy._core.numerictypes")
#: Only numpy's dtype and scalar reconstruction: np.save, np.load and the
#: like would be file-write and code-execution gadgets.
_NUMPY_ALLOWED_NAMES = frozenset({
    "dtype", "scalar", "_reconstruct", "ndarray", "_frombuffer",
    "bool_", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "longdouble", "complex64",
    "complex128", "str_", "bytes_", "void", "datetime64", "timedelta64",
    "generic", "number", "integer", "signedinteger", "unsignedinteger",
    "inexact", "floating", "complexfloating", "flexible", "character",
    "intp", "uintp", "intc", "uintc", "byte", "ubyte", "short", "ushort",
    "longlong", "ulonglong", "half", "single", "double",
})
_SAFE_BUILTINS = {t.__name__: t for t in (dict, list, tuple, set, frozenset, str, bytes,
                                          int, float, bool, complex, object)}


def allowlisted_class(module, name):
    """The class a restricted unpickler may build for ``module.name``: numpy's
    dtype and scalar machinery, plain builtins, ``OrderedDict`` and
    ``Decimal``; anything else raises ``pickle.UnpicklingError`` without
    importing ``module``."""
    if module in _NUMPY_MODULES and name in _NUMPY_ALLOWED_NAMES:
        if hasattr(np, name):
            return getattr(np, name)
        try:
            return getattr(importlib.import_module(module), name)
        except (ImportError, AttributeError) as exc:
            raise pickle.UnpicklingError(
                f"Restricted unpickler: cannot resolve {module}.{name}") from exc
    if module == "builtins" and name in _SAFE_BUILTINS:
        return _SAFE_BUILTINS[name]
    if module == "collections" and name == "OrderedDict":
        return OrderedDict
    if module == "decimal" and name == "Decimal":
        return Decimal
    raise pickle.UnpicklingError(f"Restricted unpickler: refusing {module}.{name}")


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickles reference schemas and refuses everything not allowlisted."""

    def find_class(self, module, name):
        if (module, name) in _REF_CLASSES:
            return _REF_CLASSES[(module, name)]
        if module.startswith("pyspark.sql.types") and name in _SPARK_STANDINS:
            return _SPARK_STANDINS[name]
        return allowlisted_class(module, name)


def _convert_ref_codec(codec):
    if codec is None:
        return None
    target = getattr(codec, "target", None)
    state = getattr(codec, "__dict__", {})
    if target == "ScalarCodec":
        spark_type = state.get("_spark_type") or state.get("spark_type")
        if isinstance(spark_type, _RefState) and spark_type.target in _SPARK_NAME_TO_ARROW:
            return codecs_mod.ScalarCodec(_SPARK_NAME_TO_ARROW[spark_type.target])
        return codecs_mod.ScalarCodec()
    if target == "NdarrayCodec":
        return codecs_mod.NdarrayCodec()
    if target == "CompressedNdarrayCodec":
        return codecs_mod.CompressedNdarrayCodec()
    if target == "CompressedImageCodec":
        image_codec = state.get("_image_codec", "png")
        if not isinstance(image_codec, str):  # the reference sometimes stores a cv2 token
            image_codec = "png"
        return codecs_mod.CompressedImageCodec(image_codec, state.get("_quality", 80))
    raise PetastormMetadataError(f"Cannot convert reference codec {codec!r}")


def _convert_ref_field(field):
    if not (isinstance(field, dict) and field.get("__ref_field__")):
        raise PetastormMetadataError(f"Unexpected reference field payload: {field!r}")
    dtype = field["numpy_dtype"]
    if isinstance(dtype, type) and issubclass(dtype, np.generic):
        dtype = np.dtype(dtype)
    return UnischemaField(field["name"], dtype, tuple(field.get("shape") or ()),
                          _convert_ref_codec(field.get("codec")),
                          bool(field.get("nullable", False)))


def unischema_from_reference_pickle(payload):
    """A Unischema of this package from the reference's pickled schema
    (``dataset-toolkit.unischema.v1`` / ``petastorm.unischema.v1``), through
    the restricted unpickler."""
    ref = _RestrictedUnpickler(io.BytesIO(payload)).load()
    if not isinstance(ref, _REF_UNISCHEMA):
        raise PetastormMetadataError(
            f"Reference pickle did not contain a Unischema (got {type(ref)})")
    raw_fields = ref.__dict__.get("_fields", {})
    fields = raw_fields.values() if isinstance(raw_fields, dict) else raw_fields
    return Unischema(ref.__dict__.get("_name", "reference_schema"),
                     [_convert_ref_field(f) for f in fields])


# ---------------------------------------------------------------------------
# _common_metadata
# ---------------------------------------------------------------------------

def _join(base, name):
    return base.rstrip("/") + "/" + name


def _exists(filesystem, path):
    import pyarrow.fs as pafs

    return filesystem.get_file_info(path).type != pafs.FileType.NotFound


def add_many_to_dataset_metadata(filesystem, dataset_path, entries):
    """Merge key/values (bytes or str) into ``_common_metadata`` in one
    read + rewrite."""
    entries = {(k.encode() if isinstance(k, str) else k):
               (v.encode() if isinstance(v, str) else v)
               for k, v in entries.items()}
    common_path = _join(dataset_path, _COMMON_METADATA)
    if _exists(filesystem, common_path):
        with filesystem.open_input_file(common_path) as f:
            arrow_schema = pq.read_metadata(f).schema.to_arrow_schema()
    else:
        import pyarrow.dataset as pads

        arrow_schema = pads.dataset(dataset_path, filesystem=filesystem,
                                    format="parquet").schema
    merged = dict(arrow_schema.metadata or {})
    merged.update(entries)
    with filesystem.open_output_stream(common_path) as out:
        pq.write_metadata(arrow_schema.with_metadata(merged), out)


def add_to_dataset_metadata(filesystem, dataset_path, key, value):
    """Merge one key/value into ``_common_metadata``."""
    add_many_to_dataset_metadata(filesystem, dataset_path, {key: value})


def read_dataset_metadata(filesystem, dataset_path):
    """The key/value metadata dict of ``_common_metadata`` (or {})."""
    common_path = _join(dataset_path, _COMMON_METADATA)
    if not _exists(filesystem, common_path):
        return {}
    with filesystem.open_input_file(common_path) as f:
        return dict(pq.read_metadata(f).schema.to_arrow_schema().metadata or {})


@contextmanager
def materialize_dataset(spark, dataset_url, schema, row_group_size_mb=None,
                        use_summary_metadata=False, filesystem_factory=None,
                        storage_options=None, filesystem=None):
    """Context manager bracketing a dataset write (the JAX package's
    signature); on a clean exit it attaches the schema and the row-group
    bookkeeping to ``_common_metadata``, after a failed write nothing.

    ``spark=None`` is the pyarrow path: write inside the block with
    :func:`write_rows`. With a Spark session, its Hadoop configuration gets
    ``parquet.block.size`` (``row_group_size_mb``, when given) and
    ``parquet.summary.metadata.level`` (``ALL`` with
    ``use_summary_metadata``, else ``NONE``) for the block, and each key is
    restored, or unset where it had no value, on the way out. The store's
    filesystem is ``filesystem_factory()`` when given, else the one
    ``storage_options`` or ``filesystem`` resolve
    (:class:`~petastorm_tpu_torch.fs_utils.FilesystemResolver`)."""
    restore = None
    if spark is not None:
        hadoop_conf = spark.sparkContext._jsc.hadoopConfiguration()
        restore = {key: hadoop_conf.get(key)
                   for key in ("parquet.block.size", "parquet.summary.metadata.level")}
        if row_group_size_mb:
            hadoop_conf.setInt("parquet.block.size", row_group_size_mb * 1024 * 1024)
        hadoop_conf.set("parquet.summary.metadata.level",
                        "ALL" if use_summary_metadata else "NONE")
    try:
        yield
    finally:
        if restore is not None:
            hadoop_conf = spark.sparkContext._jsc.hadoopConfiguration()
            for key, old in restore.items():
                if old is None:
                    hadoop_conf.unset(key)
                else:
                    hadoop_conf.set(key, old)
    if filesystem_factory is not None:
        fs = filesystem_factory()
        path = FilesystemResolver(dataset_url, filesystem=fs).get_dataset_path()
    else:
        resolver = FilesystemResolver(dataset_url, storage_options=storage_options,
                                      filesystem=filesystem)
        fs, path = resolver.filesystem(), resolver.get_dataset_path()
    import pyarrow.dataset as pads

    counts, row_counts = {}, {}
    base = path.rstrip("/") + "/"
    for fragment in pads.dataset(path, filesystem=fs, format="parquet").get_fragments():
        rel = fragment.path[len(base):] if fragment.path.startswith(base) else fragment.path
        meta = fragment.metadata
        counts[rel] = meta.num_row_groups
        row_counts[rel] = [meta.row_group(i).num_rows for i in range(meta.num_row_groups)]
    add_many_to_dataset_metadata(fs, path, {
        ROW_GROUPS_PER_FILE_KEY: json.dumps(counts),
        ROW_GROUP_ROW_COUNTS_KEY: json.dumps(row_counts),
        UNISCHEMA_JSON_KEY: unischema_to_json(schema),
    })


def write_rows(dataset_url, schema, rows, row_group_size_mb=None,
               rows_per_file=None, rows_per_row_group=None, compression="snappy",
               storage_options=None, filesystem=None, basename_template=None,
               encode_workers=1):
    """Encode and write an iterable of row dicts (a generator too) as
    Parquet files, memory O(row group); the files are byte-equal to the JAX
    package's for the same arguments. Returns the written files' paths.

    Rows per group: ``rows_per_row_group``; else ``row_group_size_mb``
    converted to rows by the bytes per row of the first 64 encoded rows;
    else 4096. ``rows_per_file`` caps a group at that many rows and starts
    a new file at the first group boundary at or past it, so groups never
    span files. Files are named ``basename_template.format(i)`` (default
    ``part-{:05d}.parquet``). ``encode_workers > 1`` encodes groups on that
    many threads (the codecs release the GIL), submitted and written in
    order with at most ``2 × encode_workers`` groups in flight, so the
    output is byte-equal to ``encode_workers=1``. ``storage_options`` and
    ``filesystem`` select the filesystem, as for the readers."""
    resolver = FilesystemResolver(dataset_url, storage_options=storage_options,
                                  filesystem=filesystem)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    fs.create_dir(path, recursive=True)
    arrow_schema = schema.as_arrow_schema()
    template = basename_template or "part-{:05d}.parquet"
    rows_iter = iter(rows)

    pending = []
    if rows_per_row_group:
        group_rows = rows_per_row_group
    elif row_group_size_mb:
        pending = list(islice(rows_iter, _DEFAULT_ROW_GROUP_PROBE))
        if not pending:
            raise ValueError("write_rows requires at least one row")
        probe = _rows_to_table([encode_row(schema, r) for r in pending], arrow_schema)
        bytes_per_row = max(1, probe.nbytes // len(pending))
        group_rows = max(1, (row_group_size_mb * 1024 * 1024) // bytes_per_row)
    else:
        group_rows = _DEFAULT_ROWS_PER_ROW_GROUP
    if rows_per_file:
        group_rows = min(group_rows, rows_per_file)

    def batches():
        buffer = pending
        while True:
            # The probe may hold more rows than a group (max(0, ...): the
            # JAX writer's islice raises there).
            buffer.extend(islice(rows_iter, max(0, group_rows - len(buffer))))
            if not buffer:
                return
            yield buffer[:group_rows]
            buffer = buffer[group_rows:]

    def encode_batch(batch):
        return _rows_to_table([encode_row(schema, row) for row in batch], arrow_schema)

    def encoded_tables():
        if encode_workers <= 1:
            yield from map(encode_batch, batches())
            return
        with ThreadPoolExecutor(encode_workers) as executor:
            in_flight = deque()
            for batch in batches():
                in_flight.append(executor.submit(encode_batch, batch))
                if len(in_flight) >= 2 * encode_workers:
                    yield in_flight.popleft().result()
            while in_flight:
                yield in_flight.popleft().result()

    written, writer, rows_in_file = [], None, 0
    try:
        for table in encoded_tables():
            if writer is None:
                written.append(_join(path, template.format(len(written))))
                writer = pq.ParquetWriter(fs.open_output_stream(written[-1]),
                                          arrow_schema, compression=compression)
            writer.write_table(table, row_group_size=table.num_rows)
            rows_in_file += table.num_rows
            if rows_per_file and rows_in_file >= rows_per_file:
                writer.close()
                writer, rows_in_file = None, 0
    finally:
        if writer is not None:
            writer.close()
    if not written:
        raise ValueError("write_rows requires at least one row")
    return written


def _rows_to_table(encoded_rows, arrow_schema):
    return pa.Table.from_arrays(
        [pa.array([row[f.name] for row in encoded_rows], type=f.type) for f in arrow_schema],
        schema=arrow_schema)


def materialize_rows(dataset_url, schema, rows, **write_kwargs):
    """One call: :func:`write_rows` (its keyword arguments) inside
    :func:`materialize_dataset`, both on the filesystem ``storage_options``
    or ``filesystem`` select."""
    storage_options = write_kwargs.pop("storage_options", None)
    filesystem = write_kwargs.pop("filesystem", None)
    with materialize_dataset(None, dataset_url, schema, storage_options=storage_options,
                             filesystem=filesystem):
        write_rows(dataset_url, schema, rows, storage_options=storage_options,
                   filesystem=filesystem, **write_kwargs)


def get_schema(dataset_or_metadata, dataset_path=None, filesystem=None):
    """The Unischema stored in a dataset's ``_common_metadata``: the JSON
    one, else one the reference pickled (through the restricted
    unpickler). Takes a metadata dict (:func:`read_dataset_metadata`) or a
    ``(filesystem, dataset_path)`` pair; ``filesystem=`` is unused, as in
    the JAX package."""
    if isinstance(dataset_or_metadata, dict):
        metadata = dataset_or_metadata
    else:
        metadata = read_dataset_metadata(dataset_or_metadata, dataset_path)
    if UNISCHEMA_JSON_KEY in metadata:
        return unischema_from_json(metadata[UNISCHEMA_JSON_KEY])
    for key in (UNISCHEMA_KEY_V2, UNISCHEMA_KEY):
        if key in metadata:
            return unischema_from_reference_pickle(metadata[key])
    raise PetastormMetadataError(
        "Dataset carries no Unischema metadata (not a petastorm dataset?). "
        "Use make_batch_reader for plain Parquet stores, or regenerate the "
        "metadata with python -m petastorm_tpu_torch.etl.petastorm_generate_metadata.")


def get_schema_from_dataset_url(dataset_url, hdfs_driver="libhdfs",
                                storage_options=None, filesystem=None):
    """:func:`get_schema` of the dataset at ``dataset_url`` (on the
    filesystem ``storage_options`` or ``filesystem`` select)."""
    resolver = FilesystemResolver(dataset_url, hdfs_driver=hdfs_driver,
                                  storage_options=storage_options, filesystem=filesystem)
    return get_schema(resolver.filesystem(), resolver.get_dataset_path())


def infer_or_load_unischema(filesystem, dataset_path):
    """``(schema, was_stored)``: the stored Unischema, else one inferred
    from the Parquet files' Arrow schema (codec-less fields)."""
    try:
        return get_schema(filesystem, dataset_path), True
    except PetastormMetadataError:
        import pyarrow.dataset as pads

        dataset = pads.dataset(dataset_path, filesystem=filesystem, format="parquet")
        return Unischema.from_arrow_schema(dataset.schema), False


# ---------------------------------------------------------------------------
# Row-group enumeration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RowGroupPiece:
    """One unit of ventilated work: one row group of one file."""

    path: str
    row_group: int
    num_rows: int | None = None
    partition_keys: tuple = ()

    def read(self, filesystem, columns=None):
        with filesystem.open_input_file(self.path) as f:
            return pq.ParquetFile(f).read_row_group(self.row_group, columns=columns)


def piece_row_counts(filesystem, pieces):
    """``{(path, row_group): num_rows}`` for every piece: pieces that carry
    their count cost nothing, the others are read from their file's
    footer, opened once per file."""
    counts, unresolved = {}, {}
    for piece in pieces:
        if piece.num_rows is not None:
            counts[(piece.path, piece.row_group)] = piece.num_rows
        else:
            unresolved.setdefault(piece.path, []).append(piece.row_group)
    for path, row_groups in unresolved.items():
        with filesystem.open_input_file(path) as f:
            file_metadata = pq.ParquetFile(f).metadata
        for rg in row_groups:
            counts[(path, rg)] = file_metadata.row_group(rg).num_rows
    return counts


def load_row_groups(filesystem, dataset_path, metadata=None):
    """The dataset's row groups in canonical order (sorted file path, then
    row-group index), from the footer's bookkeeping when present, else from
    a fragment scan. ``metadata``: the ``_common_metadata`` key/value dict
    when the caller has read it already."""
    if metadata is None:
        metadata = read_dataset_metadata(filesystem, dataset_path)
    if ROW_GROUPS_PER_FILE_KEY in metadata:
        counts = json.loads(metadata[ROW_GROUPS_PER_FILE_KEY].decode("utf-8"))
        row_counts = json.loads(
            metadata.get(ROW_GROUP_ROW_COUNTS_KEY, b"{}").decode("utf-8"))
        base = dataset_path.rstrip("/")
        pieces = []
        for rel_path, n_row_groups in sorted(counts.items()):
            full = rel_path if rel_path.startswith(base) else _join(base, rel_path)
            per_rg = row_counts.get(rel_path)
            for rg in range(n_row_groups):
                pieces.append(RowGroupPiece(
                    full, rg, per_rg[rg] if per_rg and rg < len(per_rg) else None))
        return pieces
    import pyarrow.dataset as pads

    dataset = pads.dataset(dataset_path, filesystem=filesystem, format="parquet")
    return [RowGroupPiece(fragment.path, rg.row_groups[0].id, rg.row_groups[0].num_rows)
            for fragment in sorted(dataset.get_fragments(), key=lambda f: f.path)
            for rg in fragment.split_by_row_group()]
