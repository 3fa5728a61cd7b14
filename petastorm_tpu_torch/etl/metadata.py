"""Dataset metadata: materialization and schema persistence.

The port's own copy of the parts of ``petastorm_tpu/etl/metadata.py`` the
main path uses. The on-disk format is the same — Parquet files plus a
``_common_metadata`` footer carrying the JSON-serialized Unischema, the
row groups per file and their row counts under the same keys — so datasets
written by either package read in the other. (The restricted unpickler for
reference-pickled schemas and the Spark write path are not ported yet.)
"""

from __future__ import annotations

import json
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

_COMMON_METADATA = "_common_metadata"
_DEFAULT_ROWS_PER_ROW_GROUP = 4096


# ---------------------------------------------------------------------------
# Unischema <-> JSON
# ---------------------------------------------------------------------------

_DTYPE_SPECIALS = {"str": str, "bytes": bytes, "decimal": Decimal}
_ARROW_SIMPLE = {
    "bool": pa.bool_(), "int8": pa.int8(), "int16": pa.int16(),
    "int32": pa.int32(), "int64": pa.int64(), "uint8": pa.uint8(),
    "uint16": pa.uint16(), "uint32": pa.uint32(), "uint64": pa.uint64(),
    "halffloat": pa.float16(), "float": pa.float32(), "double": pa.float64(),
    "string": pa.string(), "binary": pa.binary(),
    "date32[day]": pa.date32(), "date64[ms]": pa.date64(),
}


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
        if arrow_type not in _ARROW_SIMPLE:
            raise PetastormMetadataError(
                f"Cannot parse arrow type string {arrow_type!r}")
        return codecs_mod.ScalarCodec(_ARROW_SIMPLE[arrow_type])
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


def read_dataset_metadata(filesystem, dataset_path):
    """The key/value metadata dict of ``_common_metadata`` (or {})."""
    common_path = _join(dataset_path, _COMMON_METADATA)
    if not _exists(filesystem, common_path):
        return {}
    with filesystem.open_input_file(common_path) as f:
        return dict(pq.read_metadata(f).schema.to_arrow_schema().metadata or {})


@contextmanager
def materialize_dataset(dataset_url, schema):
    """Bracket a dataset write; on exit attach the schema and the row-group
    bookkeeping to the footer."""
    yield
    resolver = FilesystemResolver(dataset_url)
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


def write_rows(dataset_url, schema, rows, rows_per_row_group=None):
    """Encode and write an iterable of row dicts as one snappy Parquet
    file, one row group per ``rows_per_row_group`` rows (default 4096),
    memory O(row group)."""
    resolver = FilesystemResolver(dataset_url)
    fs, path = resolver.filesystem(), resolver.get_dataset_path()
    fs.create_dir(path, recursive=True)
    arrow_schema = schema.as_arrow_schema()
    group_rows = rows_per_row_group or _DEFAULT_ROWS_PER_ROW_GROUP
    rows_iter = iter(rows)
    file_path = _join(path, "part-00000.parquet")
    writer = None
    try:
        while True:
            batch = list(islice(rows_iter, group_rows))
            if not batch:
                break
            encoded = [encode_row(schema, row) for row in batch]
            table = pa.Table.from_arrays(
                [pa.array([r[f.name] for r in encoded], type=f.type)
                 for f in arrow_schema], schema=arrow_schema)
            if writer is None:
                writer = pq.ParquetWriter(fs.open_output_stream(file_path),
                                          arrow_schema, compression="snappy")
            writer.write_table(table, row_group_size=len(batch))
    finally:
        if writer is not None:
            writer.close()
    if writer is None:
        raise ValueError("write_rows requires at least one row")
    return file_path


def materialize_rows(dataset_url, schema, rows, rows_per_row_group=None):
    """One call: write rows and attach the metadata."""
    with materialize_dataset(dataset_url, schema):
        write_rows(dataset_url, schema, rows, rows_per_row_group)


def get_schema(filesystem, dataset_path):
    """The Unischema stored in the dataset's footer."""
    metadata = read_dataset_metadata(filesystem, dataset_path)
    if UNISCHEMA_JSON_KEY not in metadata:
        raise PetastormMetadataError(
            "Dataset carries no JSON Unischema metadata (not a petastorm "
            "dataset, or one with a reference-pickled schema, which this "
            "package does not read yet)")
    return unischema_from_json(metadata[UNISCHEMA_JSON_KEY])


def get_schema_from_dataset_url(dataset_url):
    resolver = FilesystemResolver(dataset_url)
    return get_schema(resolver.filesystem(), resolver.get_dataset_path())


# ---------------------------------------------------------------------------
# Row-group enumeration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RowGroupPiece:
    """One unit of ventilated work: one row group of one file."""

    path: str
    row_group: int
    num_rows: int | None = None

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


def load_row_groups(filesystem, dataset_path):
    """The dataset's row groups in canonical order (sorted file path, then
    row-group index), from the footer's bookkeeping when present, else from
    a fragment scan."""
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
