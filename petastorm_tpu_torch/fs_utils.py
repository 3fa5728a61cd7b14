"""Dataset URL → pyarrow filesystem + path.

Counterpart of ``petastorm_tpu/fs_utils.py::FilesystemResolver``, cut to
what the port's main path reads: local paths and ``file://`` URLs, on
``pyarrow.fs.LocalFileSystem``. (Remote schemes — s3, gs, hdfs, fsspec —
are not ported yet.)
"""

from __future__ import annotations

from urllib.parse import urlparse

import pyarrow.fs as pafs


class FilesystemResolver:
    """Resolves a dataset URL into a ``pyarrow.fs.FileSystem`` + path."""

    def __init__(self, dataset_url):
        if not isinstance(dataset_url, str):
            raise ValueError(
                f"dataset_url must be a string, got {type(dataset_url)}")
        url = dataset_url.rstrip("/")
        parsed = urlparse(url)
        if parsed.scheme not in ("", "file"):
            raise ValueError(
                f"Unsupported dataset URL scheme {parsed.scheme!r} in "
                f"{dataset_url!r}: this package reads local paths and "
                "file:// URLs")
        self._filesystem = pafs.LocalFileSystem()
        self._path = parsed.path if parsed.scheme == "file" else url

    def filesystem(self):
        return self._filesystem

    def get_dataset_path(self):
        return self._path
