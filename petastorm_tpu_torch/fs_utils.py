"""Dataset URL → pyarrow filesystem + path.

The port's own copy of ``petastorm_tpu/fs_utils.py``. Every scheme goes
through ``pyarrow.fs.FileSystem``: local paths and ``file://`` on
``LocalFileSystem``; ``s3://`` (``s3a`` / ``s3n`` renamed) and ``gs://``
(``gcs`` renamed) through ``FileSystem.from_uri``, or through fsspec when
``storage_options`` are given; anything fsspec opens (``memory://``, ...)
with ``storage_options``; a caller's pyarrow or fsspec ``filesystem``
short-circuits resolution. fsspec filesystems are wrapped in
``pyarrow.fs.PyFileSystem(FSSpecHandler(...))``.

``fast_gcs_listing=True`` resolves ``gs://`` through
:class:`~petastorm_tpu_torch.gcsfs_helpers.gcsfs_fast_list.
FastListingFilesystem`: one recursive listing sweep serves dataset
discovery from memory. ``hdfs://`` URLs resolve their HA namenodes and
connect with failover through ``pyarrow.fs.HadoopFileSystem``
(:func:`~petastorm_tpu_torch.hdfs.namenode.connect_hdfs`).
"""

from __future__ import annotations

import logging
from urllib.parse import urlparse

import pyarrow.fs as pafs

_OBJECT_STORE_SCHEMES = ("s3", "s3a", "s3n", "gs", "gcs")


class FilesystemResolver:
    """Resolves a dataset URL into a ``pyarrow.fs.FileSystem`` + path.

    ``storage_options``: fsspec keyword arguments (any scheme with them
    resolves through fsspec). ``filesystem``: a pyarrow or fsspec
    filesystem to use as is; the path is the URL without its scheme (and
    with the bucket for s3 / gs). ``user``: the HDFS user.
    ``fast_gcs_listing``: resolve ``gs://`` through the one-sweep listing
    wrapper (read-only uses only: the cached tree would be stale under
    concurrent writes, so the writer never sets it).
    """

    def __init__(self, dataset_url, hadoop_configuration=None, connector=None,
                 hdfs_driver="libhdfs", user=None, storage_options=None,
                 filesystem=None, fast_gcs_listing=False):
        if not isinstance(dataset_url, str):
            raise ValueError(f"dataset_url must be a string, got {type(dataset_url)}")
        self._dataset_url = dataset_url.rstrip("/")
        self._user = user
        self._hadoop_configuration = hadoop_configuration
        self._storage_options = storage_options or {}
        self._fast_gcs_listing = fast_gcs_listing
        parsed = urlparse(self._dataset_url)
        self._scheme = parsed.scheme

        if filesystem is not None:
            self._filesystem = _ensure_arrow_filesystem(filesystem)
            self._path = _strip_scheme(self._dataset_url)
            return
        if self._scheme in ("", "file"):
            self._filesystem = pafs.LocalFileSystem()
            self._path = parsed.path if self._scheme == "file" else self._dataset_url
        elif self._scheme == "hdfs":
            self._filesystem, self._path = self._resolve_hdfs(parsed)
        elif self._scheme in _OBJECT_STORE_SCHEMES or self._storage_options:
            self._filesystem, self._path = self._resolve_remote(parsed)
        else:
            try:
                self._filesystem, self._path = pafs.FileSystem.from_uri(self._dataset_url)
            except Exception as exc:
                raise ValueError(f"Unsupported dataset URL scheme {self._scheme!r} in "
                                 f"{dataset_url!r}: {exc}") from exc

    def _resolve_hdfs(self, parsed):
        from petastorm_tpu_torch.hdfs.namenode import connect_hdfs

        return connect_hdfs(parsed, user=self._user,
                            hadoop_configuration=self._hadoop_configuration)

    def _resolve_remote(self, parsed):
        url = self._dataset_url
        if self._scheme in ("s3a", "s3n"):
            url = "s3" + url[len(self._scheme):]
        if self._scheme == "gcs":
            url = "gs" + url[len(self._scheme):]
        if self._scheme in ("gs", "gcs") and self._fast_gcs_listing:
            resolved = self._resolve_gcs_fast(url)
            if resolved is not None:
                return resolved
        if self._storage_options:
            import fsspec

            fs, path = fsspec.core.url_to_fs(url, **self._storage_options)
            return _ensure_arrow_filesystem(fs), path
        return pafs.FileSystem.from_uri(url)

    def _resolve_gcs_fast(self, url):
        """``gs://`` through the one-sweep listing wrapper, or None (fall
        back to the default resolution) when nothing implements fsspec's
        ``gs`` protocol. Content reads then go through fsspec, not
        pyarrow's native GCS client."""
        from petastorm_tpu_torch.gcsfs_helpers.gcsfs_fast_list import FastListingFilesystem

        try:
            import fsspec

            fs, path = fsspec.core.url_to_fs(url, **self._storage_options)
        except (ImportError, ValueError) as exc:
            logging.getLogger(__name__).debug(
                "fast GCS listing unavailable (%s); falling back to per-directory "
                "discovery", exc)
            return None
        return _ensure_arrow_filesystem(FastListingFilesystem(fs, path)), path

    def filesystem(self):
        return self._filesystem

    def get_dataset_path(self):
        return self._path

    @property
    def parsed_dataset_url(self):
        return urlparse(self._dataset_url)


def _ensure_arrow_filesystem(filesystem):
    """A pyarrow filesystem as is; an fsspec one wrapped for pyarrow."""
    if isinstance(filesystem, pafs.FileSystem):
        return filesystem
    try:
        return pafs.PyFileSystem(pafs.FSSpecHandler(filesystem))
    except Exception as exc:
        raise ValueError(f"Cannot adapt filesystem {filesystem!r}: {exc}") from exc


def _strip_scheme(url):
    """The path a caller's ``filesystem`` is given: the URL's path, with
    the bucket for s3 / gs."""
    parsed = urlparse(url)
    if parsed.scheme in ("", "file"):
        return parsed.path or url
    return (parsed.netloc + parsed.path) if parsed.scheme in ("s3", "gs", "gcs") \
        else parsed.path


def get_filesystem_and_path_or_paths(url_or_urls, hdfs_driver="libhdfs",
                                     storage_options=None, filesystem=None,
                                     fast_gcs_listing=False):
    """``(filesystem, path)`` of one URL, or ``(filesystem, [paths])`` of a
    list of URLs sharing one scheme (the first URL's filesystem serves
    them all). Fast GCS listing applies to a single URL only: its cache is
    rooted at one prefix."""
    urls = url_or_urls if isinstance(url_or_urls, list) else [url_or_urls]
    if not urls:
        raise ValueError("Empty dataset URL list")
    schemes = {urlparse(u).scheme for u in urls}
    if len(schemes) > 1:
        raise ValueError(f"All dataset URLs must share one scheme, got {schemes}")
    resolvers = [FilesystemResolver(u, hdfs_driver=hdfs_driver,
                                    storage_options=storage_options,
                                    filesystem=filesystem,
                                    fast_gcs_listing=fast_gcs_listing and len(urls) == 1)
                 for u in urls]
    paths = [r.get_dataset_path() for r in resolvers]
    return resolvers[0].filesystem(), paths if isinstance(url_or_urls, list) else paths[0]


def get_dataset_path(parsed_url):
    """The path part of a parsed dataset URL (with the bucket for s3 / gs)."""
    if parsed_url.scheme in _OBJECT_STORE_SCHEMES:
        return parsed_url.netloc + parsed_url.path
    return parsed_url.path
