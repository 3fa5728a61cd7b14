"""Fast recursive listing for GCS-backed datasets (the port's own copy of
``petastorm_tpu/gcsfs_helpers/gcsfs_fast_list.py``).

Dataset discovery over GCS would otherwise cost one ``ls`` round trip per
directory. GCS objects are flat keys, so one recursive ``find`` returns
files only; this module synthesizes the directory tree a path-based
consumer (pyarrow dataset discovery, ``fs.walk``) expects from that one
sweep:

- :func:`fast_list`: one ``find(detail=True)`` sweep, retried through
  :func:`petastorm_tpu_torch.utils.retry_with_backoff`;
- :func:`build_dircache`: flat ``{path: info}`` → ``{directory: [direct
  child infos]}`` with a pseudo-directory entry for every intermediate
  level;
- :func:`seed_listing_cache`: install that tree into an fsspec
  filesystem's ``dircache``;
- :class:`FastListingFilesystem`: a wrapper answering ``ls`` / ``info`` /
  ``isdir`` / ``isfile`` / ``exists`` / ``find`` / ``walk`` from one sweep
  and passing content operations through.

gcsfs is optional: it is imported only when no ``filesystem`` is given.
"""

from __future__ import annotations

DIRECTORY_TYPE = "directory"


def _strip_scheme(url):
    for scheme in ("gs://", "gcs://"):
        if url.startswith(scheme):
            return url[len(scheme):]
    return url


def fast_list(gcs_url, storage_options=None, detail=False, filesystem=None,
              retries=3, retry_base_delay=0.5):
    """List ``gs://bucket/prefix`` recursively with one ``find()`` sweep
    (gcsfs follows the listing pages itself). ``detail=True`` returns
    ``{path: info}``, else the sorted paths. The sweep retries ``retries``
    times with backoff; ``FileNotFoundError`` and ``PermissionError`` are
    never retried. ``filesystem``: any fsspec-compatible filesystem,
    default a ``gcsfs.GCSFileSystem(**storage_options)``."""
    from petastorm_tpu_torch.utils import retry_with_backoff

    if filesystem is None:
        try:
            import gcsfs
        except ImportError as exc:
            raise ImportError("gcsfs is required for GCS listing; pip install gcsfs, or "
                              "pass an fsspec filesystem explicitly") from exc
        filesystem = gcsfs.GCSFileSystem(**(storage_options or {}))
    path = _strip_scheme(gcs_url)
    listing = retry_with_backoff(
        lambda: filesystem.find(path, detail=True),
        retries=retries, base_delay=retry_base_delay,
        no_retry_on=(FileNotFoundError, PermissionError),
        description=f"GCS listing sweep of {path!r}")
    return listing if detail else sorted(listing)


def build_dircache(root, detail_listing):
    """Flat ``{file path: info}`` → ``{directory: [direct child infos]}``:
    every intermediate path component between ``root`` and a file becomes
    a ``type="directory"`` entry in its parent's list and gets a list of
    its own, so every directory under ``root`` has an entry. Zero-byte
    directory markers (the root itself, keys ending in ``/``) are left
    out; a path outside ``root`` raises ValueError."""
    root = _strip_scheme(root).rstrip("/")
    cache = {root: []}
    for path in sorted(detail_listing):
        info = dict(detail_listing[path])
        info.setdefault("name", path)
        info.setdefault("type", "file")
        if path == root or path.endswith("/"):
            continue
        if not path.startswith(root + "/"):
            raise ValueError(f"Listed path {path!r} is not under the root {root!r}")
        parent = root
        for part in path[len(root) + 1:].split("/")[:-1]:
            directory = parent + "/" + part
            if directory not in cache:
                cache[directory] = []
                cache[parent].append({"name": directory, "size": 0, "type": DIRECTORY_TYPE})
            parent = directory
        cache[parent].append(info)
    return cache


def seed_listing_cache(filesystem, prefix, detail_listing):
    """Seed ``filesystem.dircache`` with :func:`build_dircache` of a
    :func:`fast_list` detail result; returns ``filesystem``."""
    for parent, infos in build_dircache(prefix, detail_listing).items():
        filesystem.dircache[parent] = infos
    return filesystem


def warm_gcs_listing(filesystem, gcs_url):
    """Sweep ``gcs_url`` once and seed ``filesystem``'s dircache with the
    whole tree; returns the number of files listed."""
    listing = fast_list(gcs_url, detail=True, filesystem=filesystem)
    seed_listing_cache(filesystem, _strip_scheme(gcs_url), listing)
    return len(listing)


class FastListingFilesystem:
    """Serves one prefix's directory metadata from a single listing sweep.

    Construction runs one :func:`fast_list` of ``root`` and builds the
    pseudo-directory tree; ``ls`` / ``info`` / ``isdir`` / ``isfile`` /
    ``exists`` / ``find`` / ``walk`` answer from memory, and every other
    attribute (``open``, ``cat``, ...) is the wrapped filesystem's."""

    def __init__(self, filesystem, root):
        self._fs = filesystem
        self._root = _strip_scheme(root).rstrip("/")
        self._cache = build_dircache(
            self._root, fast_list(self._root, detail=True, filesystem=filesystem))
        self._info_by_path = {info["name"]: info
                              for infos in self._cache.values() for info in infos}

    def ls(self, path, detail=False):
        path = _strip_scheme(path).rstrip("/")
        if path in self._cache:
            infos = self._cache[path]
        elif path in self._info_by_path:
            infos = [self._info_by_path[path]]  # fsspec: ls of a file is its entry
        else:
            raise FileNotFoundError(path)
        return list(infos) if detail else [i["name"] for i in infos]

    def info(self, path):
        path = _strip_scheme(path).rstrip("/")
        if path in self._info_by_path:
            return self._info_by_path[path]
        if path == self._root or path in self._cache:
            return {"name": path, "size": 0, "type": DIRECTORY_TYPE}
        raise FileNotFoundError(path)

    def isdir(self, path):
        return _strip_scheme(path).rstrip("/") in self._cache

    def isfile(self, path):
        info = self._info_by_path.get(_strip_scheme(path).rstrip("/"))
        return info is not None and info["type"] != DIRECTORY_TYPE

    def exists(self, path):
        path = _strip_scheme(path).rstrip("/")
        return path in self._cache or path in self._info_by_path

    def find(self, path, maxdepth=None, withdirs=False, detail=False, **kwargs):
        """fsspec's ``find`` (pyarrow's ``FSSpecHandler`` drives recursive
        selectors through it), from the cached tree."""
        path = _strip_scheme(path).rstrip("/")

        def within(name):
            if not (name.startswith(path + "/") or name == path):
                return False
            if maxdepth is None or name == path:
                return True
            return name[len(path) + 1:].count("/") + 1 <= maxdepth

        out = {name: info for name, info in self._info_by_path.items()
               if (withdirs or info["type"] != DIRECTORY_TYPE) and within(name)}
        if withdirs and path in self._cache and path not in out:
            out[path] = self.info(path)  # fsspec includes the base directory
        out = dict(sorted(out.items()))
        return out if detail else list(out)

    def walk(self, path=None):
        """``(dirpath, [subdir names], [file names])`` like ``os.walk``."""
        stack = [_strip_scheme(path).rstrip("/") if path else self._root]
        while stack:
            current = stack.pop(0)
            infos = self._cache.get(current, [])
            dirs = [i["name"] for i in infos if i["type"] == DIRECTORY_TYPE]
            files = [i["name"] for i in infos if i["type"] != DIRECTORY_TYPE]
            yield (current, [d.rsplit("/", 1)[1] for d in dirs],
                   [f.rsplit("/", 1)[1] for f in files])
            stack.extend(dirs)

    def __getattr__(self, name):
        return getattr(self._fs, name)
