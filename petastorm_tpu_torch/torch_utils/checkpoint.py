"""Joint model + input-pipeline checkpoints (counterpart of
``petastorm_tpu/jax_utils/checkpoint.py``, with ``torch.save`` in place of
orbax).

A preempted job must restore both halves consistently: the arrays (a dict
of tensors or ``state_dict`` s) and the input state each rank's loader or
reader gave (``TorchDataLoader.state_dict()``, captured between steps). The
directory protocol is the JAX package's, name for name, so the input state
of a checkpoint either package wrote reads in the other:

- ``CURRENT`` names the published version ``v<n>``;
- ``v<n>/arrays/arrays.pt`` holds the arrays, written by the group's first
  rank (data-parallel ranks hold the same ones) and read back with
  ``torch.load(weights_only=True)``;
- ``v<n>/input_state.<rank>.json`` holds each rank's input state, and
  ``v<n>/COMMITTED.<rank>`` certifies that rank's part was written.

Crash safety: each file is written to ``.tmp`` and published with
``os.replace``; a save clears its version directory, writes a complete
version, and only then moves ``CURRENT`` to it, so a crash at any point
leaves ``CURRENT`` on the last complete checkpoint; superseded ``v<int>``
directories (and nothing else in the directory) are pruned afterwards.
Restore refuses a torn version (this rank's commit marker missing) and one
saved by another number of ranks.

Under a group every rank reads ``CURRENT`` itself, and a stale read (an NFS
attribute cache) would make ranks disagree on the version. The version is
agreed on the MAX of every rank's next number (``all_reduce(MAX)``), not the
first rank's: with the first rank's, a first rank that read a stale
``CURRENT`` picks the published version's own number and clears it before
writing, and a crash then loses the last good checkpoint (the JAX
package's ``_agree_version`` broadcast). The maximum is never a published
version.
"""

from __future__ import annotations

import json
import os
import shutil

import torch
import torch.distributed as dist

_INPUT_STATE_TMPL = "input_state.{}.json"
_COMMIT_MARKER_PREFIX = "COMMITTED."
_CURRENT_FILE = "CURRENT"
_VERSION_TMPL = "v{}"
_ARRAYS_DIR = "arrays"
_ARRAYS_FILE = "arrays.pt"


def _rank(group):
    return 0 if group is None else dist.get_rank(group)


def _world(group):
    return 1 if group is None else dist.get_world_size(group)


def _barrier(group):
    """Ranks must not race each other through the version's lifecycle on a
    shared filesystem (a no-op for one process)."""
    if _world(group) > 1:
        dist.barrier(group=group)


def _agree_version(next_num, group):
    """The largest of the ranks' next version numbers."""
    if _world(group) == 1:
        return next_num
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    num = torch.tensor([next_num], dtype=torch.int64, device=device)
    dist.all_reduce(num, op=dist.ReduceOp.MAX, group=group)
    return int(num.item())


def _is_version_name(name):
    """Strictly ``v<int>``: the only names this module creates; anything
    else in the directory is the user's and is never pruned."""
    return name.startswith("v") and name[1:].isdigit()


def _read_current(directory):
    """The version ``CURRENT`` names, or None if nothing was published."""
    try:
        with open(os.path.join(directory, _CURRENT_FILE)) as f:
            name = f.read().strip()
        return name or None
    except OSError:
        return None


def _publish(path, write):
    """``write(tmp_path)``, then ``os.replace`` onto ``path``."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_text(text):
    def write(tmp):
        with open(tmp, "w") as f:
            f.write(text)
    return write


def save_training_state(directory, arrays, loader=None, input_state=None, force=True,
                        group=None):
    """Write ``arrays`` and this rank's input state under ``directory`` as a
    new version, then publish it.

    :param arrays: a dict of tensors or ``state_dict`` s (plain containers:
        ``torch.load(weights_only=True)`` reads them back).
    :param loader: a :class:`~.loader.TorchDataLoader` to snapshot with its
        ``state_dict()`` (call between steps). Exclusive with
        ``input_state``.
    :param input_state: a state dict captured beforehand.
    :param force: overwrite an existing checkpoint; the previous one stays
        restorable until the new one is complete.
    :param group: the ``torch.distributed`` group of ranks saving together
        (every rank calls this); None for one process.
    :return: ``directory`` as an absolute path.
    """
    if loader is not None and input_state is not None:
        raise ValueError("pass loader OR input_state, not both")
    if loader is not None:
        input_state = loader.state_dict()
    directory = os.path.abspath(directory)
    current = _read_current(directory)
    if current is not None and not force:
        raise ValueError(f"checkpoint already exists at {directory} "
                         "(pass force=True to overwrite)")
    os.makedirs(directory, exist_ok=True)
    next_num = int(current[1:]) + 1 if current and _is_version_name(current) else 1
    version = _VERSION_TMPL.format(_agree_version(next_num, group))
    vdir = os.path.join(directory, version)
    rank = _rank(group)
    _barrier(group)
    if rank == 0:
        shutil.rmtree(vdir, ignore_errors=True)  # debris of a crashed save
    _barrier(group)
    _write_checkpoint(vdir, arrays, input_state, group)
    # Every rank's files and marker are on disk before CURRENT moves.
    _barrier(group)
    if rank == 0:
        _publish(os.path.join(directory, _CURRENT_FILE), _write_text(version))
        for name in os.listdir(directory):
            if (name != version and _is_version_name(name)
                    and os.path.isdir(os.path.join(directory, name))):
                shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    _barrier(group)
    return directory


def _write_checkpoint(vdir, arrays, input_state, group):
    rank = _rank(group)
    os.makedirs(os.path.join(vdir, _ARRAYS_DIR), exist_ok=True)
    if rank == 0:
        _publish(os.path.join(vdir, _ARRAYS_DIR, _ARRAYS_FILE),
                 lambda tmp: torch.save(arrays, tmp))
    if input_state is not None:
        _publish(os.path.join(vdir, _INPUT_STATE_TMPL.format(rank)),
                 _write_text(json.dumps(input_state)))
    # The marker goes last: it certifies this rank's part is complete.
    _publish(os.path.join(vdir, _COMMIT_MARKER_PREFIX + str(rank)), _write_text("ok"))


def restore_input_state(directory, group=None):
    """``(version directory, this rank's input state or None)`` of the
    checkpoint ``CURRENT`` names, after the torn-save and rank-count checks
    (the arrays are not read: this works on a checkpoint of either
    package)."""
    directory = os.path.abspath(directory)
    current = _read_current(directory)
    if current is None:
        raise RuntimeError(
            f"no published checkpoint at {directory} (missing/empty "
            f"{_CURRENT_FILE}): either nothing was saved here or every "
            "save crashed before completing")
    vdir = os.path.join(directory, current)
    rank, world = _rank(group), _world(group)
    if not os.path.exists(os.path.join(vdir, _COMMIT_MARKER_PREFIX + str(rank))):
        raise RuntimeError(
            f"checkpoint {current} at {directory} has no commit marker for "
            f"rank {rank}: the save did not complete on this rank (torn "
            "checkpoint) — restoring it could pair arrays with stale or "
            "missing input state")
    saved = len([n for n in os.listdir(vdir)
                 if n.startswith(_COMMIT_MARKER_PREFIX) and not n.endswith(".tmp")])
    if saved != world:
        raise RuntimeError(
            f"checkpoint {current} at {directory} was saved by {saved} "
            f"rank(s) but {world} are restoring: the other ranks' input "
            "positions would be silently dropped — restore with the same "
            "number of ranks")
    path = os.path.join(vdir, _INPUT_STATE_TMPL.format(rank))
    if not os.path.exists(path):
        return vdir, None
    with open(path) as f:
        return vdir, json.load(f)


def restore_training_state(directory, map_location=None, group=None):
    """``(arrays, input state or None)`` of the published checkpoint under
    ``directory``; pass the input state as ``resume_state=`` to the reader
    factory feeding a fresh loader (buffered rows are re-read:
    at-least-once).

    :param map_location: as ``torch.load``'s (the arrays come back on the
        devices they were saved from otherwise).
    :raises RuntimeError: nothing published, a torn version, or another
        number of ranks than saved it.
    """
    vdir, input_state = restore_input_state(directory, group)
    arrays = torch.load(os.path.join(vdir, _ARRAYS_DIR, _ARRAYS_FILE),
                        map_location=map_location, weights_only=True)
    return arrays, input_state
