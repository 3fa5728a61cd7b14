"""Boot a function in a brand-new Python interpreter (never a fork).

The port's own copy of ``petastorm_tpu/workers_pool/exec_in_new_process.py``.
The parent of a decode pool usually holds a CUDA context, and CUDA does not
survive a fork, so a pool worker is a fresh interpreter:
``exec_in_new_process(func, *args, **kwargs)`` writes ``(func, args,
kwargs)`` with cloudpickle to a temp file and launches
``python -m petastorm_tpu_torch.workers_pool.exec_in_new_process <file>``;
the child unpickles it and calls ``func``.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

#: The module the child runs (``python -m``): what orphan checks match.
CHILD_MODULE = "petastorm_tpu_torch.workers_pool.exec_in_new_process"


def child_environment():
    """The child's environment: the parent's, with the parent's whole
    ``sys.path`` first in ``PYTHONPATH`` (the child must import what the
    parent can: the package from a source tree, a caller's module that
    defines the worker class) and ``CUDA_VISIBLE_DEVICES=""``, so a decode
    worker can never open the card."""
    env = dict(os.environ)
    parent_paths = [p for p in sys.path if p]
    existing = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(parent_paths + [p for p in existing
                                                        if p not in parent_paths])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def exec_in_new_process(func, *args, **kwargs):
    """Launch ``func(*args, **kwargs)`` in a new interpreter; returns the
    ``subprocess.Popen``. cloudpickle writes the payload, so a function or
    class defined in the caller's ``__main__`` travels by value; the child
    reads it with the standard unpickler."""
    import cloudpickle

    fd, payload_path = tempfile.mkstemp(prefix="petastorm_torch_spawn_", suffix=".pkl")
    with os.fdopen(fd, "wb") as f:
        cloudpickle.dump((func, args, kwargs), f, protocol=pickle.HIGHEST_PROTOCOL)
    return subprocess.Popen([sys.executable, "-m", CHILD_MODULE, payload_path],
                            env=child_environment())


def _main():
    payload_path = sys.argv[1]
    with open(payload_path, "rb") as f:
        func, args, kwargs = pickle.load(f)  # noqa: S301 - written by our parent
    try:
        os.unlink(payload_path)
    except OSError:
        pass
    func(*args, **kwargs)


if __name__ == "__main__":
    _main()
