"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/*.cu`` source compiles on its own, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface, loaded with
:mod:`ctypes`. The libraries go into ``ops/_build/<hash>/`` (git-ignored),
keyed by a hash of every source and header plus the compile flags, so an
edited kernel rebuilds and an unchanged one loads at once. All sources
compile in parallel, one ``nvcc`` process each. Nothing here runs at import
time: the first kernel launch triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu", "sparse_sgd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS = {}


def find_nvcc():
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "ops/csrc at first use")
    return found


def _source_hash():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            digest.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                digest.update(f.read())
    return digest.hexdigest()[:16]


def compile_source(src, out, defines=(), flags=(), csrc=CSRC):
    """Start ``nvcc`` on ``<csrc>/<src>`` (by default this package's
    ``csrc/``) into the shared library ``out``, with ``-D`` ``defines`` (a
    source's build-time switches) and further nvcc ``flags``; return the
    process, its stdout and stderr piped together."""
    cmd = [find_nvcc(), *NVCC_FLAGS, *flags, *(f"-D{d}" for d in defines),
           "-o", out, os.path.join(csrc, src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def build_all():
    """Compile every missing library (in parallel) and return the build
    directory. Raises with the compiler's output when a source fails."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    todo = [src for src in SOURCES
            if not os.path.isfile(os.path.join(out_dir, _lib_name(src)))]
    if todo:
        procs = {}
        for src in todo:
            tmp = os.path.join(out_dir, f".{_lib_name(src)}.{os.getpid()}.tmp")
            procs[src] = (tmp, compile_source(src, tmp))
        failures = []
        for src, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src} (exit {proc.returncode}):\n"
                                f"{out.decode(errors='replace')}")
            else:
                os.replace(tmp, os.path.join(out_dir, _lib_name(src)))
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return out_dir


def _lib_name(src):
    return "lib" + os.path.splitext(src)[0] + ".so"


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q, k, v, o, lse, qseg, kvseg, kv_lens, B, H, Hkv, Tq, Tkv, D, dtype,
    # causal, causal_offset, scale, stream
    "ptt_flash_fwd": [_P] * 8 + [_I] * 9 + [_F, _P],
    # q, k, v, o, dout, lse, dlse (or null), delta, dq, qseg, kvseg, kv_lens, ...
    "ptt_flash_bwd_dq": [_P] * 12 + [_I] * 9 + [_F, _P],
    # q, k, v, dout, lse, delta, dk, dv, qseg, kvseg, kv_lens, ...
    "ptt_flash_bwd_dkv": [_P] * 11 + [_I] * 9 + [_F, _P],
    # out (host, 2 x uint64); only in flash_fwd.cu built with
    # PTT_FWD_COUNT_TILES=1, flash_bwd_dq.cu with PTT_DQ_COUNT_TILES=1 and
    # flash_bwd_dkv.cu with PTT_DKV_COUNT_TILES=1
    "ptt_flash_fwd_tile_counts": [_P],
    "ptt_flash_bwd_dq_tile_counts": [_P],
    "ptt_flash_bwd_dkv_tile_counts": [_P],
    # table, sorted keys, order, grads, touched, N, D, lr, stream
    "ptt_sparse_sgd": [_P] * 5 + [ctypes.c_longlong, _I, _F, _P],
}
_SYMBOL_SOURCE = {"ptt_flash_fwd": "flash_fwd.cu",
                  "ptt_flash_bwd_dq": "flash_bwd_dq.cu",
                  "ptt_flash_bwd_dkv": "flash_bwd_dkv.cu",
                  "ptt_sparse_sgd": "sparse_sgd.cu"}


def load(lib, symbol):
    """The ctypes function ``symbol`` of the shared library ``lib``."""
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def kernel(symbol):
    """The ctypes function ``symbol``, building the libraries on first use."""
    with _LOCK:
        fn = _LIBS.get(symbol)
        if fn is None:
            out_dir = build_all()
            fn = load(os.path.join(out_dir, _lib_name(_SYMBOL_SOURCE[symbol])),
                      symbol)
            _LIBS[symbol] = fn
        return fn
