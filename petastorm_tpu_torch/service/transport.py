"""The data plane's transport mode (the port's own copy of
``petastorm_tpu/service/transport.py``'s mode resolution).

Mode resolution, on both sides: an explicit argument, else the
``PETASTORM_TRANSPORT`` environment variable, else ``"auto"``. ``"tcp"``
and ``"auto"`` both serve framed TCP; ``"auto"`` advertises no
shared-memory tier, which is what the JAX package does when no shm is
negotiated. An explicit ``"shm"`` raises NotImplementedError: the
shared-memory ring comes with the data service's slice (e).
"""

from __future__ import annotations

import os

MODES = ("auto", "tcp", "shm")


def resolve_mode(value=None):
    """The transport mode: ``value``, else ``$PETASTORM_TRANSPORT``, else
    ``"auto"``. ``"shm"`` raises NotImplementedError."""
    mode = value if value is not None else os.environ.get("PETASTORM_TRANSPORT") or "auto"
    mode = str(mode).lower()
    if mode not in MODES:
        raise ValueError(f"transport must be one of {MODES}, got {value!r}")
    if mode == "shm":
        raise NotImplementedError(
            "transport='shm' is not ported yet: the shared-memory ring comes with the "
            "data service's slice (e); 'auto' and 'tcp' serve framed TCP")
    return mode
