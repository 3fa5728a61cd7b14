"""One structured logger helper (the port's own copy of
``petastorm_tpu/telemetry/log.py``).

- **namespace**: a service logger lives under
  ``petastorm_tpu_torch.service.<module>``, so one
  ``logging.getLogger("petastorm_tpu_torch.service").setLevel(...)``
  governs them all;
- **context fields**: ``bind(worker_id=...)`` attaches ``key=value`` pairs
  appended to every line (per-call ``**fields`` add one-off pairs), so
  ``grep 'worker_id=w-1'`` reconstructs one node's timeline from an
  interleaved log.

Usage::

    logger = service_logger(__name__)                 # module level
    self._log = logger.bind(worker_id=self.worker_id) # instance context
    self._log.warning("lease missed", attempt=7)
    # -> "lease missed | worker_id=w-1 attempt=7"
"""

from __future__ import annotations

import logging

_SERVICE_ROOT = "petastorm_tpu_torch.service"


def _canonical_name(name):
    """Map any module name of this package to its
    ``petastorm_tpu_torch.service.*`` namespace (idempotent for names
    already under it; other callers keep their own)."""
    if name.startswith(_SERVICE_ROOT) or not name.startswith("petastorm_tpu_torch"):
        return name
    return f"{_SERVICE_ROOT}.{name.rsplit('.', 1)[-1]}"


class StructuredLogger:
    """A thin wrapper over :mod:`logging` that appends bound + per-call
    context fields as ``key=value`` pairs. Cheap by construction: fields
    are formatted only when the record will actually be emitted."""

    __slots__ = ("_logger", "_context")

    def __init__(self, logger, context=None):
        self._logger = logger
        self._context = dict(context or {})

    def bind(self, **fields):
        """A child logger with ``fields`` merged into the bound context."""
        merged = dict(self._context)
        merged.update(fields)
        return StructuredLogger(self._logger, merged)

    @property
    def name(self):
        return self._logger.name

    def _log(self, level, msg, args, exc_info=False, **fields):
        if not self._logger.isEnabledFor(level):
            return
        # %-format the caller's args BEFORE appending context fields, and
        # hand logging a fully-formatted string with no args: a field
        # value containing '%' (a client_id off the wire, a reason
        # string) must never be re-interpreted as a format directive —
        # that would raise inside logging and DROP the line.
        if args:
            try:
                msg = msg % args
            except (TypeError, ValueError):  # malformed caller format:
                msg = f"{msg} {args!r}"      # degrade, never drop the line
        context = dict(self._context)
        context.update(fields)
        if context:
            suffix = " ".join(f"{k}={v}" for k, v in context.items())
            msg = f"{msg} | {suffix}"
        self._logger.log(level, msg, exc_info=exc_info)

    def debug(self, msg, *args, **fields):
        self._log(logging.DEBUG, msg, args, **fields)

    def info(self, msg, *args, **fields):
        self._log(logging.INFO, msg, args, **fields)

    def warning(self, msg, *args, **fields):
        self._log(logging.WARNING, msg, args, **fields)

    def error(self, msg, *args, **fields):
        self._log(logging.ERROR, msg, args, **fields)

    def exception(self, msg, *args, **fields):
        self._log(logging.ERROR, msg, args, exc_info=True, **fields)

    def isEnabledFor(self, level):  # noqa: N802 - logging API parity
        return self._logger.isEnabledFor(level)


def service_logger(name, **context):
    """The structured logger for a service module: canonical
    ``petastorm_tpu_torch.service.*`` namespace plus optional bound
    context."""
    return StructuredLogger(logging.getLogger(_canonical_name(name)),
                            context)
