"""Exceptions of the port (counterpart of ``petastorm_tpu/errors.py``)."""


class NoDataAvailableError(Exception):
    """No row groups are left to read after planning."""


class PetastormMetadataError(Exception):
    """A dataset's petastorm metadata is missing or unreadable."""
