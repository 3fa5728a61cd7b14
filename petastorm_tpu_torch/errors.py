"""Exceptions of the port (counterpart of ``petastorm_tpu/errors.py``, with
the same base classes)."""


class NoDataAvailableError(RuntimeError):
    """No row groups are left to read after planning."""


class PetastormMetadataError(RuntimeError):
    """A dataset's petastorm metadata is missing or unreadable."""


class PetastormMetadataGenerationError(PetastormMetadataError):
    """Metadata (re)generation failed for a dataset."""
