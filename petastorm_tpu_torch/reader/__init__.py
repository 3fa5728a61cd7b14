"""The row and columnar readers (``make_reader``, ``make_columnar_reader``)."""

from petastorm_tpu_torch.reader.reader import (  # noqa: F401
    Reader,
    make_columnar_reader,
    make_reader,
)
