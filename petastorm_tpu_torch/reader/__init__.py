"""The columnar reader (``make_columnar_reader``)."""

from petastorm_tpu_torch.reader.reader import Reader, make_columnar_reader  # noqa: F401
