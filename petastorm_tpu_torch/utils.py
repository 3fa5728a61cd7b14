"""Column-wise decode of a row group (the port's own copy of
``petastorm_tpu/utils.py::decode_table``) and the row-drop partition of a
table, shared by the reader's workers; the reference's per-row
``decode_row``; the live resize of a bounded queue
(``resize_bounded_queue``), which the loader's prefetch depths use; the
retry policy (``retry_with_backoff``, ``backoff_delays``) of the GCS listing
sweep and the data service's control RPCs; and ``run_in_subprocess``."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.schema.codecs import ScalarCodec


class DecodeFieldError(RuntimeError):
    pass


def column_cells(column):
    """An arrow column as numpy cells; a column with nulls becomes an object
    array holding None (``to_numpy`` would turn int-with-null into NaN)."""
    if column.null_count:
        out = np.empty(len(column), dtype=object)
        for i, value in enumerate(column.to_pylist()):
            out[i] = value
        return out
    return column.to_numpy(zero_copy_only=False)


def decode_table(table, schema):
    """A row group's ``pa.Table`` → a list of decoded row dicts, one column
    at a time: a codec column through ``codec.decode_column`` (one imdecode /
    np.load pass into an ``[N, ...]`` block, one ``astype`` for numeric
    scalars), a codec-less tensor field (a Parquet list column) as one
    ndarray per cell, a codec-less scalar through ``ScalarCodec``. Columns
    not in ``schema`` are left out; null cells stay None."""
    names, columns = [], []
    for name in table.column_names:
        field = schema.fields.get(name)
        if field is None:
            continue
        names.append(name)
        columns.append(_decode_column(column_cells(table.column(name)), field))
    return [dict(zip(names, values)) for values in zip(*columns)]


def _decode_column(cells, field):
    try:
        if field.codec is not None:
            return field.codec.decode_column(field, cells)
        if field.shape:
            dtype = np.dtype(field.numpy_dtype)
            return [None if v is None else np.asarray(v, dtype=dtype) for v in cells]
        return ScalarCodec().decode_column(field, cells)
    except Exception as exc:
        raise DecodeFieldError(f"Decoding field {field.name!r} failed: {exc}") from exc


def decode_row(row, schema):
    """One stored row dict → its decoded values (the reference's public
    per-row decode): a field with a codec through it, a codec-less tensor
    field as an ndarray of its dtype, a codec-less scalar through
    ``ScalarCodec``; None stays None, fields not in ``schema`` are left
    out."""
    decoded = {}
    for name, value in row.items():
        field = schema.fields.get(name)
        if field is None:
            continue
        try:
            if value is None:
                decoded[name] = None
            elif field.codec is not None:
                decoded[name] = field.codec.decode(field, value)
            elif field.shape:
                decoded[name] = np.asarray(value, dtype=np.dtype(field.numpy_dtype))
            else:
                decoded[name] = ScalarCodec().decode(field, value)
        except Exception as exc:
            raise DecodeFieldError(f"Decoding field {name!r} failed: {exc}") from exc
    return decoded


def drop_partition(table, shuffle_row_drop_partition):
    """Rows ``this::num_partitions`` of ``table`` for
    ``shuffle_row_drop_partition = (this, num_partitions)``."""
    this_partition, num_partitions = shuffle_row_drop_partition
    if num_partitions <= 1:
        return table
    return table.take(pa.array(np.arange(this_partition, table.num_rows, num_partitions)))


def resize_bounded_queue(q, maxsize):
    """Set a ``queue.Queue``'s bound while it is in use: waiters blocked on
    the old bound are woken, so a raise takes effect at once, and a shrink
    lets the queue drain down to the new bound (``put`` re-checks
    ``maxsize`` under the mutex, so nothing is dropped). ``mutex`` and
    ``not_full`` share one lock in ``queue.Queue``."""
    with q.mutex:
        q.maxsize = int(maxsize)
        q.not_full.notify_all()


def retry_with_backoff(fn, retries=3, base_delay=0.1, max_delay=5.0, jitter=0.5,
                       retry_on=(Exception,), no_retry_on=(), description=None,
                       sleep=None, rng=None, deadline_s=None, clock=None, budget=None):
    """Call ``fn()`` with bounded retries, exponential backoff and jitter:
    the transient-failure policy of the GCS listing sweep and of every
    control RPC of the data service (the port's own copy of
    ``petastorm_tpu/utils.py::retry_with_backoff``; the same ``sleep`` /
    ``rng`` / ``clock`` injections give the same delays).

    ``retries`` attempts follow the first; the last failure re-raises.
    Delays are :func:`backoff_delays`. ``no_retry_on`` types fail at once
    even when they match ``retry_on``. ``deadline_s`` bounds attempts and
    sleeps together, measured from the first call: a sleep that would cross
    it re-raises instead. ``budget``: an object with ``try_spend()`` (each
    retry spends a token; an empty bucket stops retrying) and
    ``record_success()`` (called on success)."""
    import logging
    import time

    sleep = sleep if sleep is not None else time.sleep
    clock = clock if clock is not None else time.monotonic
    start = clock()
    delays = backoff_delays(retries, base_delay, max_delay, jitter=jitter, rng=rng)
    label = description or getattr(fn, "__name__", "call")
    for attempt in range(retries + 1):
        try:
            result = fn()
            if budget is not None:
                budget.record_success()
            return result
        except no_retry_on:
            raise
        except retry_on as exc:
            if attempt == retries:
                raise
            delay = next(delays)
            log = logging.getLogger(__name__)
            if deadline_s is not None and clock() - start + delay >= deadline_s:
                log.warning("%s failed (attempt %d/%d): %s — deadline budget %.2fs "
                            "exhausted, not retrying", label, attempt + 1, retries + 1,
                            exc, deadline_s)
                raise
            if budget is not None and not budget.try_spend():
                log.warning("%s failed (attempt %d/%d): %s — retry budget exhausted, "
                            "not retrying", label, attempt + 1, retries + 1, exc)
                raise
            log.warning("%s failed (attempt %d/%d): %s — retrying in %.2fs",
                        label, attempt + 1, retries + 1, exc, delay)
            sleep(delay)


def backoff_delays(retries, base_delay, max_delay, jitter=0.5, rng=None):
    """The delays :func:`retry_with_backoff` sleeps, as a generator (for a
    caller that must keep yielding between attempts, such as the service
    client's fcfs split loop): ``min(max_delay, base_delay * 2**attempt)``
    scaled by ``1 + jitter * rng.random()``."""
    import random

    rng = rng if rng is not None else random
    for attempt in range(retries):
        delay = min(max_delay, base_delay * (2 ** attempt))
        yield delay * (1.0 + jitter * rng.random())


def run_in_subprocess(func, *args, **kwargs):
    """``func(*args, **kwargs)`` run in a fresh ``spawn`` child process, and
    its result: for work that must not touch this process (a CUDA context,
    a library that forks). ``func`` and its arguments must pickle
    (``func`` defined at module level)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(func, args, kwargs)
