"""One file a metric, ``<metric name>.py``, loaded by path: its
``read(ctx)`` returns the value, or None where the run has nothing to
read (see :class:`perfbench.runner.RunContext`)."""
