"""Per-batch tracing of the loader (:mod:`.tracing`). The metrics registry,
its exporters and the flight recorder of ``petastorm_tpu.telemetry`` are
not ported."""
