"""Test support shipped with the port (its own copy of
``petastorm_tpu/test_util``): synthetic dataset factories, a schema-driven
fake reader, and a shuffle-quality metric."""
