"""Dataset materialization and metadata."""
