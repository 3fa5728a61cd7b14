"""Models that consume the port's batches."""
