"""Deterministic order for the port's serving paths (the seed tree); the
data service itself is not ported."""
