"""Reader internals (the row shuffling buffer)."""
