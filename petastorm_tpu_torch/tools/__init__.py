"""Operator tools of the port (``python -m petastorm_tpu_torch.tools.<name>``)."""
