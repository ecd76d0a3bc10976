"""Runnable twins of the JAX package's examples (``python -m
bagua_tpu_torch.examples.<name>``)."""
