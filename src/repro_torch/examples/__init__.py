"""Runnable examples of the port (``python -m repro_torch.examples.<name>``);
the JAX package's own examples stay under ``examples/``."""
