"""Checkpoint-side placement (the port of ``repro.ckpt``): reshard-on-load."""
