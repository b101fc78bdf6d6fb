"""Checkpoints (the port of ``repro.ckpt``): the dedup-aware
``CheckpointManager`` and reshard-on-load."""
