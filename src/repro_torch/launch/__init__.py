"""Launchers (the port of ``repro.launch``): ``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``, and
the production mesh and rules of ``launch.mesh``."""
