"""PyTorch/CUDA port of ``repro`` (GEMEL merge-and-serve) for NVIDIA Hopper.

The package mirrors ``src/repro`` module for module and imports torch and
numpy only.  Entry points take an explicit ``device``; without one they run
on ``cuda`` and raise when no card is present.  Kernel ops dispatch on the
tensor's device: a CPU tensor takes the plain PyTorch version, a CUDA tensor
the hand-written Hopper kernel (or the call raises).
"""
