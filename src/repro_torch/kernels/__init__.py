"""Hand-written Hopper kernels with their plain PyTorch versions.

Nothing here builds or launches at import time: ``_build`` compiles the CUDA
sources at the first CUDA launch."""
