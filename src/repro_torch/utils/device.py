"""Device resolution for the port's entry points.

No entry point silently falls back to the CPU: the default device is
``cuda``, and asking for ``cuda`` on a host without a card raises.  The CPU
(tests) and ``meta`` (shape-only parameter trees) are used only when the
caller names them.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "explicitly to run on the CPU")
    return dev
