"""Numpy bridge between the JAX package's parameter trees and the port's.

Parity tests never re-draw parameters (torch cannot reproduce
``jax.random`` streams): the JAX package's params cross as numpy arrays,
leaf by leaf along the shared flat paths.  bfloat16 travels through a
16-bit integer view in both directions, so the round trip is bitwise.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, unflatten_paths


def array_to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; needed only to hand bf16 out

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, device: Optional[Any] = None) -> dict:
    """Nested numpy/JAX array tree -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return unflatten_paths({p: array_to_tensor(leaf, dev)
                            for p, leaf in flatten_paths(tree).items()})


def to_numpy(tree: Any) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays (host copies)."""
    return unflatten_paths({p: tensor_to_array(leaf)
                            for p, leaf in flatten_paths(tree).items()})
