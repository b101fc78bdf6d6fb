"""Architectural signatures (the port of ``repro.core.signatures``, the
records subset): two layers can merge iff their structural identity (op
kind from the path, shape, dtype) matches, excluding weights.

A signature is ``(kind, shape, dtype_name)`` with the numpy dtype name, so
the port's signatures, group ids and store keys equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.utils.tree import dtype_name, flatten_paths, leaf_bytes


@dataclasses.dataclass(frozen=True)
class LayerRecord:
    model_id: str
    path: str  # addressable path within the model ("layer name")
    signature: tuple  # hashable structural identity
    bytes: int
    position: float  # 0..1 normalised position within the model (start→end)

    @property
    def key(self) -> tuple:
        return (self.model_id, self.path)


def _kind_from_path(path: str) -> str:
    """Semantic layer kind = path with numeric segments stripped, so
    ``blocks/3/attn/wq`` and ``blocks/7/attn/wq`` share a kind."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def records_from_params(params: Any, model_id: str) -> list:
    """One record per param leaf (tensors, meta tensors or arrays)."""
    flat = flatten_paths(params)
    paths = sorted(flat.keys())
    n = max(len(paths), 1)
    out = []
    for i, path in enumerate(paths):
        leaf = flat[path]
        sig = (
            _kind_from_path(path),
            tuple(int(s) for s in getattr(leaf, "shape", ())),
            dtype_name(getattr(leaf, "dtype", "float32")),
        )
        out.append(LayerRecord(model_id, path, sig, leaf_bytes(leaf), i / n))
    return out
