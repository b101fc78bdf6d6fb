"""Param-tree path utilities (the port of ``repro.utils.tree``).

Parameters are nested ``dict``s of tensors so every leaf has a stable path
like ``blocks/0/attn/wq``, the same flat paths the JAX package uses.  Dtypes
are named with numpy's names (``float32``, ``bfloat16``) wherever a name
enters an identity: layer signatures and store keys hash those strings, so
``torch.float32`` in place of ``float32`` would change every key.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

SEP = "/"

_TORCH_TO_NAME = {
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.float64: "float64",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}
_NAME_TO_TORCH = {v: k for k, v in _TORCH_TO_NAME.items()}
_ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "float64": 8,
             "int32": 4, "int64": 8, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1}


def dtype_name(dtype) -> str:
    """numpy-style name of a torch dtype, numpy dtype or dtype string."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NAME[dtype]
    return str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a numpy-style name (or a torch dtype, passed through)."""
    if isinstance(name, torch.dtype):
        return name
    return _NAME_TO_TORCH[dtype_name(name)]


def flatten_paths(tree: Any, prefix: str = "") -> dict:
    """Flatten a nested dict tree into ``{"a/b/c": leaf}``."""
    out: dict = {}
    if isinstance(tree, Mapping):
        for k in sorted(tree.keys()):
            out.update(flatten_paths(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_paths(v, f"{prefix}{i}{SEP}"))
    elif tree is None:
        pass
    else:
        out[prefix[: -len(SEP)]] = tree
    return out


def map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *same_position_in_rest)`` over a tree, its structure kept:
    dicts, lists, tuples and NamedTuples are nodes (``rest`` trees mirror
    ``tree``'s nodes; their leaves may be anything), ``None`` stays
    ``None``, anything else is a leaf."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten_paths(flat: Mapping[str, Any]) -> dict:
    """Inverse of :func:`flatten_paths` (dict nodes only)."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def leaf_bytes(leaf: Any) -> int:
    """Bytes of one tensor or array leaf (meta tensors included)."""
    shape = tuple(getattr(leaf, "shape", ()))
    itemsize = _ITEMSIZE[dtype_name(getattr(leaf, "dtype", "float32"))]
    return int(np.prod(shape, dtype=np.int64)) * itemsize
