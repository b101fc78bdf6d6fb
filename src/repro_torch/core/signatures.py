"""Architectural signatures (the port of ``repro.core.signatures``): two
layers can merge iff their structural identity (op kind from the path,
shape, dtype) matches, excluding weights.

A signature is ``(kind, shape, dtype_name)`` with the numpy dtype name, so
the port's signatures, group ids and store keys equal the JAX package's.

The module also holds the MergePlan weight-payload wire codec.  Its entries
are byte for byte the JAX package's, so a plan shipped by either package
applies in the other: a payload is the tensor's raw bytes in base64, and a
bfloat16 tensor travels as its 2-byte words (through an ``int16`` view)
labelled ``"bfloat16"``, which decodes without numpy's bfloat16 extension.
"""
from __future__ import annotations

import base64
import dataclasses
from collections import Counter
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.utils.tree import dtype_name, flatten_paths, leaf_bytes, torch_dtype


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


def signature_to_json(sig: Any) -> Any:
    """Signatures are nested tuples of ints/strings; JSON has no tuple, so
    encode recursively as lists and restore with :func:`signature_from_json`."""
    if isinstance(sig, (tuple, list)):
        return [signature_to_json(s) for s in sig]
    return sig


def signature_from_json(obj: Any) -> Any:
    if isinstance(obj, list):
        return tuple(signature_from_json(o) for o in obj)
    return obj


def record_to_json(r: LayerRecord) -> dict:
    """Appearance payload for a serialized plan (the signature is stored
    once per group, not per record)."""
    return {"model_id": r.model_id, "path": r.path,
            "bytes": r.bytes, "position": r.position}


def record_from_json(obj: dict, signature: tuple) -> LayerRecord:
    return LayerRecord(obj["model_id"], obj["path"], signature,
                       obj["bytes"], obj["position"])


def _kind_from_path(path: str) -> str:
    """Semantic layer kind = path with numeric segments stripped, so
    ``blocks/3/attn/wq`` and ``blocks/7/attn/wq`` share a kind."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def records_from_spec(spec: Any, model_id: Optional[str] = None) -> list:
    """One record per descriptor layer.  ``spec`` is duck-typed (``name`` +
    ``layers`` with per-layer ``name``/``signature``/``bytes``)."""
    mid = model_id or spec.name
    n = max(len(spec.layers), 1)
    return [LayerRecord(mid, l.name, l.signature, l.bytes, i / n)
            for i, l in enumerate(spec.layers)]


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


def signature_match_fraction(a: list, b: list) -> float:
    """Fig 4 metric: fraction of layers architecturally identical across a
    model pair = matched / max(len(a), len(b)), matching being multiset
    intersection on signatures."""
    ca = Counter(r.signature for r in a)
    cb = Counter(r.signature for r in b)
    return sum((ca & cb).values()) / max(len(a), len(b), 1)


# ---------------------------------------------------------------------------
# MergePlan weight-payload wire codec: a delta against the previously
# deployed plan plus optional int8 residual quantization, for shipping plans
# over the constrained cloud->edge link.
# ---------------------------------------------------------------------------

# dtypes the JAX package quantizes: numpy's floating kinds.  numpy's
# bfloat16 is an extension type of another kind, so a changed bf16 buffer
# ships in full there, and here too.
_QUANTIZABLE = frozenset({"float16", "float32", "float64"})


def _host(x) -> torch.Tensor:
    """A contiguous CPU tensor of ``x`` (a tensor on any device or a numpy
    array of a dtype torch has)."""
    t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return t.detach().cpu().contiguous()


def _raw_bytes(t: torch.Tensor) -> bytes:
    """The tensor's bytes as stored: bfloat16 through its int16 view."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode("ascii")


def encode_weight_entry(arr, base=None, quantize: bool = False) -> dict:
    """One shared-buffer wire entry.  ``base`` is the value the receiving
    edge box currently holds under the same key (the previously deployed
    plan); kinds:

    * ``full``  — raw bytes (bitwise; no base, shape/dtype drift, or an
      unquantized change);
    * ``same``  — bitwise-unchanged vs base: zero payload, the edge reuses
      its resident buffer;
    * ``delta_q8`` — int8 residual ``round((arr - base)/scale)`` with a
      per-leaf amax scale: 4x fewer payload bytes for float32, lossy.

    Entries without a ``kind`` field decode as ``full``."""
    t = _host(arr)
    name = dtype_name(t.dtype)
    meta = {"dtype": name, "shape": [int(s) for s in t.shape]}
    if base is not None:
        b = _host(base)
        if b.shape == t.shape and b.dtype == t.dtype:
            if torch.equal(b, t):
                return {**meta, "kind": "same"}
            if quantize and name in _QUANTIZABLE:
                q, scale = quantize_int8(t.float().numpy() - b.float().numpy())
                return {**meta, "kind": "delta_q8", "scale": scale,
                        "data": _b64(q.tobytes())}
    return {**meta, "kind": "full", "data": _b64(_raw_bytes(t))}


def decode_weight_entry(entry: dict, base=None) -> torch.Tensor:
    """Reconstruct a wire entry on the edge as a CPU tensor.  Delta kinds
    require ``base`` (the buffer currently deployed under the entry's key)."""
    kind = entry.get("kind", "full")
    shape, dtype = entry["shape"], entry["dtype"]
    if kind == "full":
        buf = bytearray(base64.b64decode(entry["data"]))
        return torch.frombuffer(buf, dtype=torch_dtype(dtype)).reshape(shape)
    if base is None:
        raise ValueError(f"wire entry kind={kind!r} needs the previously "
                         "deployed buffer as base")
    b = _host(base)
    if tuple(b.shape) != tuple(shape) or dtype_name(b.dtype) != dtype:
        raise ValueError(f"delta base mismatch: base {tuple(b.shape)}/"
                         f"{dtype_name(b.dtype)} vs entry {tuple(shape)}/{dtype}")
    if kind == "same":
        return b
    if kind == "delta_q8":
        q = np.frombuffer(base64.b64decode(entry["data"]),
                          dtype=np.int8).reshape(shape)
        summed = b.float().numpy() + dequantize_int8(q, entry["scale"])
        return torch.from_numpy(summed).to(torch_dtype(dtype))
    raise ValueError(f"unknown wire entry kind {kind!r}")


def entry_wire_bytes(entry: dict) -> int:
    """Decoded payload bytes an entry puts on the wire (data + scale),
    counted from the base64 text (4 characters per 3 bytes, ``=``
    padding off the last group) without decoding it: a full-width plan
    carries gigabytes."""
    data = entry.get("data", "")
    pad = 2 if data.endswith("==") else 1 if data.endswith("=") else 0
    return len(data) // 4 * 3 - pad + (4 if "scale" in entry else 0)


def weights_wire_bytes(weights: Optional[dict]) -> int:
    return sum(entry_wire_bytes(e) for e in (weights or {}).values())
