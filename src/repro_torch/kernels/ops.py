"""Public kernel entry points, dispatched on the tensor's device.

    CPU tensor   -> the plain PyTorch version in ``kernels.ref``
    CUDA tensor  -> the hand-written Hopper kernel (or the call raises)

There is no fallback and no mode switch: a CUDA tensor never takes the plain
version, so a kernel that does not build or launch fails loudly.  The
Hopper kernels have no backward (nor do the JAX package's Pallas kernels),
so a CUDA call that autograd would record raises instead of returning a
result cut from the graph (:func:`require_no_grad`).  Every
dispatch bumps a per-op counter (as ``repro.kernels.ops`` does at trace
time); each kernel wrapper separately counts the launches it makes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import bank_matmul as _bank_mod
from repro_torch.kernels import decode_attention as _decode_mod
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import mamba_scan as _mamba_mod
from repro_torch.kernels import page_gather as _gather_mod
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rg_lru as _rg_lru_mod

DISPATCH_COUNTS: dict = {}


def _count(name: str) -> None:
    DISPATCH_COUNTS[name] = DISPATCH_COUNTS.get(name, 0) + 1


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()


def dispatch_counts() -> dict:
    """Snapshot of {op_name: dispatch count} since the last reset.  Ops
    never dispatched are absent."""
    return dict(DISPATCH_COUNTS)


def require_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would record this kernel call: grad mode is on and
    an input requires grad.  A kernel's result has no ``grad_fn``, so
    without this check every parameter before it would silently get no
    gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "call it under torch.no_grad() (training through it needs a backward kernel)")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {t.device}")


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    _count("flash_attention")
    if _on_cuda(q, "flash_attention"):
        require_no_grad("flash_attention", q, k, v)
        return _flash_mod.flash_attention(q, k, v, causal=causal, window=window,
                                          scale=scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, scale: Optional[float] = None):
    """One-query GQA attention against a cache up to a per-row length
    (int32 ``(B,)``); a row of length 0 gives exact zeros."""
    _count("decode_attention")
    if _on_cuda(q, "decode_attention"):
        require_no_grad("decode_attention", q, k_cache, v_cache)
        return _decode_mod.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


def page_gather(pool, page_table):
    """out[i] = pool[page_table[i]]: one paged-KV view per dispatch."""
    _count("page_gather")
    if _on_cuda(pool, "page_gather"):
        require_no_grad("page_gather", pool)
        return _gather_mod.page_gather(pool, page_table)
    return _ref.page_gather_ref(pool, page_table)


def bank_matmul(x, w, b=None):
    """Grouped GEMM over a leading bank axis: out[n] = x[n] @ w[n] (+ b[n]),
    with x either (N, M, K) banked or (M, K) broadcast — the one-dispatch
    suffix fan-out of a merged serving group.  The plain version is an
    unrolled loop of the per-member contraction, so on the CPU the bank
    stays bitwise identical to the per-member path."""
    _count("bank_matmul")
    if _on_cuda(w, "bank_matmul"):
        require_no_grad("bank_matmul", x, w, b)
        return _bank_mod.bank_matmul(x, w, b)
    return _ref.bank_matmul_ref(x, w, b)


def rg_lru_scan(a, b, h0):
    """Diagonal recurrence h_t = a_t * h_{t-1} + b_t over (B, S, d); returns
    (y, h_last) in float32.  Any S >= 1: the caller pads nothing."""
    _count("rg_lru_scan")
    if _on_cuda(a, "rg_lru_scan"):
        require_no_grad("rg_lru_scan", a, b, h0)
        return _rg_lru_mod.rg_lru_scan(a, b, h0)
    return _ref.rg_lru_ref(a, b, h0)


def mamba_scan(dt, dtx, Bmat, Cmat, A, h0):
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dtx_t B_t, y_t = C_t . h_t;
    returns (y (B, S, di), h_last (B, di, n)) in float32.  Any S >= 1: the
    caller pads nothing."""
    _count("mamba_scan")
    if _on_cuda(dt, "mamba_scan"):
        require_no_grad("mamba_scan", dt, dtx, Bmat, Cmat, A, h0)
        return _mamba_mod.mamba_scan(dt, dtx, Bmat, Cmat, A, h0)
    return _ref.mamba_scan_ref(dt, dtx, Bmat, Cmat, A, h0)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One dispatchable op: its Hopper kernel wrapper, plain version,
    device-dispatching entry point and declared array arguments."""

    name: str
    kernel: object
    ref: object
    dispatch: object
    array_args: tuple
    optional_args: tuple = ()
    source: str = ""  # the CUDA source, relative to the repository root
    replaces: str = ""  # the Pallas TPU kernel's pallas_call, file:line


OP_TABLE: dict = {
    s.name: s for s in (
        OpSpec("flash_attention", _flash_mod.flash_attention,
               _ref.flash_attention_ref, flash_attention, ("q", "k", "v"),
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:127"),
        OpSpec("decode_attention", _decode_mod.decode_attention,
               _ref.decode_attention_ref, decode_attention,
               ("q", "k_cache", "v_cache", "lengths"),
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:98"),
        OpSpec("page_gather", _gather_mod.page_gather, _ref.page_gather_ref,
               page_gather, ("pool", "page_table"),
               source="src/repro_torch/kernels/csrc/page_gather.cu",
               replaces="src/repro/kernels/page_gather.py:41"),
        OpSpec("bank_matmul", _bank_mod.bank_matmul, _ref.bank_matmul_ref,
               bank_matmul, ("x", "w"), optional_args=("b",),
               source="src/repro_torch/kernels/csrc/bank_matmul.cu",
               replaces="src/repro/kernels/bank_matmul.py:123"),
        OpSpec("mamba_scan", _mamba_mod.mamba_scan, _ref.mamba_scan_ref, mamba_scan,
               ("dt", "dtx", "Bmat", "Cmat", "A", "h0"),
               source="src/repro_torch/kernels/csrc/mamba_scan.cu",
               replaces="src/repro/kernels/mamba_scan.py:78"),
        OpSpec("rg_lru_scan", _rg_lru_mod.rg_lru_scan, _ref.rg_lru_ref, rg_lru_scan,
               ("a", "b", "h0"),
               source="src/repro_torch/kernels/csrc/rg_lru.cu",
               replaces="src/repro/kernels/rg_lru.py:65"),
    )
}


def kernel_launches() -> dict:
    """{op_name: CUDA kernel launches since the last reset}, read from the
    counter each kernel wrapper keeps on itself."""
    return {name: spec.kernel.launches for name, spec in OP_TABLE.items()}


def route_launches() -> dict:
    """{op_name: {route: launches}} since the last reset, for the kernels
    that pick between routes (``bank_matmul``: wgmma / simt;
    ``flash_attention``: mma / simt; ``mamba_scan``: step / scan)."""
    return {name: dict(spec.kernel.route_launches) for name, spec in OP_TABLE.items()
            if hasattr(spec.kernel, "route_launches")}


def launch_counters() -> dict:
    """Every launch counter as one flat {key: count}: ``(op,)`` for a
    kernel's launches, ``(op, route)`` for its launches by route.  A
    CUDA-graph replay launches no wrapper, so ``serving.graphs`` takes the
    difference of two of these around a capture and adds it back on every
    replay (:func:`add_launch_counters`)."""
    out = {}
    for name, spec in OP_TABLE.items():
        out[(name,)] = spec.kernel.launches
        for route, n in getattr(spec.kernel, "route_launches", {}).items():
            out[(name, route)] = n
    return out


def add_launch_counters(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (keys of :func:`launch_counters`) to the
    kernels' counters."""
    for key, n in delta.items():
        kernel = OP_TABLE[key[0]].kernel
        if len(key) == 1:
            kernel.launches += times * n
        else:
            kernel.route_launches[key[1]] += times * n


def reset_kernel_launches() -> None:
    for spec in OP_TABLE.values():
        spec.kernel.launches = 0
        if hasattr(spec.kernel, "route_launches"):
            spec.kernel.route_launches = dict.fromkeys(spec.kernel.route_launches, 0)
