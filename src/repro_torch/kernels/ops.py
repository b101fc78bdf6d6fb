"""Public kernel entry points, dispatched on the tensor's device.

    CPU tensor   -> the plain PyTorch version in ``kernels.ref``
    meta tensor  -> the plain version too (shapes and dtypes, no values)
    CUDA tensor  -> the hand-written Hopper kernel (or the call raises)

There is no fallback and no mode switch: a CUDA tensor never takes the plain
version, so a kernel that does not build or launch fails loudly.  The
Hopper kernels have no backward (nor do the JAX package's Pallas kernels),
so a CUDA call that autograd would record raises instead of returning a
result cut from the graph (:func:`require_no_grad`).  Every
dispatch bumps a per-op counter (as ``repro.kernels.ops`` does at trace
time); each kernel wrapper separately counts the launches it makes.

Each op has a cost function beside it, ``<op>_cost(*args) -> Cost``: the
operations and bytes of the work its Hopper kernel does at these inputs
(inputs read once, the output written once), the numbers ``chip_smoke.py``
bounds each kernel check with and ``launch.dryrun`` counts an op call as.
An observer installed with :func:`observed` sees every op call
(``launch.dryrun`` counts through one); without one an op call costs one
list check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import NamedTuple, Optional

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
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no implementation for device {t.device}")


_OBSERVERS: list = []


@contextlib.contextmanager
def observed(observer):
    """Route every op call through ``observer(name, body, args, kwargs)``
    while the context is open; the observer returns the call's result
    (calling ``body(*args, **kwargs)`` or not).  Dispatch counts still
    count every call."""
    _OBSERVERS.append(observer)
    try:
        yield observer
    finally:
        _OBSERVERS.remove(observer)


def _op(name: str):
    def wrap(body):
        @functools.wraps(body)
        def call(*args, **kwargs):
            _count(name)
            if _OBSERVERS:
                return _OBSERVERS[-1](name, body, args, kwargs)
            return body(*args, **kwargs)

        return call

    return wrap


@_op("flash_attention")
def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    if _on_cuda(q, "flash_attention"):
        require_no_grad("flash_attention", q, k, v)
        return _flash_mod.flash_attention(q, k, v, causal=causal, window=window,
                                          scale=scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


@_op("decode_attention")
def decode_attention(q, k_cache, v_cache, lengths, scale: Optional[float] = None):
    """One-query GQA attention against a cache up to a per-row length
    (int32 ``(B,)``); a row of length 0 gives exact zeros."""
    if _on_cuda(q, "decode_attention"):
        require_no_grad("decode_attention", q, k_cache, v_cache)
        return _decode_mod.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


@_op("page_gather")
def page_gather(pool, page_table):
    """out[i] = pool[page_table[i]]: one paged-KV view per dispatch."""
    if _on_cuda(pool, "page_gather"):
        require_no_grad("page_gather", pool)
        return _gather_mod.page_gather(pool, page_table)
    return _ref.page_gather_ref(pool, page_table)


@_op("bank_matmul")
def bank_matmul(x, w, b=None):
    """Grouped GEMM over a leading bank axis: out[n] = x[n] @ w[n] (+ b[n]),
    with x either (N, M, K) banked or (M, K) broadcast — the one-dispatch
    suffix fan-out of a merged serving group.  The plain version is an
    unrolled loop of the per-member contraction, so on the CPU the bank
    stays bitwise identical to the per-member path."""
    if _on_cuda(w, "bank_matmul"):
        require_no_grad("bank_matmul", x, w, b)
        return _bank_mod.bank_matmul(x, w, b)
    return _ref.bank_matmul_ref(x, w, b)


@_op("rg_lru_scan")
def rg_lru_scan(a, b, h0):
    """Diagonal recurrence h_t = a_t * h_{t-1} + b_t over (B, S, d); returns
    (y, h_last) in float32.  Any S >= 1: the caller pads nothing."""
    if _on_cuda(a, "rg_lru_scan"):
        require_no_grad("rg_lru_scan", a, b, h0)
        return _rg_lru_mod.rg_lru_scan(a, b, h0)
    return _ref.rg_lru_ref(a, b, h0)


@_op("mamba_scan")
def mamba_scan(dt, dtx, Bmat, Cmat, A, h0):
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dtx_t B_t, y_t = C_t . h_t;
    returns (y (B, S, di), h_last (B, di, n)) in float32.  Any S >= 1: the
    caller pads nothing."""
    if _on_cuda(dt, "mamba_scan"):
        require_no_grad("mamba_scan", dt, dtx, Bmat, Cmat, A, h0)
        return _mamba_mod.mamba_scan(dt, dtx, Bmat, Cmat, A, h0)
    return _ref.mamba_scan_ref(dt, dtx, Bmat, Cmat, A, h0)


# ---------------------------------------------------------------------------
# Costs: the work each Hopper kernel does at given inputs
# ---------------------------------------------------------------------------


class Cost(NamedTuple):
    """Operations (``flops``; multiply and add count one each), bytes moved
    (each input read once, each output written once) and, for the
    selective scan, exponentials (the special-function units' work)."""

    flops: float
    bytes: float
    exps: float = 0.0


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def attention_pairs(S: int, causal: bool = True, window: Optional[int] = None) -> int:
    """The (query, key) pairs an S x S mask keeps: key <= query when
    ``causal``, query - key < ``window`` when given."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = q if causal else S - 1
        total += max(0, hi - lo + 1)
    return total


def flash_attention_cost(q, k, v, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> Cost:
    """QK^T and PV over the pairs the mask keeps (a causal kernel skips the
    masked half): 2 D operations each per pair and query head."""
    B, S, Hq, D = q.shape
    pairs = attention_pairs(S, causal, window)
    return Cost(4.0 * D * pairs * B * Hq, _nbytes(q, k, v) + _nbytes(q))


def decode_keys(lengths, Smax: int) -> int:
    """The keys a decode launch reads: each row's length clipped to
    [0, Smax].  Lengths on ``meta`` hold no values: every row then counts
    the whole cache (a cache filled to its last slot)."""
    if lengths.device.type == "meta":
        return lengths.shape[0] * Smax
    return int(lengths.to(torch.int64).clamp(0, Smax).sum().item())


def decode_attention_cost(q, k_cache, v_cache, lengths, scale: Optional[float] = None) -> Cost:
    """The keys the lengths cover, read once from each of k and v, with
    2 D operations each per query head for QK^T and PV."""
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    keys = decode_keys(lengths, Smax)
    moved = _nbytes(q, lengths) + _nbytes(q) + 2 * keys * Hkv * D * k_cache.element_size()
    return Cost(4.0 * D * keys * Hq, moved)


def page_gather_cost(pool, page_table) -> Cost:
    """The table read, and each gathered page read once and written once."""
    out = page_table.shape[0] * pool[0].numel() * pool.element_size()
    return Cost(0.0, _nbytes(page_table) + 2 * out)


def bank_matmul_cost(x, w, b=None) -> Cost:
    """2 M K F operations a member (and M F for the bias); the output is
    float32."""
    N, K, F = w.shape
    M = x.shape[-2]
    flops = 2.0 * N * M * K * F + (N * M * F if b is not None else 0)
    return Cost(flops, _nbytes(x, w, b) + 4 * N * M * F)


def rg_lru_scan_cost(a, b, h0) -> Cost:
    """A multiply and an add per element; y (B, S, d) and h_last in
    float32."""
    B, S, d = a.shape
    return Cost(2.0 * B * S * d, _nbytes(a, b, h0) + 4 * (B * S * d + B * d))


def mamba_scan_cost(dt, dtx, Bmat, Cmat, A, h0) -> Cost:
    """Per (row, step, channel, state): dt*A, *h, dtx*B, +, *C, + -- six
    float32 operations -- and one exponential; y (B, S, di) and h_last
    (B, di, n) in float32."""
    B, S, di = dt.shape
    n = A.shape[1]
    work = B * S * di * n
    return Cost(6.0 * work, _nbytes(dt, dtx, Bmat, Cmat, A, h0) + 4 * (B * S * di + B * di * n),
                exps=float(work))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# each op's outputs as meta tensors (shapes and dtypes), for an observer
# that counts a call without computing it
META_OUTPUTS = {
    "flash_attention": lambda q, k, v, **_: _meta(q.shape, q.dtype),
    "decode_attention": lambda q, k, v, lengths, **_: _meta(q.shape, q.dtype),
    "page_gather": lambda pool, table: _meta((table.shape[0], *pool.shape[1:]), pool.dtype),
    "bank_matmul": lambda x, w, b=None: _meta((w.shape[0], x.shape[-2], w.shape[2]),
                                              torch.float32),
    "rg_lru_scan": lambda a, b, h0: (_meta(a.shape, torch.float32),
                                     _meta(h0.shape, torch.float32)),
    "mamba_scan": lambda dt, dtx, Bm, Cm, A, h0: (_meta(dt.shape, torch.float32),
                                                  _meta(h0.shape, torch.float32)),
}


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
    cost: object = None  # (*args, **kwargs) -> Cost of the kernel's work
    check: object = None  # the kernel's argument checks, device-agnostic (raise or None)


OP_TABLE: dict = {
    s.name: s for s in (
        OpSpec("flash_attention", _flash_mod.flash_attention,
               _ref.flash_attention_ref, flash_attention, ("q", "k", "v"),
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:127",
               cost=flash_attention_cost, check=_flash_mod.check_args),
        OpSpec("decode_attention", _decode_mod.decode_attention,
               _ref.decode_attention_ref, decode_attention,
               ("q", "k_cache", "v_cache", "lengths"),
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:98",
               cost=decode_attention_cost, check=_decode_mod.check_args),
        OpSpec("page_gather", _gather_mod.page_gather, _ref.page_gather_ref,
               page_gather, ("pool", "page_table"),
               source="src/repro_torch/kernels/csrc/page_gather.cu",
               replaces="src/repro/kernels/page_gather.py:41",
               cost=page_gather_cost, check=_gather_mod.check_args),
        OpSpec("bank_matmul", _bank_mod.bank_matmul, _ref.bank_matmul_ref,
               bank_matmul, ("x", "w"), optional_args=("b",),
               source="src/repro_torch/kernels/csrc/bank_matmul.cu",
               replaces="src/repro/kernels/bank_matmul.py:123",
               cost=bank_matmul_cost, check=_bank_mod.check_args),
        OpSpec("mamba_scan", _mamba_mod.mamba_scan, _ref.mamba_scan_ref, mamba_scan,
               ("dt", "dtx", "Bmat", "Cmat", "A", "h0"),
               source="src/repro_torch/kernels/csrc/mamba_scan.cu",
               replaces="src/repro/kernels/mamba_scan.py:78",
               cost=mamba_scan_cost, check=_mamba_mod.check_args),
        OpSpec("rg_lru_scan", _rg_lru_mod.rg_lru_scan, _ref.rg_lru_ref, rg_lru_scan,
               ("a", "b", "h0"),
               source="src/repro_torch/kernels/csrc/rg_lru.cu",
               replaces="src/repro/kernels/rg_lru.py:65",
               cost=rg_lru_scan_cost, check=_rg_lru_mod.check_args),
    )
}


def kernel_launches() -> dict:
    """{op_name: CUDA kernel launches since the last reset}, read from the
    counter each kernel wrapper keeps on itself."""
    return {name: spec.kernel.launches for name, spec in OP_TABLE.items()}


def route_launches() -> dict:
    """{op_name: {route: launches}} since the last reset, for the kernels
    that pick between routes (``bank_matmul``: wgmma / simt;
    ``flash_attention``: mma / simt; ``mamba_scan``: step / scan;
    ``rg_lru_scan``: scan / step / plain)."""
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
