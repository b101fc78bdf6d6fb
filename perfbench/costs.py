"""The yardstick's arithmetic, frozen here: the operations and bytes of
each kernel call (a copy of the port's ``kernels/ops.py`` cost functions as
they stood when this benchmark was defined), the card's published peaks,
and the useful model flops of a token.

A kernel call's bound is the least time the card could take for it: the
larger of its bytes at the memory rate, its operations at the peak rate of
its dtype, and its exponentials at the special-function units' rate.  A
roofline share is the sum of the bounds of the calls over their measured
device time.  Only calls that move more bytes than the L2 cache holds are
counted: below that, hits in the cache can make a call beat its bound.

Arguments are tensors or :class:`Spec` s (shape and element size only), so
an observer can keep a call's description without keeping its tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

# NVIDIA H100 SXM5 80GB, the data sheet's dense rates at the 700 W limit
PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_F32 = 67e12  # FLOP/s, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
# exponentials: 16 a clock per SM on the special-function units (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0) x 132 SMs x
# the 1,980 MHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9


class Spec:
    """What a cost function reads of a tensor: its shape and element
    size."""

    __slots__ = ("shape", "_itemsize")

    def __init__(self, shape, itemsize: int):
        self.shape = tuple(int(s) for s in shape)
        self._itemsize = int(itemsize)

    @classmethod
    def of(cls, t) -> Optional["Spec"]:
        return None if t is None else cls(t.shape, t.element_size())

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self._itemsize

    def __getitem__(self, i):  # pool[0] in page_gather_cost
        return Spec(self.shape[1:], self._itemsize)


class Cost(NamedTuple):
    flops: float
    bytes: float
    exps: float = 0.0


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def attention_pairs(S: int, causal: bool = True, window: Optional[int] = None) -> int:
    """The (query, key) pairs an S x S mask keeps."""
    if window is None:
        return S * (S + 1) // 2 if causal else S * S
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1)
        hi = q if causal else S - 1
        total += max(0, hi - lo + 1)
    return total


def flash_attention_cost(q, k, v, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> Cost:
    B, S, Hq, D = q.shape
    pairs = attention_pairs(S, causal, window)
    return Cost(4.0 * D * pairs * B * Hq, _nbytes(q, k, v) + _nbytes(q))


def decode_attention_cost(q, k_cache, v_cache, keys: int) -> Cost:
    """``keys``: the keys the launch reads (each row's length clipped to the
    cache), which the caller counts."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    moved = 2 * _nbytes(q) + 4 * B + 2 * keys * Hkv * D * k_cache.element_size()
    return Cost(4.0 * D * keys * Hq, moved)


def page_gather_cost(pool, page_table) -> Cost:
    out = page_table.shape[0] * pool[0].numel() * pool.element_size()
    return Cost(0.0, _nbytes(page_table) + 2 * out)


def bank_matmul_cost(x, w, b=None) -> Cost:
    N, K, F = w.shape
    M = x.shape[-2]
    flops = 2.0 * N * M * K * F + (N * M * F if b is not None else 0)
    return Cost(flops, _nbytes(x, w, b) + 4 * N * M * F)


def rg_lru_scan_cost(a, b, h0) -> Cost:
    B, S, d = a.shape
    return Cost(2.0 * B * S * d, _nbytes(a, b, h0) + 4 * (B * S * d + B * d))


def mamba_scan_cost(dt, dtx, Bmat, Cmat, A, h0) -> Cost:
    B, S, di = dt.shape
    n = A.shape[1]
    work = B * S * di * n
    return Cost(6.0 * work, _nbytes(dt, dtx, Bmat, Cmat, A, h0) + 4 * (B * S * di + B * di * n),
                exps=float(work))


COSTS = {
    "flash_attention": flash_attention_cost,
    "page_gather": page_gather_cost,
    "bank_matmul": bank_matmul_cost,
    "rg_lru_scan": rg_lru_scan_cost,
    "mamba_scan": mamba_scan_cost,
}

# the arithmetic each kernel does: bf16 on the tensor cores, or float32 on
# the CUDA cores (the scans; the gather moves bytes only)
PEAK_OF = {"flash_attention": PEAK_BF16, "bank_matmul": PEAK_BF16,
           "page_gather": PEAK_F32, "rg_lru_scan": PEAK_F32, "mamba_scan": PEAK_F32}


def bound_s(op: str, cost: Cost) -> float:
    """The least seconds the card could take for a call of ``op``."""
    return max(cost.bytes / HBM_BYTES_PER_S, cost.flops / PEAK_OF[op],
               cost.exps / EXP_PER_S)


def above_l2(cost: Cost) -> bool:
    return cost.bytes > L2_BYTES


# ---------------------------------------------------------------------------
# Useful model flops: each real row's trunk and its own member's head; no
# padding rows, no other member's slice of a bank
# ---------------------------------------------------------------------------


def head_flops(cfg: dict) -> float:
    """One token's unembedding."""
    V = -(-cfg["vocab_size"] // cfg["vocab_multiple"]) * cfg["vocab_multiple"]
    return 2.0 * cfg["d_model"] * V


def trunk_flops(family: str, cfg: dict, lo: int, hi: int) -> float:
    """The trunk of the tokens at positions lo..hi-1 of one sequence, each
    attending to the keys up to itself: 2 flops a weight of every matrix
    product, and in a dense model 4 D a key and head for QK and PV; in a
    Mamba-1 model the convolution and the scan's six operations per channel
    and state."""
    n = hi - lo
    if n <= 0:
        return 0.0
    if family == "dense":
        d, H, Hkv, D, F = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                           cfg["head_dim"], cfg["d_ff"])
        ffn = (3 if cfg.get("gated_ffn", True) else 2) * d * F
        weights = d * H * D + 2 * d * Hkv * D + H * D * d + ffn
        keys = (hi * (hi + 1) - lo * (lo + 1)) // 2  # contexts lo+1 .. hi
        return cfg["n_layers"] * (2.0 * weights * n + 4.0 * D * H * keys)
    if family == "ssm":
        d, di, N, r, K = (cfg["d_model"], cfg["d_inner"], cfg["d_state"], cfg["dt_rank"],
                          cfg["d_conv"])
        weights = d * 2 * di + di * (r + 2 * N) + r * di + di * d
        return cfg["n_layers"] * n * (2.0 * weights + 2.0 * K * di + 6.0 * di * N)
    raise ValueError(f"no flop count for family {family!r}")


def sequence_flops(family: str, cfg: dict, tokens: int) -> float:
    """A whole sequence with logits at every position (a serve request)."""
    return trunk_flops(family, cfg, 0, tokens) + tokens * head_flops(cfg)
