"""Plain float32 reference of a Mamba-1 language model (falcon-mamba-7b's
widths): pre-norm residual blocks of RMSNorm (a learned offset, scale
1 + g) and the selective-scan mixer, then a final RMSNorm and an untied
unembedding.

The mixer (Gu and Dao, arXiv:2312.00752, Algorithm 2): an input projection
to (x, z); a depthwise causal convolution of width ``d_conv`` with bias,
then SiLU; ``x_proj`` to (dt_rank, B, C); dt = softplus(dt_proj(.) + bias);
per channel c and state i

    h_t = exp(dt_t A_ci) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t + D x_t,

with A = -exp(A_log); the output y * SiLU(z) through ``out_proj``.

Departures noted in the configuration file: falcon-mamba normalises B, C
and dt with RMS norms inside the mixer and uses eps 1e-5; the
configuration as run has no such norms and eps 1e-6.

Layer by layer, as :mod:`perfbench.reference.dense`; the scan runs step
by step over all sequences at once (they have one length in a serve).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import linear, unit_weights

EPS = 1e-6


def layout(cfg: dict) -> dict:
    d, di, n, r, K = (cfg["d_model"], cfg["d_inner"], cfg["d_state"], cfg["dt_rank"],
                      cfg["d_conv"])
    V = -(-cfg["vocab_size"] // cfg["vocab_multiple"]) * cfg["vocab_multiple"]
    dt, f32 = getattr(torch, cfg["dtype"]), torch.float32
    out = {"embed/table": ((V, d), dt), "final_norm/scale": ((d,), dt),
           "lm_head/w": ((d, V), dt)}
    for i in range(cfg["n_layers"]):
        b = f"blocks/{i}/"
        out.update({
            b + "ln/scale": ((d,), dt),
            b + "mixer/A_log": ((di, n), f32), b + "mixer/D": ((di,), f32),
            b + "mixer/conv/w": ((K, di), dt), b + "mixer/conv/b": ((di,), dt),
            b + "mixer/dt_proj/w": ((r, di), dt), b + "mixer/dt_proj/b": ((di,), dt),
            b + "mixer/in_proj/w": ((d, 2 * di), dt),
            b + "mixer/out_proj/w": ((di, d), dt),
            b + "mixer/x_proj/w": ((di, r + 2 * n), dt),
        })
    return out


def rms_norm(x, g):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * (1.0 + g)


def mixer(cfg: dict, p, x, fp8: bool = False):
    """x (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    di, n, r, K = cfg["d_inner"], cfg["d_state"], cfg["dt_rank"], cfg["d_conv"]
    xs, z = linear(x, p("in_proj/w"), fp8).split(di, dim=-1)
    w, bias = p("conv/w"), p("conv/b")
    padded = torch.cat([xs.new_zeros(B, K - 1, di), xs], dim=1)
    xc = sum(padded[:, j:j + S] * w[j] for j in range(K)) + bias
    xc = F.silu(xc)
    dt_r, Bm, Cm = linear(xc, p("x_proj/w"), fp8).split([r, n, n], dim=-1)
    dt = F.softplus(linear(dt_r, p("dt_proj/w"), fp8) + p("dt_proj/b"))
    A = -torch.exp(p("A_log"))  # (di, n)
    h = x.new_zeros(B, di, n)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * xc[:, t])[:, :, None] \
            * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + p("D") * xc
    return linear(y * F.silu(z), p("out_proj/w"), fp8)


def trunk(cfg: dict, seed: int, donor: int, seqs: list, device, fp8: bool = False) -> list:
    """The merged trunk over sequences of one length: [(S, d) float32]."""
    lay = layout(cfg)
    table = unit_weights(cfg, lay, seed, donor, "embed", device)["embed/table"]
    x = table[torch.as_tensor(np.stack(seqs), device=device).long()]  # (B, S, d)
    del table
    for i in range(cfg["n_layers"]):
        w = unit_weights(cfg, lay, seed, donor, f"blocks/{i}", device)
        p = lambda name: w[f"blocks/{i}/mixer/{name}"]  # noqa: E731
        x = x + mixer(cfg, p, rms_norm(x, w[f"blocks/{i}/ln/scale"]), fp8)
        del w
    return list(x)


def head(cfg: dict, seed: int, member: int, x, device, fp8: bool = False):
    w = unit_weights(cfg, layout(cfg), seed, member, "head", device)
    return linear(rms_norm(x, w["final_norm/scale"]), w["lm_head/w"], fp8)
