"""The plain references: float32 PyTorch from the published descriptions,
with no kernel, cache or batching of the program, and nothing imported
from it.  Each family module gives ``layout(cfg)``, ``trunk(cfg, seed,
donor, seqs, device, fp8)`` and ``head(cfg, seed, member, x, device,
fp8)``."""
from __future__ import annotations

import contextlib

import torch

from perfbench.reference import dense, mamba

FAMILIES = {"dense": dense, "ssm": mamba}


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def logits(family: str, cfg: dict, seed: int, donor: int, requests: list, device,
           fp8: bool = False) -> list:
    """Float32 logits of each request at its positions: ``requests`` are
    (member index, token ids, positions); returns [(len(positions), V)].
    Every request runs through the donor's trunk and its own member's head;
    with ``fp8`` every matrix product is in fp8 (the control)."""
    mod = FAMILIES[family]
    with exact_float32():
        hidden = mod.trunk(cfg, seed, donor, [r[1] for r in requests], device, fp8)
        out = [None] * len(requests)
        for member in sorted({r[0] for r in requests}):
            idx = [j for j, r in enumerate(requests) if r[0] == member]
            rows = torch.cat([hidden[j][torch.as_tensor(requests[j][2], device=device).long()]
                              for j in idx])
            got = mod.head(cfg, seed, member, rows, device, fp8)
            off = 0
            for j in idx:
                n = len(requests[j][2])
                out[j] = got[off:off + n]
                off += n
    return out
