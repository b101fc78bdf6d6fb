"""What decides ``correct``: the timed path's outputs against the plain
float32 reference, run once the window has closed and the program's state
is freed.

Numbers compared (each in units of the reference row's standard deviation
over the vocabulary, so one limit reads the same at every width):

    gap   the widest gap by which a served token's reference logit lies
          below the reference's best at that position (greedy tokens: the
          decode's emitted tokens; a serve's argmax at every position)
    err   (serve) the largest difference between a served logit and the
          reference's, over the served token and the probe entries of
          every sampled position

The control is the same reference with every matrix product in fp8 e4m3
(``numbers(ctx, control=True)``): at the same prompts and tokens it reads
the gap of the token fp8 puts first, and its logits' difference at the same
entries.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

# merge_group's rule: the first record of each column donates; the records
# are listed member by member in the cell's order, so member 0 donates every
# trunk column, and the reference runs every request through its trunk
DONOR = 0


def _gap(ref: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(P,) gaps of tokens ``tok`` under reference rows ``ref`` (P, V)."""
    best = ref.max(-1).values
    got = ref.gather(-1, tok[:, None].long())[:, 0]
    return (best - got) / ref.std(-1)


def serve_requests(samples: list) -> list:
    """(member, tokens, positions) of sampled serve requests: every
    position."""
    return [(m, toks, np.arange(len(toks))) for m, toks, _ in samples]


def decode_requests(samples: list) -> list:
    """(member, prompt + served tokens but the last, the positions that
    emitted a served token) of sampled decode completions."""
    out = []
    for m, prompt, served in samples:
        seq = np.concatenate([prompt, np.asarray(served[:-1], np.int64)]).astype(np.int64)
        out.append((m, seq, np.arange(len(prompt) - 1, len(prompt) - 1 + len(served))))
    return out


def numbers(ctx, control: bool = False) -> dict:
    """{number: value} of the run's samples against the reference (with
    ``control``: the fp8 control's, read at the same positions)."""
    serve = ctx.cell["loop"] == "serve"
    reqs = serve_requests(ctx.samples) if serve else decode_requests(ctx.samples)
    if not reqs:
        return {}
    dev = ctx.device
    refs = reference.logits(ctx.family, ctx.cfg, ctx.seed, DONOR, reqs, dev)
    lows = (reference.logits(ctx.family, ctx.cfg, ctx.seed, DONOR, reqs, dev, fp8=True)
            if control else None)
    gap = err = 0.0
    for j, ref in enumerate(refs):
        std = ref.std(-1)
        if control:
            low = lows[j]
            tok = low.argmax(-1)
            gap = max(gap, float(_gap(ref, tok).max()))
            if serve:
                probes = torch.as_tensor(ctx.probes, device=dev).long()
                diff = (low.gather(-1, probes) - ref.gather(-1, probes)).abs()
                top = (low.max(-1).values - ref.gather(-1, tok[:, None])[:, 0]).abs()
                err = max(err, float((torch.maximum(diff.max(-1).values, top) / std).max()))
            continue
        if serve:
            top, top_val, probe_val = ctx.samples[j][2]
            tok = torch.as_tensor(top, device=dev)
            gap = max(gap, float(_gap(ref, tok).max()))
            probes = torch.as_tensor(ctx.probes, device=dev).long()
            diff = (torch.as_tensor(probe_val, device=dev) - ref.gather(-1, probes)).abs()
            dtop = (torch.as_tensor(top_val, device=dev)
                    - ref.gather(-1, tok[:, None].long())[:, 0]).abs()
            err = max(err, float((torch.maximum(diff.max(-1).values, dtop) / std).max()))
        else:
            tok = torch.as_tensor(ctx.samples[j][2], device=dev)
            gap = max(gap, float(_gap(ref, tok).max()))
    return {"gap": gap, "err": err} if serve else {"gap": gap}


def verdict(found: dict, limits: dict) -> bool:
    """Every number at or under its limit (a number not read fails)."""
    return bool(found) and all(k in found and found[k] <= v for k, v in limits.items())
