#!/usr/bin/env python3
"""How far bf16 rounding moves the decode-against-forward check of
``chip_smoke.py``'s ``arch_families`` phase, on one NVIDIA GPU.

    python3 chip_arch_numerics.py

``arch_families`` holds each greedy decode step's logits (after a
prefill) against the forward over the prompt and the tokens so far, at
its last position, as the largest difference over the forward row's
largest magnitude.  This script runs the phase's own loop
(``chip_smoke.greedy_decode``, ``against_forward``, ``float32_check``)
on internvl2-2b and stablelm-1.6b at their full 24 layers and widths,
and on deepseek-moe-16b and olmoe-1b-7b at the phase's depths (random
weights, ``chip_smoke.arch_config``), over weight seeds 0-3 and the
phase's seed, and prints one JSON line a run:

* ``bf16``: the check's difference per (checked position, batch row);
* ``float32``: its largest difference on the same weights upcast;
* ``bf16_forward_vs_float32``: per checked position, the largest
  difference of the bf16 forward from the float32 forward of the same
  weights and tokens (rounding alone, no decode);
* for the moe archs, ``routing``: per (checked position, batch row),
  whether a routing decision at that position (``flipped_here``) or
  before it (``flipped_before``) differs between the decode and the
  forward, and how many of all decisions differ, in bf16 and in float32;
* internvl2-2b's patch embeddings at ``chip_smoke.FRONTEND_SCALE`` (as
  the phase) and at N(0, 1).

Nothing is asserted.  Needs one card and about 20 GB of its memory;
imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

RUNS = (("internvl2-2b", (None, 1.0)), ("stablelm-1.6b", (None,)),
        ("deepseek-moe-16b", (None,)), ("olmoe-1b-7b", (None,)))


def run(torch, C, arch: str, seed: int, patch_scale) -> dict:
    """One pass of the phase's check on ``arch`` at ``seed``; a
    ``patch_scale`` redraws the frontend's embeddings at that scale."""
    from repro_torch.models.registry import get_family

    family, cfg, _ = C.arch_config(arch)
    fam = get_family(family)
    params = fam.init(cfg, seed, "cuda")
    toks, extra = C.arch_inputs(torch, family, cfg, seed)
    if extra is not None and patch_scale is not None:
        extra = extra * (patch_scale / C.FRONTEND_SCALE)
    off = cfg.n_patches if family == "vlm" else 0
    max_len = off + toks.shape[1] + C.ARCH_NEW
    dec = C.greedy_decode(torch, fam, family, cfg, params, toks, extra, max_len)
    full = dec["toks"]
    chk = C.against_forward(torch, fam, family, cfg, params, full, extra, dec["rows"],
                            dec.get("routes"))
    chk32 = C.float32_check(torch, fam, family, cfg, params, full, extra, max_len)
    # the bf16 forward's rows against the float32 forward's
    fwd = [C.family_call(fam, family, "forward", cfg, params,
                         full[:, :full.shape[1] - C.ARCH_NEW + i], extra)[:, -1].float()
           for i in range(len(dec["rows"]))]
    c32, p32 = C.upcast(cfg, params)
    del params
    fwd32 = C.against_forward(torch, fam, family, c32, p32, full, extra, fwd)
    out = dict(arch=arch, seed=seed,
               patch_scale=None if extra is None else (patch_scale or C.FRONTEND_SCALE),
               bf16=chk["err"].tolist(), bf16_largest=float(chk["err"].max()),
               argmax_agreement=float(chk["agree"].float().mean()),
               float32_largest=float(chk32["err"].max()),
               bf16_forward_vs_float32=fwd32["err"].amax(-1).tolist())
    if "routes" in dec:
        out["routing"] = dict(
            flipped_here=chk["flipped_here"].tolist(),
            flipped_before=chk["flipped_before"].tolist(),
            decisions=chk["decisions"], flipped_decisions=chk["flipped_decisions"],
            float32_flipped_decisions=chk32["flipped_decisions"],
            largest_where_agreeing=float(chk["err"][~chk["flipped_here"]].max())
            if (~chk["flipped_here"]).any() else None)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_arch_numerics: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import chip_smoke as C
    from repro_torch.configs.registry import all_arch_ids

    C.full_precision_matmuls(torch)  # as chip_smoke.py's main
    print(C.nvidia_smi_line(), flush=True)
    with torch.no_grad():
        for arch, scales in RUNS:
            for seed in sorted({0, 1, 2, 3, all_arch_ids().index(arch)}):
                for scale in scales:
                    print(json.dumps(run(torch, C, arch, seed, scale)), flush=True)
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
