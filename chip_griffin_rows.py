#!/usr/bin/env python3
"""Which operations of recurrentgemma-9b's decode make a row's logits
depend on the batch size, on one NVIDIA GPU.

    python3 chip_griffin_rows.py

``chip_smoke.py`` streams decode of a merged recurrentgemma-9b group at
batch 8 and replays one request per member at batch 1 through the unpaged
decode, holding the streamed logits to the replay's at 2e-2 of the row
maximum; a batch-8 unpaged replay reads the same difference, so the batch
size alone makes it.  This script builds one full-width member (random
weights, its head perturbed as ``chip_smoke``'s ``lm_zoo`` perturbs one)
and feeds the same 127 teacher-forced tokens through the unpaged decode:

* ``trace``: batch 1 and batch 8 (the request in every row) step the
  trunk in lockstep from the same state under a dispatch trace, 16 steps;
  every operation whose row 0 came out with other bits from inputs whose
  row 0 was the same is counted by name;
* variants: the whole replay at batch 1 and at batch 8, the largest
  difference of the last 32 logits rows over the row maximum and the
  argmax flips, with the port as it is (``shipped``) and with the ring
  attention, then also the block-diagonal gate einsum, then also the RMS
  norm computed one row at a time.

Each prints one JSON line; nothing is asserted.  Needs one card and about
40 GB of its memory; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

STEPS, EMITTED = 127, 32


def per_row(fn, n_batched: int):
    """``fn`` computed one batch row at a time: its first ``n_batched``
    arguments carry the batch on dim 0."""
    import torch

    def run(*args):
        B = args[0].shape[0]
        return torch.cat([fn(*(a[b:b + 1] for a in args[:n_batched]), *args[n_batched:])
                          for b in range(B)])
    return run


def replay(torch, griffin, cfg, params, tokens, batch: int) -> list:
    cache = griffin.init_cache(cfg, batch, cfg.window, device="cuda")
    rows = []
    for i, tok in enumerate(tokens):
        logits, cache = griffin.decode_step(
            cfg, params, cache, torch.full((batch, 1), tok, dtype=torch.int64, device="cuda"))
        if i >= len(tokens) - EMITTED:
            rows.append(logits[0, 0].float())
    return rows


def row0(one, eight):
    """``eight`` cut to ``one``'s shape: where the two shapes differ in one
    dimension (1 against 8, the batch), row 0 of it; equal shapes as they
    are; None where they do not match so."""
    if one.shape == eight.shape:
        return eight
    dims = [i for i, (a, b) in enumerate(zip(one.shape, eight.shape)) if a != b]
    if one.dim() != eight.dim() or len(dims) != 1 or one.shape[dims[0]] != 1:
        return None
    return eight.narrow(dims[0], 0, 1)


def traced_step(torch, griffin, cfg, params, cache, tok: int, batch: int) -> tuple:
    """One decode step of the trunk (the head, which feeds no state, left
    out) under a dispatch trace: (hidden, cache, [(op name, inputs, first
    tensor output)]) for every operation that computes.  Inputs are copied
    before the operation runs (it may write one in place), except tensors
    of more than 2^24 elements (weights, the same tensors in every run),
    which are kept as their address."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []
    # views and copies move data without arithmetic, and their number
    # depends on the batch size (a batch of one skips some copies)
    moves = {"clone", "_unsafe_view", "alias", "copy_", "detach", "lift_fresh"}

    def keep(a):
        return a.detach().clone() if a.numel() <= 1 << 24 else ("at", a.data_ptr())

    def tensors(args):
        for a in args:
            if isinstance(a, torch.Tensor):
                yield a
            elif isinstance(a, (list, tuple)):
                yield from tensors(a)

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            # an allocation's contents are whatever the memory held
            traced = not (func.is_view or name in moves or name.startswith(("empty",
                                                                             "new_empty")))
            ins = [keep(a) for a in tensors(args)] if traced else None
            out = func(*args, **(kwargs or {}))
            first = out[0] if isinstance(out, (tuple, list)) else out
            if traced and isinstance(first, torch.Tensor) and first.is_floating_point():
                ops.append((str(func), ins, first.detach().clone()))
            return out

    head, griffin.head = griffin.head, lambda cfg, params, x: x  # the trunk alone
    try:
        with Trace():
            hidden, cache = griffin.decode_step(
                cfg, params, cache, torch.full((batch, 1), tok, dtype=torch.int64,
                                               device="cuda"))
    finally:
        griffin.head = head
    return hidden, cache, ops


def same(torch, one, eight) -> bool:
    if isinstance(one, tuple) or isinstance(eight, tuple):
        return one == eight
    eight = row0(one, eight)
    return eight is not None and torch.equal(one, eight)


def batch_dependent_ops(torch, griffin, cfg, params, tokens, steps: int) -> dict:
    """Batch 1 and batch 8 step the trunk in lockstep from the same state:
    after each step every row of the batch-8 cache is set to the batch-1
    cache.  The operations that gave row 0 other bits from inputs whose row
    0 was the same are the batch-dependent ones; by operation: how many
    over ``steps`` steps, the largest difference over the output's largest
    magnitude, and an example's input shapes at batch 8."""
    caches = {b: griffin.init_cache(cfg, b, cfg.window, device="cuda") for b in (1, 8)}
    origins, differing = {}, 0
    for tok in tokens[:steps]:
        traces = {}
        for b in (1, 8):
            _, caches[b], traces[b] = traced_step(torch, griffin, cfg, params, caches[b], tok, b)
        if len(traces[1]) != len(traces[8]):
            return dict(note="the two batch sizes ran different operations",
                        ops=[len(traces[1]), len(traces[8])])
        for (name, ins1, one), (_, ins8, eight) in zip(traces[1], traces[8]):
            if same(torch, one, eight):
                continue
            differing += 1
            if len(ins1) != len(ins8) or not all(same(torch, a, b) for a, b in zip(ins1, ins8)):
                continue
            eight = row0(one, eight)
            diff = (None if eight is None else (one.float() - eight.float()).abs().max().item()
                    / (one.float().abs().max().item() or 1.0))
            o = origins.setdefault(name, dict(count=0, max_abs_diff_over_max=0.0,
                                              input_shapes_m8=[list(a.shape) for a in ins8
                                                               if not isinstance(a, tuple)]))
            o["count"] += 1
            o["max_abs_diff_over_max"] = max(o["max_abs_diff_over_max"], diff or 0.0)
        for key, st in caches[1].items():
            if isinstance(st, dict):
                for n, t in st.items():
                    caches[8][key][n].copy_(t.expand(caches[8][key][n].shape))
    return dict(steps=steps, ops_per_step=len(traces[1]), differing_outputs=differing,
                batch_dependent_ops=origins)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_griffin_rows: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from chip_smoke import nvidia_smi_line, perturb
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.models import griffin
    from repro_torch.models import layers as L

    cfg = recurrentgemma_9b.full_config()
    base = griffin.init(cfg, seed=0, device="cuda")
    params = perturb(torch, base, 2, 1.0, lambda p: p.startswith("final_norm/"))
    gen = torch.Generator().manual_seed(300)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS,), generator=gen).tolist()
    shipped = {"gqa": L.gqa_attention, "gate": griffin._block_dense, "norm": L.rms_norm}
    variants = {"shipped": shipped,
                "ring_rows": dict(shipped, gqa=per_row(shipped["gqa"], 4)),
                "ring_gate_rows": dict(shipped, gqa=per_row(shipped["gqa"], 4),
                                       gate=per_row(shipped["gate"], 1)),
                "ring_gate_norm_rows": {"gqa": per_row(shipped["gqa"], 4),
                                        "gate": per_row(shipped["gate"], 1),
                                        "norm": per_row(shipped["norm"], 1)}}
    smi = nvidia_smi_line()
    print(json.dumps({"trace": batch_dependent_ops(torch, griffin, cfg, params, tokens, 16),
                      "device": smi}), flush=True)
    summary = {}
    for name, ops in variants.items():
        L.gqa_attention, griffin._block_dense, L.rms_norm = ops["gqa"], ops["gate"], ops["norm"]
        one = replay(torch, griffin, cfg, params, tokens, 1)
        eight = replay(torch, griffin, cfg, params, tokens, 8)
        worst, flips = 0.0, 0
        for a, b in zip(one, eight):
            worst = max(worst, ((b - a).abs().max() / a.abs().max()).item())
            flips += int(a.argmax()) != int(b.argmax())
        summary[name] = worst
        print(json.dumps({"variant": name, "steps": STEPS, "rows_compared": len(one),
                          "max_abs_err_over_row_max": worst, "argmax_flips": flips,
                          "bitwise": all(torch.equal(a, b) for a, b in zip(one, eight)),
                          "device": smi}), flush=True)
    L.gqa_attention, griffin._block_dense, L.rms_norm = (shipped["gqa"], shipped["gate"],
                                                          shipped["norm"])
    print(json.dumps({"summary": summary, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
