"""Roofline: three terms per (arch x shape x mesh) cell from the dry run's
artifacts (``artifacts/torch/dryrun/*.json``), against one NVIDIA H100
SXM (80 GB HBM3) at its 700 W limit, from NVIDIA's data sheet (the port of
``benchmarks/roofline.py``).

    PYTHONPATH=src python -m repro_torch.bench.roofline [TAG]

    compute    = flops_per_device / peak        (989e12 flop/s, bf16 dense)
    memory     = bytes_per_device / HBM rate    (3.35e12 B/s)
    collective = wire_bytes_per_device / link   (450e9 B/s, NVLink each way)

The dry run's counts are the whole trace split evenly over the mesh
(``launch.dryrun``), so every term is per card.  One controller makes no
collectives: a cell's ``collective_wire_bytes`` is ``null`` and so is its
collective term; ``dominant`` is taken over the terms that exist.
MODEL_FLOPS uses 6·N·D (train), 2·N·D (prefill) or 2·N·B (decode), with
N_active for moe; the ratio MODEL_FLOPS / (counted flops x devices) shows
what the count adds to the model's own GEMMs (attention, the moe
dispatch, a train step's recompute-free backward through its plain
attention).
"""
from __future__ import annotations

import glob
import json
import math
import os
import sys

from repro_torch.bench.common import emit
from repro_torch.configs.registry import load_arch
from repro_torch.models.registry import get_family
from repro_torch.utils.tree import flatten_paths

PEAK_FLOPS = 989e12  # bf16 dense tensor core / card
HBM_BW = 3.35e12  # B/s
LINK_BW = 450e9  # B/s, NVLink each way
HBM_BYTES = 80e9

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "torch",
                          "dryrun")

_PARAM_CACHE: dict = {}


def _param_counts(arch: str):
    """(N_total, N_active) parameters, from the family's init on ``meta``."""
    if arch in _PARAM_CACHE:
        return _PARAM_CACHE[arch]
    mod = load_arch(arch)
    cfg = mod.full_config()
    flat = flatten_paths(get_family(mod.FAMILY).init(cfg, 0, device="meta"))
    n = sum(math.prod(x.shape) for x in flat.values())
    n_active = n
    if mod.FAMILY == "moe":
        # subtract the inactive routed experts
        expert_params = sum(math.prod(x.shape) for path, x in flat.items()
                            if "/experts/" in path)
        frac_active = cfg.top_k / cfg.n_experts
        n_active = n - expert_params + int(expert_params * frac_active)
    _PARAM_CACHE[arch] = (n, n_active)
    return n, n_active


def model_flops(arch: str, shape_name: str, kind: str) -> float:
    mod = load_arch(arch)
    shape = mod.SHAPES[shape_name]
    n, n_active = _param_counts(arch)
    tokens = shape.global_batch * shape.seq_len
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: 1 new token/row


def load_cells(tag: str = "") -> list:
    """Every cell the dry run wrote (``tag`` is unused, as in the
    reference), each marked ``source: traced``: the port's eager trace
    counts every layer and microbatch, so no probe overlays it."""
    cells = {}
    for f in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        with open(f) as fh:
            c = json.load(fh)
        c["source"] = "traced"
        cells[(c["arch"], c["shape"], c["mesh"])] = c
    return list(cells.values())


def analyse(cell: dict) -> dict:
    arch, shape, mesh = cell["arch"], cell["shape"], cell["mesh"]
    compute_s = cell["flops_per_device"] / PEAK_FLOPS
    memory_s = cell["bytes_per_device"] / HBM_BW
    wire = cell.get("collective_wire_bytes")
    collective_s = None if wire is None else wire / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    present = {k: v for k, v in terms.items() if v is not None}
    dominant = max(present, key=present.get)
    bound = max(present.values())
    mf = model_flops(arch, shape, cell["kind"])
    total = cell["flops_per_device"] * max(cell["n_devices"], 1)
    useful = mf / total if total else 0.0
    # roofline fraction: useful-compute time over the bound (how close the
    # dominant term is to pure model compute at peak)
    ideal_s = (mf / max(cell["n_devices"], 1)) / PEAK_FLOPS
    frac = ideal_s / bound if bound > 0 else 0.0
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "kind": cell["kind"],
        "source": cell.get("source", "traced"),
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops_ratio": useful, "roofline_fraction": frac,
        "peak_gb": cell["peak_bytes_estimate"] / 1e9,
        "fits_hbm": cell["peak_bytes_estimate"] <= HBM_BYTES,
    }


def device_count() -> int:
    import torch

    return torch.cuda.device_count()


def run_bank_collectives() -> dict:
    """The reference's three partitionings of the bank GEMM, compared in
    collective bytes, need 8 devices; below 8 it emits a skip row, and this
    port drives one card from one controller: the skip row, with the
    device count."""
    n = device_count()
    return emit("roofline_collectives", [
        {"lane": "skipped", "reason": f"{n} devices < 8"}],
        {"sharded": False, "devices": n})


def run(tag: str = "") -> dict:
    run_bank_collectives()
    cells = load_cells(tag)
    rows = [analyse(c) for c in cells if c.get("ok") and c.get("kind") != "skip"]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    skipped = [c for c in cells if c.get("kind") == "skip"]
    n_oom = sum(1 for r in rows if not r["fits_hbm"])
    dom: dict = {}
    for r in rows:
        dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
    return emit("roofline" + (f"_{tag}" if tag else ""), rows, {
        "cells_analysed": len(rows),
        "cells_skipped_by_design": len(skipped),
        "cells_over_80GB_hbm": n_oom,
        "dominant_term_histogram": dom,
    })


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "")
