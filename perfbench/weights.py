"""The members' weights, drawn from the run's seed on the device.

A layout is ``{path: (shape, dtype)}``: the run reads it from the
adapter's ``meta`` tree, the reference builds its own from the
configuration, and the two draw the same values only where they agree on
every leaf.  The values are the benchmark's own.  A model is cut into units (the embedding, each
block, the head: the final norm and the unembedding).  For each unit one
base is drawn, and each member adds its own noise to it: trunk leaves
``+ 0.005 * N(0, 1)``, head leaves ``+ 1.0 * N(0, 1)`` (variants of one base
with fine-tuned heads).  Each draw is one call of a generator seeded by
(seed, member, unit), so the reference can draw any unit again, bitwise,
without holding the whole zoo.

Base values by leaf kind follow the families' published initialisations:
matrices N(0, 1/d_in), the embedding N(0, 0.02), norms at identity, the
selective scan's A as -[1..n] per channel (stored as its log), D at one,
and dt's bias the inverse softplus of a log-uniform step in [1e-3, 0.1].
"""
from __future__ import annotations

import math

import torch

from perfbench.common import stable_seed

TRUNK_NOISE = 0.005
HEAD_NOISE = 1.0
HEAD_PREFIXES = ("final_norm/", "lm_head/")
NORMS = ("ln", "ln1", "ln2", "final_norm")  # the parents of norm leaves


def is_head(path: str) -> bool:
    return path.startswith(HEAD_PREFIXES)


def unit_of(path: str) -> str:
    """``embed``, ``blocks/<i>`` or ``head``."""
    if is_head(path):
        return "head"
    parts = path.split("/")
    return "/".join(parts[:2]) if parts[0] == "blocks" else parts[0]


def layout_of(meta: dict) -> dict:
    """{path: (shape, dtype)} of a flat tree of (``meta``) tensors."""
    return {p: (tuple(int(s) for s in t.shape), t.dtype) for p, t in meta.items()}


def units(layout: dict) -> dict:
    """{unit: [(path, shape, dtype), ...] in sorted path order}."""
    out: dict = {}
    for path in sorted(layout):
        shape, dtype = layout[path]
        out.setdefault(unit_of(path), []).append((path, tuple(shape), dtype))
    return out


def _base(path: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    """The base value of one leaf (float32) from its slice ``z`` of a
    standard normal draw."""
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""
    if path == "embed/table":
        return 0.02 * z
    if name == "A_log":
        n = shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=z.device)
        return torch.log(a).expand(shape).contiguous()
    if name == "D":
        return torch.ones(shape, device=z.device)
    if parent == "dt_proj" and name == "b":
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))  # uniform on (0, 1)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        return torch.log(torch.expm1(dt))
    if parent == "conv" and name == "w":
        return z / math.sqrt(shape[0])
    if name in ("b", "bias", "bq", "bk", "bv", "b_up", "b_down"):
        return torch.zeros(shape, device=z.device)
    if len(shape) == 2:
        return z / math.sqrt(shape[0])
    return torch.zeros(shape, device=z.device)


def norm_identity(path: str, kind: str, shape: tuple, device) -> torch.Tensor:
    """The identity value of a norm leaf: a layer norm's scale is 1, an rms
    norm's stored offset 0, every bias 0."""
    if path.endswith("/scale") and kind == "layernorm":
        return torch.ones(shape, device=device)
    return torch.zeros(shape, device=device)


def draw_unit(seed: int, member_index: int, unit: str, leaves: list, norm: str,
              device) -> dict:
    """{path: tensor in the leaf's dtype} of one member's unit."""
    sizes = [int(math.prod(shape)) for _, shape, _ in leaves]
    total = sum(sizes)
    g = torch.Generator(device=device).manual_seed(stable_seed(seed, "base", unit))
    base = torch.randn(total, generator=g, device=device)
    g.manual_seed(stable_seed(seed, "member", member_index, unit))
    noise = torch.randn(total, generator=g, device=device)
    out = {}
    off = 0
    for (path, shape, dtype), n in zip(leaves, sizes):
        z = base[off:off + n].view(shape)
        if path.split("/")[-2] in NORMS:
            value = norm_identity(path, norm, shape, device)
        else:
            value = _base(path, shape, z)
        scale = HEAD_NOISE if is_head(path) else TRUNK_NOISE
        out[path] = (value + scale * noise[off:off + n].view(shape)).to(dtype)
        off += n
    return out


def draw_member(seed: int, member_index: int, layout: dict, norm: str, device,
                only=None) -> dict:
    """Flat {path: tensor} of one member (``only``: the units to draw)."""
    out = {}
    for unit, leaves in units(layout).items():
        if only is None or unit in only:
            out.update(draw_unit(seed, member_index, unit, leaves, norm, device))
    return out
