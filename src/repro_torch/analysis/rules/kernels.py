"""A101/A102/A103 — kernel-dispatch discipline, the port's counterpart.

In the port ``kernels/ops.py`` dispatches on the tensor's device alone: a
CPU or meta tensor takes the plain version in ``kernels/ref.py``, a CUDA
tensor the hand-written Hopper kernel, or the call raises.  There is no
mode and no fallback, and these rules keep it so:

* A101: outside ``repro_torch/kernels/`` code imports only
  ``repro_torch.kernels`` and ``repro_torch.kernels.ops``.  Kernel wrapper
  modules and ``_build`` are off limits, and so is ``kernels.ref``: with a
  card present a plain version serves nothing on the main path.
* A102 (the counterpart of the JAX package's required ``interpret``): the
  wrapper modules do not import ``kernels.ref`` (a wrapper that fell back
  to its plain version would hide a kernel that does not launch), no
  ``ops`` dispatcher takes a ``mode`` argument, and nothing under
  ``src/repro_torch`` reads a kernel-mode environment variable.
* A103: model modules call no private implementation that shadows an
  ``OP_TABLE`` op; intentional call sites carry a pragma with a reason.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import rule

KERNELS = "repro_torch.kernels"
ALLOWED_MODULES = {KERNELS, f"{KERNELS}.ops"}
REF = f"{KERNELS}.ref"
# the modules of repro_torch/kernels/ that are not kernel wrappers
NOT_WRAPPERS = ("ops.py", "ref.py", "_build.py", "__init__.py")
# an environment variable that would pick a kernel backend or mode
KERNEL_MODE_ENV = re.compile(r"KERNEL.*(MODE|BACKEND)|(MODE|BACKEND).*KERNEL")


@rule(
    "A101",
    "kernel imports go through kernels.ops",
    "Outside repro_torch/kernels/ code imports only repro_torch.kernels and "
    "repro_torch.kernels.ops: kernel wrapper modules, _build and the plain "
    "versions in kernels.ref are off limits.",
    "import repro_torch.kernels.ops and call the public entry point; the "
    "tensor's device picks the kernel or its plain version",
    "the kernels.ops dispatch layer; the port's no-fallback rule",
)
def kernel_import_discipline(ctx):
    if ctx.rel.startswith("src/repro_torch/kernels/"):
        return  # the kernel package itself (incl. ops.py) is the one owner
    seen = set()  # one finding per line (`from x import y` yields x and x.y)
    for line, mod in ctx.literal_imports():
        if mod.startswith(KERNELS) and mod not in ALLOWED_MODULES \
                and line not in seen:
            seen.add(line)
            yield line, (f"direct kernel-module import '{mod}' bypasses the "
                         "kernels.ops dispatch layer")


def _environ_reads(ctx):
    """``(line, name)`` for each environment variable named by a string
    literal in ``os.environ[...]``, ``os.environ.get(...)``,
    ``os.getenv(...)`` or ``"..." in os.environ``."""
    for node in ast.walk(ctx.tree):
        names = []
        if isinstance(node, ast.Subscript) \
                and ctx.qualname(node.value) == "os.environ":
            names = [node.slice]
        elif isinstance(node, ast.Call) and ctx.qualname(node.func) in (
                "os.environ.get", "os.getenv"):
            names = node.args[:1]
        elif isinstance(node, ast.Compare) and any(
                ctx.qualname(c) == "os.environ" for c in node.comparators):
            names = [node.left]
        for n in names:
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                yield node.lineno, n.value


@rule(
    "A102",
    "no kernel mode and no fallback",
    "The kernel wrapper modules (repro_torch/kernels/*.py other than ops, "
    "ref, _build and __init__) never import kernels.ref; no kernels.ops "
    "dispatcher takes a `mode` argument; nothing under src/repro_torch "
    "reads a kernel-mode environment variable.  The tensor's device alone "
    "picks the kernel or its plain version.",
    "dispatch on the tensor's device in kernels/ops.py; a wrapper raises on "
    "what its kernel does not take instead of computing it another way",
    "the JAX package's A102 (a required `interpret`); the port's "
    "no-fallback rule",
)
def kernel_no_mode(ctx):
    for line, name in _environ_reads(ctx):
        if KERNEL_MODE_ENV.search(name):
            yield line, (f"reads the environment variable {name} — the "
                         "port picks a kernel by the tensor's device, never "
                         "by a mode")
    if not ctx.rel.startswith("src/repro_torch/kernels/"):
        return
    base = ctx.rel.rsplit("/", 1)[-1]
    if base == "ops.py":
        for node in ctx.tree.body:
            if not isinstance(node, ast.FunctionDef) \
                    or node.name.startswith("_"):
                continue
            a = node.args
            if any(p.arg == "mode"
                   for p in a.posonlyargs + a.args + a.kwonlyargs):
                yield node.lineno, (f"{node.name}: an ops dispatcher takes a "
                                    "`mode` argument — dispatch on the "
                                    "tensor's device")
        return
    if base in NOT_WRAPPERS:
        return
    for line, mod in ctx.literal_imports():
        if mod == REF or mod.startswith(REF + "."):
            yield line, (f"kernel wrapper imports '{mod}' — a wrapper "
                         "launches its kernel or raises, it never falls "
                         "back to the plain version")
            break


# Private implementations that shadow a congruent OP_TABLE op.  Calling one
# from a model module puts a plain path where the op's kernel was meant to
# serve (in the JAX package the scans once never reached their kernels).
SHADOWED_IMPLS = {
    "_scan_fused": "mamba_scan",
    "_scan_diag": "rg_lru_scan",
    "blocked_causal_attention": "flash_attention",
}


@rule(
    "A103",
    "model hot paths dispatch through OP_TABLE ops",
    "Model modules must not call private scan/attention implementations "
    "(layers.blocked_causal_attention, or a private scan helper such as "
    "_scan_fused/_scan_diag) when a congruent OP_TABLE op exists.  "
    "Intentional plain-only call sites (explicit positions the kernel "
    "cannot express) carry a `repro: allow[A103]` pragma with a reason.",
    "route through kernels.ops.mamba_scan / rg_lru_scan / flash_attention; "
    "keep the private implementation only as the plain path behind a "
    "justified pragma",
    "dead scan kernels that never reached the serving hot path",
)
def model_ops_dispatch(ctx):
    if not ctx.rel.startswith("src/repro_torch/models/"):
        return
    if ctx.rel.rsplit("/", 1)[-1] == "layers.py":
        return  # layers.py *defines* the plain implementations
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        op = SHADOWED_IMPLS.get(name)
        if op:
            yield node.lineno, (f"call to private `{name}` shadows "
                                f"OP_TABLE op `{op}` — dispatch through "
                                f"kernels.ops.{op} (or justify with a "
                                "pragma)")
