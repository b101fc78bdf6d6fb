"""A501 — no host sync inside a captured step body.

The port's counterpart of the JAX package's tracer hygiene.  On a card the
decode steps are captured as CUDA graphs (``serving.graphs.StepGraphs``):
``StepGraphs.capture(key, body, fixed, shapes)`` records ``body`` once and
every later step replays it.  A host read of a device value inside the body
(``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, or ``float()`` /
``int()`` / ``bool()`` of a tensor) synchronises the stream, which a
capture refuses, and its value would be frozen into the graph anyway.  The
CPU never captures, so without this rule such a read shows only on the
card.

What counts as a captured body, best effort as the JAX package's rule is:
the second argument of a ``.capture(...)`` call naming a function of this
file (every ``def`` of that name), or a call of such a function, whose
nested ``def`` s that it returns are then the bodies.  Inside a body the
values derived from its parameters are tainted (an assignment from a
tainted expression taints its targets); ``.shape``, ``.dim()``,
``.dtype``, ``.device``, ``.ndim`` and ``.size()`` reads are static and
exempt."""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import rule

CONCRETIZERS = {"float", "int", "bool"}
HOST_READS = {"item", "tolist", "cpu", "numpy"}
STATIC_ATTRS = {"shape", "dim", "dtype", "device", "ndim", "size"}


def _defs_by_name(ctx) -> dict:
    out: dict = {}
    for n in ast.walk(ctx.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(n.name, []).append(n)
    return out


def _returned_defs(fn) -> list:
    """The nested defs ``fn`` returns by name."""
    nested = {n.name: n for n in fn.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Name) \
                and n.value.id in nested:
            out.append(nested[n.value.id])
    return out


def _capture_targets(ctx) -> list:
    """Every function of this file that flows into ``.capture(key, body,
    ...)`` as its body."""
    defs = _defs_by_name(ctx)
    targets: list = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "capture"):
            continue
        body = node.args[1] if len(node.args) > 1 else next(
            (kw.value for kw in node.keywords if kw.arg == "body"), None)
        if isinstance(body, ast.Name):
            found = defs.get(body.id, [])
        elif isinstance(body, ast.Call) and isinstance(body.func, ast.Name):
            found = [r for f in defs.get(body.func.id, [])
                     for r in _returned_defs(f)]
        else:
            found = []
        targets.extend(f for f in found if f not in targets)
    return targets


def _param_names(fn) -> set:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
             if p.arg not in ("self", "cls")}
    for p in (a.vararg, a.kwarg):
        if p is not None:
            names.add(p.arg)
    return names


def _mentions(node, names) -> bool:
    """True when the expression references any of the names, ignoring
    static reads like ``q.shape[0]`` or ``x.dim()``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in names:
            parent = getattr(n, "_repro_parent", None)
            if isinstance(parent, ast.Attribute) \
                    and parent.attr in STATIC_ATTRS:
                continue
            return True
    return False


def _assigned_names(target) -> set:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _tainted(fn) -> set:
    """The parameters of ``fn`` and every name assigned from them, to a
    fixed point."""
    tainted = _param_names(fn)
    while True:
        grown = set(tainted)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _mentions(node.value, grown):
                for t in node.targets:
                    grown |= _assigned_names(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None \
                    and _mentions(node.value, grown):
                grown |= _assigned_names(node.target)
            elif isinstance(node, (ast.For, ast.comprehension)) \
                    and _mentions(node.iter, grown):
                grown |= _assigned_names(node.target)
        if grown == tainted:
            return tainted
        tainted = grown


@rule(
    "A501",
    "no host sync in a captured step body",
    "Functions that flow into StepGraphs.capture(key, body, ...) never "
    "read a device value on the host: no .item()/.tolist()/.cpu()/.numpy() "
    "and no float()/int()/bool() of values derived from their parameters; "
    ".shape/.dim()/.dtype/.device reads are exempt.",
    "keep the step's math on the device (torch.where for branches); a "
    "value the host needs goes in as a host argument of the replay",
    "the JAX package's A501 (tracer hygiene); the decode steps' CUDA graphs",
)
def capture_hygiene(ctx):
    for fn in _capture_targets(ctx):
        tainted = _tainted(fn)
        if not tainted:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) \
                    and node.func.id in CONCRETIZERS \
                    and node.func.id not in ctx.aliases \
                    and node.args and _mentions(node.args[0], tainted):
                yield node.lineno, (
                    f"{fn.name}: {node.func.id}() reads a device value on "
                    "the host inside a captured step body")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in HOST_READS \
                    and _mentions(node.func.value, tainted):
                yield node.lineno, (
                    f"{fn.name}: .{node.func.attr}() reads a device value on "
                    "the host inside a captured step body")
