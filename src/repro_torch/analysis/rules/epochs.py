"""A201/A202 — epoch discipline.

Every cache in the serving stack (materialized pytrees, suffix banks, the
prefix-group plan, paged-KV derived state) is keyed on a binding epoch; the
whole hot-swap story is "mutate, then exactly ONE bump".  Zero bumps serve
stale pytrees over new bindings; two bumps double-invalidate and break the
"engine re-plans exactly once" guarantees the hot swap gates on.  A201 checks
the owning class's public mutators; A202 checks that nobody outside an
epoch-owning class writes the counter directly (``bump_epoch()`` is the only
door — the failed-swap rollback in ``MergeAwareEngine.apply_plan`` settles
the epoch through it, never by assignment)."""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import rule

# The epoch-guarded state of the weight substrate: rebinding or committing
# either invalidates every cached pytree.  (PagedKVPool's `tables` are
# deliberately NOT here: page tables are request state, not weight-derived
# cache — its epoch mirrors the store's and moves only on hot swap.)
TRACKED_ATTRS = {"buffers", "bindings"}
MUTATING_METHODS = {"update", "pop", "clear", "setdefault", "popitem",
                    "append", "extend", "remove", "insert"}
EPOCH_ATTRS = {"epoch", "_epoch"}


def _roots_at_tracked_self(node):
    """True when an expression chain (subscripts/attributes) bottoms out at
    ``self.<tracked>`` — e.g. ``self.bindings[m][p]``."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and node.attr in TRACKED_ATTRS:
            return True
        node = node.value
    return False


def _method_mutations(fn):
    """Lines on which a method writes tracked state."""
    lines = []
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATING_METHODS \
                and _roots_at_tracked_self(node.func.value):
            lines.append(node.lineno)
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if _roots_at_tracked_self(el):
                    lines.append(node.lineno)
    return lines


def _bump_calls(fn):
    return [n.lineno for n in ast.walk(fn)
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "bump_epoch"
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "self"]


@rule(
    "A201",
    "store mutations bump the epoch exactly once",
    "Any public method of an epoch-owning class (one defining bump_epoch) "
    "that writes buffers/bindings reaches exactly one self.bump_epoch() call "
    "site on its success path.",
    "stage mutations, commit, then ONE self.bump_epoch(); private _helpers "
    "called from a bumping method stay bump-free",
    "ParamStore binding epochs / apply_plan's single bump",
)
def epoch_bump_discipline(ctx):
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
        if not any(m.name == "bump_epoch" for m in methods):
            continue
        for m in methods:
            if m.name.startswith("_") or m.name == "bump_epoch":
                continue  # helpers/dunders: covered via their public callers
            if any(isinstance(d, ast.Name)
                   and d.id in ("classmethod", "staticmethod")
                   for d in m.decorator_list):
                continue  # no self: constructs a new object, epoch starts fresh
            muts = _method_mutations(m)
            if not muts:
                continue
            bumps = _bump_calls(m)
            if not bumps:
                yield muts[0], (f"{cls.name}.{m.name} mutates "
                                f"{'/'.join(sorted(TRACKED_ATTRS))} without "
                                "reaching self.bump_epoch()")
            elif len(bumps) > 1:
                yield bumps[1], (f"{cls.name}.{m.name} has "
                                 f"{len(bumps)} bump_epoch call sites — "
                                 "caches would invalidate more than once")


@rule(
    "A202",
    "epoch counters are written only by their owner",
    "No code assigns another object's epoch/_epoch attribute, and inside an "
    "epoch-owning class only __init__ and bump_epoch write self's counter — "
    "everyone else goes through bump_epoch().",
    "call obj.bump_epoch() instead of assigning obj.epoch",
    "revert and the failed-swap rollback settle epochs via bump_epoch",
)
def epoch_ownership(ctx):
    owning = set()
    for cls in ast.walk(ctx.tree):
        if isinstance(cls, ast.ClassDef) and any(
                isinstance(n, ast.FunctionDef) and n.name == "bump_epoch"
                for n in cls.body):
            owning.add(cls)
    for node in ast.walk(ctx.tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if not (isinstance(el, ast.Attribute)
                        and el.attr in EPOCH_ATTRS):
                    continue
                if not (isinstance(el.value, ast.Name)
                        and el.value.id == "self"):
                    yield node.lineno, (
                        "writes an epoch counter through another object "
                        f"({ast.unparse(el)}) — only bump_epoch() may move it")
                    continue
                # self.epoch: fine unless this class owns an epoch and we're
                # outside __init__/bump_epoch
                fn = node
                while fn is not None and not isinstance(fn, ast.FunctionDef):
                    fn = ctx.parent(fn)
                cls = fn
                while cls is not None and not isinstance(cls, ast.ClassDef):
                    cls = ctx.parent(cls)
                if cls in owning and fn is not None \
                        and fn.name not in ("__init__", "bump_epoch"):
                    yield node.lineno, (
                        f"{cls.name}.{fn.name} writes self.{el.attr} "
                        "directly — route the move through bump_epoch()")
