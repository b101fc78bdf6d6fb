"""A601 — no builtin hash() for persistent identifiers.

The JAX package's first group keys used ``hash(layer_signature)``; the
keys changed across interpreter runs (PYTHONHASHSEED randomizes str/bytes
hashing) and checkpointed plans stopped resolving on restart.  The fix — and now the
invariant — is ``hashlib.blake2b`` for anything that outlives the process:
plan keys, buffer ids, checkpoint manifests, artifact names.  Implicit
hashing (dict/set membership) is untouched; an *explicit* ``hash()`` call is
flagged unless it is the established hashability-probe idiom (a bare
``hash(x)`` expression statement inside ``try: ... except TypeError``) —
anything else is one assignment away from becoming a persisted id."""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import rule


def _is_hashability_probe(ctx, call):
    """True for the probe idiom: the call is a bare Expr statement whose
    enclosing try has an ``except TypeError`` handler."""
    parent = ctx.parent(call)
    if not isinstance(parent, ast.Expr):
        return False
    node = parent
    while node is not None:
        if isinstance(node, ast.Try):
            for h in node.handlers:
                t = h.type
                names = t.elts if isinstance(t, ast.Tuple) else [t]
                for n in names:
                    if isinstance(n, ast.Name) and n.id == "TypeError":
                        return True
        node = ctx.parent(node)
    return False


@rule(
    "A601",
    "persistent ids never come from builtin hash()",
    "No explicit builtin hash() calls: with PYTHONHASHSEED randomization "
    "the result differs across runs, so any id, key or filename built from "
    "it breaks on restart.  Bare hash(x) probes inside try/except TypeError "
    "remain legal; implicit dict/set hashing is untouched.",
    "use repro_torch.utils.ids.stable_hash / hashlib.blake2b(repr(x).encode(), "
    "digest_size=8).hexdigest() for anything that outlives the process",
    "group keys that changed across restarts under PYTHONHASHSEED",
)
def no_builtin_hash_ids(ctx):
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "hash"
                and "hash" not in ctx.aliases):
            continue
        if _is_hashability_probe(ctx, node):
            continue
        yield node.lineno, (
            "explicit builtin hash() call — its result is not stable "
            "across processes (PYTHONHASHSEED)")
