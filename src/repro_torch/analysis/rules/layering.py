"""A401 — declared layering DAG, and the port's self-containment.

The JAX package's DAG (``repro.analysis.rules.layering``) over
``repro_torch.*``: each package imports only the packages its row allows,
resolved through the AST, so aliased and ``importlib.import_module`` /
``__import__`` string-literal imports count.  Rows the JAX package does not
have cover the port's own packages: ``bench`` and ``examples`` (the JAX
package keeps those outside ``src/``), ``analysis`` and the top-level
``bridge`` module.

Two edges are wider than the JAX package's, each for a fact of the port:

* ``data -> distributed``: ``data.synthetic.sharded_iter`` places a batch
  with ``distributed.partitioning.place_tree``, where the JAX package calls
  ``jax.device_put`` (``data`` reaches ``distributed`` through ``train``
  in both packages already).
* ``serving -> kernels``: a captured CUDA graph launches no kernel wrapper
  on replay, so ``serving.graphs`` adds the launches it captured back to
  the kernels' counters through ``kernels.ops`` (``launch_counters`` /
  ``add_launch_counters``).  A101 still holds ``serving`` to ``kernels``
  and ``kernels.ops``.

The rule also holds the port to the convention that lets it run where only
PyTorch is installed: no file under ``src/repro_torch`` imports ``jax``,
``jaxlib`` or the JAX package ``repro``, whatever its package."""
from __future__ import annotations

from repro_torch.analysis.engine import rule

#: package -> packages it may import directly (src/repro_torch only;
#: transitive reach comes from following edges, not from listing them twice).
ALLOWED_IMPORTS = {
    "utils": set(),
    "kernels": {"utils"},
    "distributed": {"utils"},
    "bridge": {"utils"},
    "train": {"distributed", "utils"},
    "data": {"distributed", "train", "utils"},
    # core/serving may import distributed (the mesh-sharded serve tier) but
    # NEVER launch — mesh/rule construction stays with the callers
    "core": {"distributed", "train", "utils"},
    "models": {"core", "kernels", "distributed", "utils"},
    "configs": {"core", "models", "utils"},
    "ckpt": {"core", "distributed", "train", "utils"},
    "runtime": {"ckpt", "distributed", "utils"},
    "serving": {"core", "configs", "distributed", "kernels", "runtime", "utils"},
    "launch": {"ckpt", "configs", "core", "data", "distributed", "kernels",
               "models", "runtime", "serving", "train", "utils"},
    "bench": {"ckpt", "configs", "core", "data", "distributed", "kernels",
              "models", "runtime", "serving", "train", "utils"},
    "examples": {"bench", "ckpt", "configs", "core", "data", "distributed",
                 "kernels", "models", "runtime", "serving", "train", "utils"},
    "analysis": {"kernels", "utils"},
}

#: top-level modules no file of the port may import
FOREIGN = ("jax", "jaxlib", "repro")


def _package_of(rel: str):
    parts = rel.split("/")
    if len(parts) >= 3 and parts[0] == "src" and parts[1] == "repro_torch":
        return parts[2].removesuffix(".py") if len(parts) == 3 else parts[2]
    return None


@rule(
    "A401",
    "imports follow the declared package DAG; no JAX",
    "Each package under src/repro_torch imports only the packages its DAG "
    "row allows, and no file there imports jax, jaxlib or the JAX package "
    "repro.  Resolution is AST-based, so aliased and importlib/__import__ "
    "string-literal forms count.",
    "depend on the lower layer's public API (widening the DAG is a "
    "reasoned change to this rule's rows); keep what the port needs of the "
    "JAX package as a copy inside src/repro_torch",
    "the adapter API boundary (a grep, upgraded) and the serving layering; "
    "the port's self-containment convention",
)
def layering_dag(ctx):
    pkg = _package_of(ctx.rel)
    if pkg is None:
        return
    seen = set()  # one finding per (line, offending package or module)
    for line, mod in ctx.literal_imports():
        root = mod.split(".")[0]
        if root in FOREIGN:
            if (line, root) not in seen:
                seen.add((line, root))
                yield line, (f"repro_torch imports {mod} — the port runs "
                             "where only PyTorch is installed, so it imports "
                             "no JAX and nothing of the JAX package")
            continue
        if pkg not in ALLOWED_IMPORTS or not mod.startswith("repro_torch."):
            continue
        allowed = ALLOWED_IMPORTS[pkg] | {pkg}
        target = mod.split(".")[1]
        if target in ALLOWED_IMPORTS and target not in allowed \
                and (line, target) not in seen:
            seen.add((line, target))
            yield line, (f"repro_torch.{pkg} imports {mod} — the layering "
                         f"DAG allows {pkg} -> "
                         f"{{{', '.join(sorted(ALLOWED_IMPORTS[pkg]))}}}")
