"""The A-series rules over ``src/repro_torch``.

Importing this package registers every rule with the engine.  Rule ids are
the JAX package's (they appear in suppression pragmas), so renumber
nothing; retire a rule by deleting its module.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    determinism,
    epochs,
    ids,
    kernels,
    layering,
    tracers,
)
