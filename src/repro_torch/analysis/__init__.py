"""repro_torch.analysis — the port's static invariant checker.

The counterpart of ``repro.analysis``, over the port's own source and the
port's own op table; it imports torch, numpy and the standard library and
runs where JAX is not installed:

* :mod:`repro_torch.analysis.engine` — the AST rule engine, a copy of the
  JAX package's: file walker over ``src/repro_torch``, rule registry,
  ``# repro:
  allow[RULE-ID] reason`` suppression pragmas, findings with file:line and
  a fix hint, human and ``--json`` output.
* :mod:`repro_torch.analysis.rules` — the A-series rules (A101..A601) as
  the port needs them: dispatch on the tensor's device with no mode and no
  fallback, the layering DAG with no JAX import, epochs, ids, injected
  clocks and explicit generators, and no host sync inside a captured
  CUDA-graph step.
* :mod:`repro_torch.analysis.contracts` — the kernel-contract checker over
  ``kernels.ops.OP_TABLE``: on ``meta`` tensors (shapes and dtypes, no
  device) or on the card (outputs held against the plain versions, launch
  counters read).

CLI::

    python -m repro_torch.analysis [--strict] [--json] [--contracts]
    python -m repro_torch.analysis --contracts-only --device cuda
    python -m repro_torch.analysis --list-rules
"""
from repro_torch.analysis.engine import (  # noqa: F401
    Finding,
    Report,
    Rule,
    all_rules,
    analyze_paths,
    analyze_source,
    repo_root,
)
