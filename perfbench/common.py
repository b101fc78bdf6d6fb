"""Shared plumbing of the benchmark: where its files are, how a cell's
files are found by name, stable seeds, and the statistics every metric
uses.

Every configuration, traffic mix, cell and per-layer metric is a file of
its own under this folder, found by the name ``BENCHMARK.json`` gives it:

    configs/<config>.json      sizes of one model, as they are run
    traffic/<mix>.json         parameters the one generator reads
    workloads/<cell>.json      a cell: its config, mix, engine knobs, limits
    metrics/<metric>.py        a reader: read(run) -> float or None
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"

# the modules no run may hold once its window has closed, compared by whole
# top-level names (the port's name begins with the reference package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def put_src_on_path() -> None:
    """Make the repository root and ``src`` importable (the command runs
    ``perfbench/run.py`` as a script)."""
    for p in (str(SRC), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under this folder."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "perfbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def stable_seed(*parts) -> int:
    """A 63-bit seed from any parts (a run's seed and the name of a draw):
    the same parts give the same seed in every process."""
    h = hashlib.blake2b("/".join(str(p) for p in parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values: the
    smallest value with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        return math.nan
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[rank - 1])


def forbidden_modules() -> list:
    """Names of loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))
