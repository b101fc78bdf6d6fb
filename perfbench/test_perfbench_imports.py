"""Nothing the benchmark runs imports JAX, the JAX package, its bench
folder or the port's own benches, and the references import nothing of
the port (module names compared by whole top-level names: the port's name
begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py"))


def imports(path: Path) -> list:
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out += [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.append(node.args[0].value)
    return out


def forbidden(name: str, in_reference: bool) -> bool:
    top = name.split(".", 1)[0]
    if top in ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"):
        return True
    if name == "repro_torch.bench" or name.startswith("repro_torch.bench."):
        return True
    return in_reference and top == "repro_torch"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    in_ref = "reference" in path.relative_to(HERE).parts
    bad = [n for n in imports(path) if forbidden(n, in_ref)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_guard_sees_whole_names():
    assert forbidden("jax.numpy", False) and forbidden("repro.kernels", False)
    assert not forbidden("repro_torch.kernels", False)
    assert forbidden("repro_torch.kernels", True)
    assert forbidden("repro_torch.bench.lm_merging", False)
    assert not forbidden("repro_torch.benchmark_x", False)
