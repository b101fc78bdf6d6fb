"""AST rule engine for the port's invariant checker.

A copy of ``repro.analysis.engine`` (no framework in it) that walks the
port's own package, ``src/repro_torch``; its benches and examples live
inside the package.

A :class:`Rule` is a named invariant with a checker over one parsed file; the
engine walks the repo, runs every applicable rule, applies ``# repro:
allow[RULE-ID] reason`` suppression pragmas, and reports findings with
file:line and a fix hint.  Rules register themselves at import time via the
:func:`rule` decorator (see ``repro_torch.analysis.rules``); the engine itself
knows nothing about any specific invariant.

Pragma semantics: a pragma suppresses matching findings on its own physical
line, or — when the pragma is a standalone comment line — on the next
non-comment line.  Every pragma must carry a reason; in ``--strict`` mode a
reason-less pragma (A001), an unknown rule id (A002) or a pragma that
suppresses nothing (A003) is itself a finding, so the shipped baseline can
never silently rot.  There is deliberately NO baseline/suppression *file*
mechanism: the only way to quiet the checker is an inline, justified pragma
at the offending line.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Iterable, Optional

PRAGMA_RE = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(.*)$")

#: Engine-level pragma-hygiene findings (reported only under ``--strict``).
PRAGMA_RULES = {
    "A001": "suppression pragma carries no reason",
    "A002": "suppression pragma names an unknown rule id",
    "A003": "suppression pragma suppresses nothing",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    reason: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.suppressed:
            s += f"  (suppressed: {self.reason or 'no reason given'})"
        elif self.hint:
            s += f"\n    fix: {self.hint}"
        return s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One enforced invariant.  ``check(ctx)`` yields ``(line, message)``
    pairs (or full messages with a custom hint via 3-tuples)."""

    id: str
    title: str
    invariant: str  # the one-line invariant statement
    hint: str
    origin: str  # the PR / lesson that motivated the rule
    check: Callable[["FileContext"], Iterable]


_REGISTRY: dict[str, Rule] = {}


def rule(id: str, title: str, invariant: str, hint: str, origin: str):
    """Decorator: register ``fn(ctx) -> iterable of (line, message)`` as the
    checker for rule ``id``."""

    def deco(fn):
        if id in _REGISTRY:
            raise ValueError(f"duplicate rule id {id}")
        _REGISTRY[id] = Rule(id, title, invariant, hint, origin, fn)
        return fn

    return deco


def all_rules() -> dict[str, Rule]:
    """The registry, importing the rule modules on first use."""
    import repro_torch.analysis.rules  # noqa: F401  (registers on import)

    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Per-file context + shared AST helpers
# ---------------------------------------------------------------------------


class FileContext:
    """One parsed file as seen by every rule: repo-relative path, source
    lines, the AST, and shared helpers (import-alias resolution, dotted-name
    rendering, parent links)."""

    def __init__(self, rel: str, source: str):
        self.rel = rel.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self._aliases: Optional[dict] = None
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._repro_parent = parent  # type: ignore[attr-defined]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_repro_parent", None)

    def in_package(self, *pkgs: str) -> bool:
        """True when the file lives under src/repro_torch/<pkg>/ for any pkg."""
        return any(self.rel.startswith(f"src/repro_torch/{p}/") for p in pkgs)

    @property
    def aliases(self) -> dict:
        """Top-level import aliases: local name -> dotted module path, e.g.
        ``np -> numpy``, ``kops -> repro_torch.kernels.ops``, and ``from time
        import monotonic`` -> ``monotonic -> time.monotonic``."""
        if self._aliases is None:
            amap: dict = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        local = a.asname or a.name.split(".")[0]
                        amap[local] = a.name if a.asname else a.name.split(".")[0]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    for a in node.names:
                        if a.name == "*":
                            continue
                        amap[a.asname or a.name] = f"{node.module}.{a.name}"
            self._aliases = amap
        return self._aliases

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with the leading alias
        resolved through this file's imports; None for non-name expressions.
        ``datetime.now`` under ``from datetime import datetime`` renders as
        ``datetime.datetime.now``."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def literal_imports(self):
        """Yield ``(line, dotted_module)`` for every statically resolvable
        import: ``import x.y``, ``from x import y`` (yields both ``x`` and
        ``x.y``), ``importlib.import_module("x.y")`` and ``__import__``
        with a string literal — the aliased/dynamic forms the old shell
        grep could not see."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    yield node.lineno, a.name
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                for a in node.names:
                    yield node.lineno, node.module
                    if a.name != "*":
                        yield node.lineno, f"{node.module}.{a.name}"
            elif isinstance(node, ast.Call):
                qn = self.qualname(node.func)
                if qn in ("importlib.import_module", "__import__") \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    yield node.lineno, node.args[0].value


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Pragma:
    line: int  # line the pragma sits on
    applies_to: int  # line the pragma suppresses findings on
    rules: tuple
    reason: str
    used: bool = False


def parse_pragmas(lines: list) -> list:
    pragmas = []
    for i, text in enumerate(lines, start=1):
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        ids = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        standalone = text.strip().startswith("#")
        target = i
        if standalone:
            # a standalone pragma comment covers the next non-comment line
            j = i
            while j < len(lines) and (not lines[j].strip()
                                      or lines[j].strip().startswith("#")):
                j += 1
            target = j + 1 if j < len(lines) else i
        pragmas.append(Pragma(i, target, ids, m.group(2).strip()))
    return pragmas


# ---------------------------------------------------------------------------
# Running
# ---------------------------------------------------------------------------


def repo_root() -> Path:
    """The repo root, located from this file
    (src/repro_torch/analysis/engine.py -> three parents up) — the CLI works
    from any cwd."""
    return Path(__file__).resolve().parents[3]


DEFAULT_ROOTS = ("src/repro_torch",)


def iter_files(root: Path, paths: Optional[list] = None) -> list:
    """Python files to analyze, repo-relative.  Defaults to the walked roots;
    explicit ``paths`` (files or directories) override."""
    sel = []
    bases = [root / p for p in (paths or DEFAULT_ROOTS)]
    for base in bases:
        if base.is_file():
            sel.append(base)
        else:
            sel.extend(sorted(base.rglob("*.py")))
    return [p for p in sel if "__pycache__" not in p.parts]


def analyze_source(rel: str, source: str,
                   rules: Optional[list] = None) -> tuple:
    """Run rules over one in-memory file.  Returns ``(findings, pragmas)``
    with suppression already applied — the unit tests feed fixture snippets
    through this without touching disk."""
    registry = all_rules()
    use = [registry[r] for r in rules] if rules else list(registry.values())
    ctx = FileContext(rel, source)
    pragmas = parse_pragmas(ctx.lines)
    findings = []
    for r in use:
        for hit in r.check(ctx):
            line, message = hit[0], hit[1]
            hint = hit[2] if len(hit) > 2 else r.hint
            f = Finding(r.id, ctx.rel, line, message, hint)
            for p in pragmas:
                if p.applies_to == line and (r.id in p.rules or "*" in p.rules):
                    p.used = True
                    f = dataclasses.replace(f, suppressed=True,
                                            reason=p.reason)
                    break
            findings.append(f)
    return findings, pragmas


@dataclasses.dataclass
class Report:
    findings: list  # unsuppressed Findings
    suppressed: list  # suppressed Findings (kept for the JSON artifact)
    pragma_findings: list  # A001/A002/A003 (strict-mode gates)
    files_scanned: int
    parse_errors: list

    def ok(self, strict: bool = False) -> bool:
        if self.findings or self.parse_errors:
            return False
        return not (strict and self.pragma_findings)

    def gating(self, strict: bool = False) -> list:
        out = list(self.findings)
        if strict:
            out += self.pragma_findings
        return sorted(out, key=lambda f: (f.path, f.line, f.rule))

    def to_json(self, strict: bool = False) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "strict": strict,
            "ok": self.ok(strict),
            "findings": [f.to_json() for f in self.gating(strict)],
            "suppressed": [f.to_json() for f in self.suppressed],
            "parse_errors": self.parse_errors,
        }


def analyze_paths(root: Optional[Path] = None,
                  paths: Optional[list] = None,
                  rules: Optional[list] = None) -> Report:
    root = root or repo_root()
    registry = all_rules()
    findings: list = []
    suppressed: list = []
    pragma_findings: list = []
    errors: list = []
    files = iter_files(root, paths)
    for path in files:
        rel = path.relative_to(root).as_posix()
        try:
            fs, pragmas = analyze_source(rel, path.read_text(), rules)
        except SyntaxError as e:
            errors.append(f"{rel}: {e}")
            continue
        for f in fs:
            (suppressed if f.suppressed else findings).append(f)
        for p in pragmas:
            if not p.reason:
                pragma_findings.append(Finding(
                    "A001", rel, p.line, PRAGMA_RULES["A001"],
                    "state WHY the violation is acceptable after the "
                    "closing bracket of allow[...]"))
            unknown = [r for r in p.rules
                       if r not in registry and r != "*"
                       and r not in PRAGMA_RULES]
            if unknown:
                pragma_findings.append(Finding(
                    "A002", rel, p.line,
                    f"{PRAGMA_RULES['A002']}: {', '.join(unknown)}",
                    "use an id from --list-rules"))
            if not p.used:
                pragma_findings.append(Finding(
                    "A003", rel, p.line,
                    f"{PRAGMA_RULES['A003']} "
                    f"(rules {', '.join(p.rules)} do not fire here)",
                    "delete the stale pragma"))
    return Report(sorted(findings, key=lambda f: (f.path, f.line, f.rule)),
                  sorted(suppressed, key=lambda f: (f.path, f.line, f.rule)),
                  pragma_findings, len(files), errors)


def render_json(report: Report, strict: bool,
                contracts: Optional[dict] = None) -> str:
    doc = report.to_json(strict)
    if contracts is not None:
        doc["contracts"] = contracts
        doc["ok"] = doc["ok"] and not contracts.get("failures")
    return json.dumps(doc, indent=2)
