"""Shared benchmark utilities: result table printing + artifact dump."""
from __future__ import annotations

import json
import os
from typing import Optional

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "torch")


def emit(name: str, rows: list, derived: Optional[dict] = None) -> dict:
    """Print a compact CSV block and write ``artifacts/torch/<name>.json``."""
    os.makedirs(ARTIFACTS, exist_ok=True)
    out = {"name": name, "rows": rows, "derived": derived or {}}
    with open(os.path.join(ARTIFACTS, f"{name}.json"), "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"\n== {name} ==")
    if rows:
        cols = list(rows[0].keys())
        print(",".join(cols))
        for r in rows:
            print(",".join(_fmt(r[c]) for c in cols))
    for k, v in (derived or {}).items():
        print(f"# {k}: {_fmt(v)}")
    return out


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def check_gates(name: str, gates: dict) -> None:
    """Raise ``SystemExit`` naming every acceptance gate that failed
    (``gates``: {description: bool})."""
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"{name} acceptance criteria not met: {failed}")
