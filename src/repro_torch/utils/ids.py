"""Process-stable identifiers (a copy of ``repro.utils.ids``).

Builtin ``hash()`` is randomized per interpreter run (PYTHONHASHSEED), so
any id, key, filename or seed derived from it silently changes across
restarts.  Everything that outlives the process derives from blake2b, and
the port must produce the same ids as the JAX package.
"""
from __future__ import annotations

import hashlib


def stable_hash(value, digest_size: int = 8) -> str:
    """Hex digest of ``repr(value)``, identical across processes and
    platforms.  ``value`` must have a deterministic repr (strings, ints,
    tuples of those — not objects with default reprs)."""
    return hashlib.blake2b(repr(value).encode(),
                           digest_size=digest_size).hexdigest()


def stable_seed(value, bits: int = 31) -> int:
    """A non-negative int seed derived from ``value``, stable across runs."""
    return int(stable_hash(value), 16) % (1 << bits)
