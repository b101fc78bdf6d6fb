"""Parameter partitioning: leaf path + shape -> logical axes -> PartitionSpec
(the port of ``repro.distributed.partitioning``).

The LM zoo stores parameters as nested dicts; this module classifies each
leaf by its path tail (MaxText-style naming conventions) and assigns logical
axes, which :class:`repro_torch.distributed.sharding.LogicalRules` resolves
against the mesh.  Production rules:

    embed_fsdp -> "data"     (ZeRO-3 parameter sharding)
    tensor     -> "model"    (TP: heads / d_ff / vocab)
    expert     -> "model"    (EP for MoE expert leaves)
    vocab      -> "model"
    layers     -> None       (the stacked-scan layer axis is never sharded)

Divisibility guard: an axis that does not divide its mesh extent is dropped
(replicated) rather than erroring.

Placing a tensor (:func:`put`) puts it on the mesh's primary device, the
one the controller computes on, and a replicated tensor also on every other
distinct device of the mesh (:func:`replicas`), so it is held once per
distinct device: on a mesh of one card repeated, once.  A spec that splits
a dim over several distinct devices raises: the port's forwards read whole
weights, and the serve tier replicates every weight (only the bank splits,
:meth:`MeshPlacement.place_bank`).
"""
from __future__ import annotations

import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    BankShards, LogicalRules, Mesh, NamedSharding, P, _axis_extent,
)
from repro_torch.utils.tree import map_tree

# (path-suffix pattern, logical axes for the *trailing* dims). Leading dims
# not covered by the pattern (e.g. the stacked-layer axis, expert axis in a
# 4D expert leaf) are handled separately.
_RULES: list = [
    # embeddings / unembeddings
    ("embed/table", ("vocab", "embed_fsdp")),
    ("lm_head/w", ("embed_fsdp", "vocab")),
    # attention projections
    ("attn/wq", ("embed_fsdp", "tensor")),
    ("attn/wk", ("embed_fsdp", "tensor")),
    ("attn/wv", ("embed_fsdp", "tensor")),
    ("attn/wo", ("tensor", "embed_fsdp")),
    ("self_attn/wq", ("embed_fsdp", "tensor")),
    ("self_attn/wk", ("embed_fsdp", "tensor")),
    ("self_attn/wv", ("embed_fsdp", "tensor")),
    ("self_attn/wo", ("tensor", "embed_fsdp")),
    ("cross_attn/wq", ("embed_fsdp", "tensor")),
    ("cross_attn/wk", ("embed_fsdp", "tensor")),
    ("cross_attn/wv", ("embed_fsdp", "tensor")),
    ("cross_attn/wo", ("tensor", "embed_fsdp")),
    # FFN
    ("mlp/w_gate", ("embed_fsdp", "tensor")),
    ("mlp/w_up", ("embed_fsdp", "tensor")),
    ("mlp/w_down", ("tensor", "embed_fsdp")),
    ("shared/w_gate", ("embed_fsdp", "tensor")),
    ("shared/w_up", ("embed_fsdp", "tensor")),
    ("shared/w_down", ("tensor", "embed_fsdp")),
    # MoE experts: (E, d, f)/(E, f, d) — expert axis sharded, others follow
    ("experts/w_gate", ("expert", "embed_fsdp", None)),
    ("experts/w_up", ("expert", "embed_fsdp", None)),
    ("experts/w_down", ("expert", None, "embed_fsdp")),
    ("router/w", ("embed_fsdp", None)),
    # Mamba mixer
    ("mixer/in_proj/w", ("embed_fsdp", "tensor")),
    ("mixer/out_proj/w", ("tensor", "embed_fsdp")),
    ("mixer/x_proj/w", ("tensor", None)),
    ("mixer/dt_proj/w", (None, "tensor")),
    ("mixer/conv/w", (None, "tensor")),
    ("mixer/conv/b", ("tensor",)),
    ("mixer/A_log", ("tensor", None)),
    ("mixer/D", ("tensor",)),
    # Griffin recurrent block
    ("rec/in_x/w", ("embed_fsdp", "tensor")),
    ("rec/in_gate/w", ("embed_fsdp", "tensor")),
    ("rec/out_proj/w", ("tensor", "embed_fsdp")),
    ("rec/conv/w", (None, "tensor")),
    ("rec/conv/b", ("tensor",)),
    ("rec/rglru/w_a", ("tensor", None, None)),  # block-diagonal: (nb, bw, bw)
    ("rec/rglru/w_x", ("tensor", None, None)),
    ("rec/rglru/b_a", ("tensor",)),
    ("rec/rglru/b_x", ("tensor",)),
    ("rec/rglru/lam", ("tensor",)),
]


def leaf_logical_axes(path: str, shape: Sequence[int]) -> tuple:
    """Logical axes for one param leaf.  Leading stacked dims (scan layers,
    pattern repeats) are padded with the unsharded 'layers' axis."""
    ndim = len(shape)
    for suffix, axes in _RULES:
        head, tail = suffix.split("/")[0], suffix.split("/")[-1]
        if path.endswith(suffix) or (f"/{head}/" in path and path.endswith("/" + tail)
                                     and head in path):
            if len(axes) <= ndim:
                # leading dims = stacked layers/repeats: unsharded
                return ("layers",) * (ndim - len(axes)) + tuple(axes)
    # default: replicate small leaves; FSDP-shard any large trailing matrix
    if ndim >= 2 and int(np.prod(shape)) >= 1 << 20:
        return ("layers",) * (ndim - 2) + ("embed_fsdp", None)
    return (None,) * ndim


def _divisible(mesh: Mesh, axes, dim: int) -> bool:
    if axes is None:
        return True
    return dim % _axis_extent(mesh, axes) == 0


def _guarded(rules: LogicalRules, path: str, shape: tuple) -> P:
    """``path``'s spec under ``rules`` with every mesh axis that does not
    divide its dim dropped."""
    spec = rules.resolve(leaf_logical_axes(path, shape))
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*(axes if _divisible(rules.mesh, axes, dim) else None
               for dim, axes in zip(shape, padded)))


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict / list / tuple tree, its
    structure kept exactly (empty subtrees and ``None`` survive)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def param_specs(params, rules: Optional[LogicalRules]):
    """PartitionSpec tree for a param tree (``meta`` tensors fine too).
    Mesh axes that don't divide the dim are dropped (replicated).  Structure
    is preserved exactly (empty subtrees like non-parametric LN survive)."""
    def one(path, leaf):
        if rules is None:
            return P()
        return _guarded(rules, path, tuple(getattr(leaf, "shape", ())))

    return _map_with_path(one, params)


def param_shardings(params, rules: LogicalRules):
    """:func:`param_specs` on ``rules``' mesh as a tree of NamedShardings."""
    def one(path, leaf):
        return NamedSharding(rules.mesh, _guarded(rules, path, tuple(getattr(leaf, "shape", ()))))

    return _map_with_path(one, params)


_REPLICAS: dict = {}  # id(primary tensor) -> its copies on the other devices


def replicas(t: torch.Tensor) -> tuple:
    """The copies :func:`put` holds of ``t`` on the mesh's other distinct
    devices (empty on a mesh of one device)."""
    return _REPLICAS.get(id(t), ())


def put(sharding: NamedSharding, x) -> torch.Tensor:
    """Place one tensor (or host array) under ``sharding``: the tensor on
    the mesh's primary device (the same object when it is there already),
    and for a replicated spec a copy on every other distinct device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    mesh = sharding.mesh
    out = t.to(mesh.primary)
    others = mesh.distinct_devices[1:]
    if others:
        if not sharding.replicated:
            raise NotImplementedError(
                f"spec {sharding.spec} splits a dim over {len(others) + 1} devices; the "
                "port's forwards read whole weights")
        _REPLICAS[id(out)] = tuple(out.to(d) for d in others)
        weakref.finalize(out, _REPLICAS.pop, id(out), None)
    return out


def place_tree(tree, shardings):
    """:func:`put` every tensor or host-array leaf of ``tree`` under the
    sharding at its position in ``shardings`` (a tree mirroring ``tree``);
    other leaves (a step counter, binding strings) pass through."""
    return map_tree(lambda x, s: put(s, x) if isinstance(x, (torch.Tensor, np.ndarray)) else x,
                    tree, shardings)


class MeshPlacement:
    """Placement policy for ParamStore buffers on a device mesh (DESIGN.md S3).

    Individual store buffers are placed by their binding *path* through the
    same suffix rules as :func:`param_specs` (under the serve tier's empty
    rules every buffer replicates), while suffix-bank materialisations
    split their leading *bank* axis over ``bank_axis`` — a batch-like axis,
    so no contraction is ever split.  ``n_shards`` (the ``bank_axis``
    extent) is also the store's shard count for per-shard epochs and
    residency accounting.  Injected into
    :class:`repro_torch.core.store.ParamStore` by the caller."""

    def __init__(self, rules: LogicalRules, bank_axis: str = "model"):
        if bank_axis not in rules.mesh.shape:
            raise ValueError(f"mesh has no axis {bank_axis!r}: {rules.mesh.axis_names}")
        self.rules = rules
        self.bank_axis = bank_axis

    @property
    def mesh(self) -> Mesh:
        return self.rules.mesh

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.bank_axis])

    def leaf_sharding(self, path: Optional[str], shape) -> NamedSharding:
        """Sharding for one buffer addressed by its binding path (the same
        suffix rules as :func:`param_specs`, divisibility-guarded).  A buffer
        with no known path replicates under the default rule."""
        return NamedSharding(self.mesh, _guarded(self.rules, path or "", tuple(shape)))

    def place(self, arr, path: Optional[str] = None) -> torch.Tensor:
        """:func:`put` one buffer under its path-derived sharding."""
        return put(self.leaf_sharding(path, tuple(getattr(arr, "shape", ()))), arr)

    def bank_sharding(self, n_bank: int) -> NamedSharding:
        """Leading-axis sharding for a stacked suffix bank: the bank axis is
        batch-like (one slice per member), so splitting it over
        ``bank_axis`` keeps every contraction shard-local.  Non-dividing
        banks replicate — the divisibility guard."""
        if n_bank % self.n_shards == 0 and self.n_shards > 1:
            return NamedSharding(self.mesh, P(self.bank_axis))
        return NamedSharding(self.mesh, P())

    def place_bank(self, arr: torch.Tensor):
        """A split bank as :class:`BankShards` (slice ``s`` on the device of
        position ``s`` along the bank axis; a view where that is the
        tensor's own device), a replicated one through :func:`put`."""
        sharding = self.bank_sharding(int(arr.shape[0]))
        if sharding.replicated:
            return put(sharding, arr)
        m = arr.shape[0] // self.n_shards
        return BankShards([arr[s * m:(s + 1) * m].to(d)
                           for s, d in enumerate(self.mesh.devices_along(self.bank_axis))])
