"""Logical-axis sharding (MaxText-style rules) over a port-owned device mesh
(the port of ``repro.distributed.sharding``).

One controller drives the mesh, as in the JAX package, where one process
drives a ``shard_map`` over a ``Mesh``: the engine, the scheduler and the
store exist once.  A :class:`Mesh` names its axes, their extents, and one
``torch.device`` per mesh position (row-major).  Entries may repeat: on one
card a (2, 4) mesh is eight entries of ``cuda:0``, on the CPU eight of
``cpu``; on a host with several cards the same code takes ``cuda:0..3``.
``torch.distributed`` is not used: the JAX package's serve tier is one
controller, NCCL refuses two ranks on one card, and SPMD ranks would each
need a copy of the engine and a CUDA context.

The launcher installs a :class:`LogicalRules` mapping logical names to mesh
axes with :func:`use_rules`.  Rules used by the production mesh:

    batch    -> ("pod", "data")     # DP across pods + within pod
    fsdp     -> "data"              # parameter sharding (ZeRO-3 style)
    tensor   -> "model"             # TP: heads / d_ff / vocab / experts
    seq      -> "model"             # context parallelism (qwen3, long ctx)
    expert   -> "model"             # EP for MoE
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence, Union

import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, unflatten_paths

Axis = Union[str, None, Sequence[str]]

_state = threading.local()


class PartitionSpec(tuple):
    """Mesh axes per tensor dim (``None``: that dim is not split), the
    counterpart of ``jax.sharding.PartitionSpec``: a dim over several axes
    is a tuple of them, over one axis that axis's name."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, (list, tuple)):
                return a[0] if len(a) == 1 else tuple(a)
            return a

        return super().__new__(cls, (norm(a) for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index: ``cuda`` names the current
    card, so two spellings of one device compare equal."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of given extents over one device per position, row-major
    (the last axis varies fastest)."""

    axis_names: tuple
    axis_sizes: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{math.prod(self.axis_sizes)} positions")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """The device of position (0, ..., 0): where the controller computes
        what is not split."""
        return self.devices[0]

    @property
    def distinct_devices(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))

    def device_at(self, **coords) -> torch.device:
        """The device at the position ``coords`` (axes left out are 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            c = coords.get(name, 0)
            if not 0 <= c < size:
                raise IndexError(f"{name}={c} outside extent {size}")
            flat = flat * size + c
        return self.devices[flat]

    def devices_along(self, axis: str) -> tuple:
        """Devices of the positions whose other coordinates are 0, in order
        along ``axis``."""
        return tuple(self.device_at(**{axis: s}) for s in range(self.shape[axis]))


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None) -> Mesh:
    """A mesh of ``shape`` named ``axes``.  ``devices`` is one device
    repeated at every position (default ``cuda``) or one per position."""
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = (_device(resolve_device(devices)),) * n
    else:
        devs = tuple(_device(resolve_device(d)) for d in devices)
    return Mesh(tuple(axes), tuple(int(s) for s in shape), devs)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def replicated(self) -> bool:
        return all(a is None for a in self.spec)


class LogicalRules:
    def __init__(self, mesh: Mesh, rules: dict):
        self.mesh = mesh
        self.rules = dict(rules)

    def resolve(self, logical_axes: Sequence[Axis]) -> PartitionSpec:
        mesh_axes = []
        used: set = set()
        for ax in logical_axes:
            resolved = self.rules.get(ax) if isinstance(ax, str) else ax
            # a mesh axis is used at most once per spec; divisibility is the
            # caller's (param_specs drops axes that do not divide)
            if isinstance(resolved, (list, tuple)):
                resolved = tuple(a for a in resolved if a not in used)
                used.update(resolved)
                mesh_axes.append(resolved if resolved else None)
            else:
                if resolved in used:
                    resolved = None
                if resolved is not None:
                    used.add(resolved)
                mesh_axes.append(resolved)
        return P(*mesh_axes)

    def sharding(self, logical_axes: Sequence[Axis]) -> NamedSharding:
        return NamedSharding(self.mesh, self.resolve(logical_axes))


def use_rules(rules: Optional[LogicalRules]):
    @contextlib.contextmanager
    def ctx():
        prev = getattr(_state, "rules", None)
        _state.rules = rules
        try:
            yield rules
        finally:
            _state.rules = prev

    return ctx()


def current_rules() -> Optional[LogicalRules]:
    return getattr(_state, "rules", None)


def _axis_extent(mesh: Mesh, axes) -> int:
    names = axes if isinstance(axes, (list, tuple)) else (axes,)
    return math.prod(mesh.shape[n] for n in names)


def logical_to_spec(rules: Optional[LogicalRules], logical_axes: Sequence[Axis]) -> PartitionSpec:
    if rules is None:
        return P()
    return rules.resolve(logical_axes)


class BankShards:
    """A bank leaf split on its leading (member) axis: ``shards[s]`` holds
    members ``s * N/n .. (s+1) * N/n - 1`` on the device of mesh position
    (0, ..., s along the bank axis, ..., 0).  Not a tuple, so tree walks
    (``flatten_paths``) keep it one leaf."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = tuple(shards)

    def __len__(self) -> int:
        return len(self.shards)

    def __getitem__(self, s: int) -> torch.Tensor:
        return self.shards[s]

    @property
    def shape(self) -> tuple:
        first = self.shards[0].shape
        return (sum(t.shape[0] for t in self.shards), *first[1:])



def _tree_to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return unflatten_paths({p: v.to(device) for p, v in flatten_paths(tree).items()})


def shard_bank_fn(fn, mesh: Mesh, axis: str):
    """Wrap a bank fan-out callable ``(bank_params, feats) -> (N, ...)`` to
    run shard-locally over the leading bank axis, the counterpart of the
    JAX package's ``shard_map``: for each position ``s`` along ``axis`` the
    wrapper copies the replicated ``feats`` to that position's device,
    calls ``fn`` on the bank's slice ``s`` (a :class:`BankShards` leaf's
    own slice, or the ``s``-th of ``n`` equal slices of a plain tensor),
    copies the output back to the mesh's primary device, and concatenates
    the outputs in shard order.  ``fn`` runs at the LOCAL member count
    N / n, so ``ops.bank_matmul`` launches once per shard at that count.
    The bank axis is batch-like (no contraction is split), so the result
    is the unsharded dispatch's wherever ``fn``'s kernels give a member the
    same bits at any member count.  Copies to the device a tensor is on are
    no-ops, so on one card nothing moves.

    Caller guarantees N divides the axis extent (the divisibility guard in
    ``MeshPlacement.bank_sharding``)."""
    devices = mesh.devices_along(axis)
    home = mesh.primary
    n = len(devices)

    def local(leaf, s: int, device: torch.device) -> torch.Tensor:
        if isinstance(leaf, BankShards):
            return leaf[s].to(device)
        if leaf.shape[0] % n:
            raise ValueError(f"bank of {leaf.shape[0]} members over {n} shards")
        m = leaf.shape[0] // n
        return leaf[s * m:(s + 1) * m].to(device)

    def sharded(bank_params, feats):
        flat = flatten_paths(bank_params)
        outs = [fn(unflatten_paths({p: local(v, s, dev) for p, v in flat.items()}),
                   _tree_to(feats, dev)).to(home)
                for s, dev in enumerate(devices)]
        return torch.cat(outs)

    return sharded
