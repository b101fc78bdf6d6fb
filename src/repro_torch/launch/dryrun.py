"""Dry run: count every (arch x shape x mesh) cell on ``meta`` tensors (the
port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

A cell runs its family's own entry point eagerly on ``meta`` tensors (no
values, no memory, no card): ``train`` builds the train state
(``train.trainer.init_state``, ``AdamW``) and runs one step of
``make_train_step`` with backward; ``prefill`` and ``decode`` run the
family's ``prefill`` and ``decode_step``.  A ``TorchDispatchMode`` over
the call counts:

* **flops**: ``torch.utils.flop_counter``'s formulas for the aten GEMMs
  and convolutions (elementwise work is not counted);
* **bytes**: each aten op's tensor inputs read once and outputs written
  once.  Views move nothing.  A gather (``index``, ``index_select``,
  ``embedding``, ``gather``) reads its index and the rows it gathers, not
  its whole source; a partial write (``index_copy_``, ``index_put_``)
  reads and writes the rows it writes, not its whole destination; ``copy_``
  and ``fill_`` do not read their destination;
* **peak live bytes**: per storage (views share one), the arguments live
  from the start, each storage from the op that made it to its release;
* **dispatch counts**: per aten op and per kernel op.

A call of a ``kernels.ops`` op is one unit (:func:`kernels.ops.observed`):
it counts the op's cost function -- the work of the Hopper kernel that
runs it on the card -- and neither the aten ops of its plain version nor
their intermediates (at 32,768 tokens the plain attention's S x S scores
would swamp the cell), on ``meta`` and on CPU tensors alike.  On ``meta``
the call returns its outputs' shapes without running the plain version
(the scans' plain versions loop over S in Python).  Under autograd (a
train cell) the call's backward counts twice its cost function, the
usual backward-to-forward ratio: the kernels have no backward, and
tracing the scans' plain backward step by step at full size takes hours.
Code that takes the card's route for half-precision operands on
``cuda`` (``layers.unembed``, the moe expert GEMMs) takes it on ``meta``
too, so a meta trace counts what the card runs.

Per device: ``argument_bytes`` is exact, from the shard shapes the cell's
mesh and rules give each argument (``param_shardings``,
``state_shardings``, the batch and cache shardings below).  Flops, bytes,
``output_bytes`` (outputs that are not arguments updated in place) and
``temp_bytes`` (the rest of the peak) are the whole trace's split evenly
over the mesh's devices: one controller runs the cell, and the split is
the model, not a measurement.  ``peak_bytes_estimate`` = argument +
output + temp bytes.  One controller makes no collectives:
``collective_bytes`` and ``collective_counts`` stay empty and
``collective_wire_bytes`` is ``null``.

Cells write ``artifacts/torch/dryrun/<arch>__<shape>__<mesh>.json``
(``--out``); ``--all`` runs every cell in this process, records a failed
cell (``ok: false`` with its traceback) and exits 1 if any failed.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ShapeSpec, cache_specs, input_specs
from repro_torch.configs.registry import all_arch_ids, load_arch
from repro_torch.distributed.partitioning import _map_with_path, param_shardings
from repro_torch.distributed.sharding import Mesh, NamedSharding, P, use_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh, production_rules
from repro_torch.models.registry import get_family
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import init_state, make_train_step, state_shardings

DEFAULT_OUT = "artifacts/torch/dryrun"

aten = torch.ops.aten
# ops that read their index and the rows they gather
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}
# in-place ops that write part of their first argument from a source
_PARTIAL_WRITES = {aten.index_copy_: 3, aten.index_put_: 2}  # the source's position
# in-place ops that do not read their first argument
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# ops that mark a tensor made from Python data (on the CPU only): not counted
_MARKERS = {aten.lift_fresh}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages ``tree``'s tensors lie in."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class CostCounter(TorchDispatchMode):
    """Flops, bytes, peak live bytes and dispatch counts of what runs
    under it (see the module docstring), with ``kernels.ops`` calls
    counted by their cost functions."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.aten_counts: collections.Counter = collections.Counter()
        self.bytes_by_op: collections.Counter = collections.Counter()
        self.op_calls: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._refs: dict = {}  # id(storage) -> (weakref, bytes)
        self._inside = 0

    # -- storages ---------------------------------------------------------

    def track(self, tree) -> None:
        """Count every storage of ``tree`` not yet tracked as allocated now."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs:
                continue
            size = st.nbytes()
            self._refs[key] = (weakref.ref(st, lambda _, k=key: self._release(k)), size)
            self.live += size
            self.peak = max(self.peak, self.live)

    def _release(self, key) -> None:
        _, size = self._refs.pop(key, (None, 0))
        self.live -= size

    # -- aten ops -----------------------------------------------------------

    def _op_bytes(self, func, args, kwargs, out) -> int:
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.is_view:
            return 0
        in_storages = {id(t.untyped_storage()) for t in ins}
        mutable = func._schema.is_mutable
        if outs and not mutable and all(id(t.untyped_storage()) in in_storages for t in outs):
            return 0  # an alias (``_unsafe_view``, ``alias``): nothing moves
        packet = func.overloadpacket
        if packet in _GATHERS:
            index = [t for t in ins if not t.is_floating_point()]
            return sum(map(_nbytes, index)) + 2 * sum(map(_nbytes, outs))
        if packet in _PARTIAL_WRITES:
            src = args[_PARTIAL_WRITES[packet]]
            others = [t for t in ins if t is not args[0] and t is not src]
            return sum(map(_nbytes, others)) + 2 * _nbytes(src)
        if packet in _WRITE_ONLY:
            return sum(_nbytes(t) for t in ins if t is not args[0]) + sum(map(_nbytes, outs))
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside or func.overloadpacket in _MARKERS:
            return out
        self.aten_counts[str(func.overloadpacket)] += 1
        flop_fn = flop_registry.get(func.overloadpacket)
        if flop_fn is not None:
            # the ``.dtype`` overloads (a GEMM with a float32 output) carry
            # the output dtype as an argument the formulas do not take
            shapes = [a for a in args if not isinstance(a, torch.dtype)]
            self.flops += float(flop_fn(*shapes, **kwargs, out_val=out))
        moved = self._op_bytes(func, args, kwargs, out)
        self.bytes += moved
        self.bytes_by_op[str(func.overloadpacket)] += moved
        self.track(out)
        return out

    # -- kernels.ops calls ------------------------------------------------------

    def add_cost(self, name: str, cost, times: float = 1.0) -> None:
        self.flops += times * cost.flops
        self.bytes += times * cost.bytes
        self.bytes_by_op[name] += times * cost.bytes

    def observe(self, name, body, args, kwargs):
        """One ``kernels.ops`` call: its cost function counted, its body
        (the plain version on the CPU; shapes only on ``meta``) not."""
        ts = _tensors((args, kwargs))
        meta = any(t.device.type == "meta" for t in ts)
        self._inside += 1
        try:
            cost = ops.OP_TABLE[name].cost(*args, **kwargs)
            run = _Call(self, name, body, kwargs, meta, cost)
            if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
                out = _Recorded.apply(run, *args)
            else:
                out = run.forward(args)
        finally:
            self._inside -= 1
        self.op_calls[name] += 1
        self.add_cost(name, cost)
        self.track(out)
        return out

    def __enter__(self):
        self._observing = ops.observed(self.observe)
        self._observing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observing.__exit__(*exc)


@dataclasses.dataclass
class _Call:
    counter: CostCounter
    name: str
    body: object
    kwargs: dict
    meta: bool
    cost: object

    def forward(self, args):
        if self.meta:
            return ops.META_OUTPUTS[self.name](*args, **self.kwargs)
        with torch.no_grad():
            out = self.body(*args, **self.kwargs)
        # a kernel's outputs are contiguous, as meta's are; the plain
        # version's einsums may hand back other strides
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    def backward(self, specs, needs) -> tuple:
        c = self.counter
        c._inside += 1
        try:
            grads = tuple(torch.zeros(s[0], dtype=s[1], device=s[2]) if need and s else None
                          for s, need in zip(specs, needs))
        finally:
            c._inside -= 1
        c.add_cost(self.name, self.cost, times=2.0)
        c.track(grads)
        return grads


class _Recorded(torch.autograd.Function):
    """An ops call under autograd: the forward as :meth:`_Call.forward`,
    a backward of zero gradients counted at twice the call's cost."""

    @staticmethod
    def forward(ctx, run, *args):
        ctx.run = run
        ctx.specs = [(a.shape, a.dtype, a.device) if isinstance(a, torch.Tensor) else None
                     for a in args]
        return run.forward(args)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ctx.run.backward(ctx.specs, ctx.needs_input_grad[1:])


@dataclasses.dataclass
class Trace:
    flops: float
    bytes: float
    peak_live_bytes: int
    argument_bytes: int  # distinct storages of the arguments
    output_bytes: int  # distinct storages of the outputs that are not arguments
    aten_counts: dict
    op_calls: dict
    bytes_by_op: dict  # aten op or kernel op -> bytes
    out: object


def trace(fn, *args) -> Trace:
    """Run ``fn(*args)`` under a :class:`CostCounter`; the arguments are
    live from the start."""
    counter = CostCounter()
    arg_bytes = _storage_bytes(args)
    arg_storages = {id(t.untyped_storage()) for t in _tensors(args)}
    with counter:
        counter.track(args)
        out = fn(*args)
    fresh = [t for t in _tensors(out) if id(t.untyped_storage()) not in arg_storages]
    return Trace(counter.flops, counter.bytes, counter.peak, arg_bytes, _storage_bytes(fresh),
                 dict(counter.aten_counts), dict(counter.op_calls), dict(counter.bytes_by_op),
                 out)


# ---------------------------------------------------------------------------
# shardings of a cell's arguments
# ---------------------------------------------------------------------------


def _extent(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    names = axes if isinstance(axes, tuple) else (axes,)
    return math.prod(mesh.shape[a] for a in names)


def _batch_sharding(rules, spec) -> NamedSharding:
    """Shard dim 0 (global batch) over the batch axes when divisible."""
    mesh = rules.mesh
    batch_axes = rules.rules["batch"]
    ndim = spec.dim()
    if ndim >= 1 and spec.shape[0] % _extent(mesh, batch_axes) == 0:
        return NamedSharding(mesh, P(batch_axes, *([None] * (ndim - 1))))
    return NamedSharding(mesh, P(*([None] * ndim)))


def _cache_shardings(cfg, family, shape, rules, cache_tree):
    """Shardings for the decode cache: batch dim over batch axes, the
    kv-head / inner dim over 'model' when divisible."""
    mesh = rules.mesh
    batch_axes = rules.rules["batch"]
    model_axis = "model"
    B = shape.global_batch
    kv_seq_shard = rules.rules.get("kv_seq") is not None
    S = shape.seq_len

    def one(path, spec):
        dims = list(spec.shape)
        axes = [None] * len(dims)
        for i, d in enumerate(dims):
            if d == B and B % _extent(mesh, batch_axes) == 0 and batch_axes not in axes:
                axes[i] = batch_axes
                break
        if kv_seq_shard:
            # match the in-model constraint: seq dim over 'model'
            for i, d in enumerate(dims):
                if axes[i] is None and d == S and d % mesh.shape[model_axis] == 0:
                    axes[i] = model_axis
                    return NamedSharding(mesh, P(*axes))
        # shard the largest model-divisible trailing dim over 'model'
        for i in range(len(dims) - 1, 0, -1):
            if (axes[i] is None and dims[i] % mesh.shape[model_axis] == 0
                    and dims[i] >= mesh.shape[model_axis] and dims[i] > 1):
                axes[i] = model_axis
                break
        return NamedSharding(mesh, P(*axes))

    return _map_with_path(one, cache_tree)


def shard_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """Bytes of one device's shard of ``t`` under ``sharding``."""
    spec = tuple(sharding.spec) + (None,) * (t.dim() - len(sharding.spec))
    n = 1
    for dim, axes in zip(t.shape, spec):
        e = _extent(sharding.mesh, axes)
        if dim % e:
            raise ValueError(f"dim {dim} does not divide over {axes} ({e})")
        n *= dim // e
    return n * t.element_size()


def tree_shard_bytes(tree, shardings) -> int:
    """Per-device bytes of a tree of tensors under a parallel tree of
    shardings (ints and other leaves hold no device bytes)."""
    if isinstance(tree, torch.Tensor):
        return shard_bytes(tree, shardings)
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(v, shardings[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(tree_shard_bytes(v, s) for v, s in zip(tree, shardings))
    return 0


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    kind: str
    ok: bool
    seconds: float
    error: str = ""
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes_estimate: int = 0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_wire_bytes: Optional[int] = None  # one controller: no collectives
    microbatches: int = 1
    n_devices: int = 0
    # the whole trace's (not per device)
    flops_total: float = 0.0
    bytes_total: float = 0.0
    peak_live_bytes: int = 0
    aten_counts: dict = dataclasses.field(default_factory=dict)
    op_calls: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)


BIG_ARCHS = ("qwen2-72b", "qwen3-14b", "falcon-mamba-7b", "recurrentgemma-9b",
             "deepseek-moe-16b")


def microbatches_for(arch_mod, shape, mesh, tensor_parallel: bool = True) -> int:
    """Grad-accumulation depth: keep the per-chip microbatch at 1 sequence
    for >=7B models, 4 otherwise (activation-memory bound).  With TP off
    the 'model' axis folds into data parallelism, so the batch spreads
    over the whole mesh."""
    if shape.kind != "train":
        return 1
    data_total = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            data_total *= mesh.shape[a]
    if not tensor_parallel:
        data_total *= mesh.shape.get("model", 1)
    per_chip = 1 if arch_mod.ARCH_ID in BIG_ARCHS else 4
    return max(1, shape.global_batch // (data_total * per_chip))


def cell_call(fam, family: str, cfg, shape: ShapeSpec):
    """(fn, input names): the family's prefill or decode step as the cell
    runs it, its arguments the params and then the named inputs (decode:
    the params, the cache, the tokens)."""
    S = shape.seq_len
    if shape.kind == "prefill":
        if family == "encdec":
            return (lambda p, src_embeds, tokens:
                    fam.prefill(cfg, p, src_embeds, tokens, tokens.shape[1])), \
                ("src_embeds", "tokens")
        if family == "vlm":
            return (lambda p, patch_embeds, tokens:
                    fam.prefill(cfg, p, tokens, patch_embeds, S)), ("patch_embeds", "tokens")
        if family == "ssm":
            return (lambda p, tokens: fam.prefill(cfg, p, tokens)), ("tokens",)
        return (lambda p, tokens: fam.prefill(cfg, p, tokens, S)), ("tokens",)
    return (lambda p, c, tokens: fam.decode_step(cfg, p, c, tokens)), ("cache", "tokens")


def materialize(spec: torch.Tensor, device, seq_len: int = 0) -> torch.Tensor:
    """A tensor of ``spec``'s shape and dtype on ``device``: zeros (valid
    token ids), and for a 0-d int32 cache length ``seq_len - 1`` (a decode
    at the cell's context, the count a meta trace assumes)."""
    if spec.dim() == 0 and spec.dtype == torch.int32:
        return torch.full((), max(seq_len - 1, 0), dtype=torch.int32, device=device)
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def _on(tree, device, seq_len: int):
    if isinstance(tree, dict):
        return {k: _on(v, device, seq_len) for k, v in tree.items()}
    return materialize(tree, device, seq_len) if device != "meta" else tree


def run_cell(arch: str, shape_name: str, mesh_kind: str, seq_shard: bool = False,
             compress_grads: bool = False, *, cfg=None, shape: Optional[ShapeSpec] = None,
             mesh: Optional[Mesh] = None, device: str = "meta") -> CellResult:
    """Trace one cell.  ``cfg``, ``shape`` and ``mesh`` replace the arch's
    full config, its ``SHAPES[shape_name]`` and the production mesh
    (tests); ``device="cpu"`` runs the same trace on CPU tensors."""
    t0 = time.monotonic()
    mod = load_arch(arch)
    if shape_name in mod.SKIP:
        return CellResult(arch, shape_name, mesh_kind, "skip", True,
                          time.monotonic() - t0, error=mod.SKIP[shape_name])
    cfg = mod.full_config() if cfg is None else cfg
    fam = get_family(mod.FAMILY)
    shape = mod.SHAPES[shape_name] if shape is None else shape
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="meta")
    # KV layout policy: if the stored KV heads can't fill the TP axis, shard
    # the cache's sequence dim over "model" instead (context parallelism)
    kv_seq_shard = False
    if shape.kind in ("prefill", "decode") and hasattr(cfg, "kv_stored_heads"):
        kv_seq_shard = cfg.kv_stored_heads % mesh.shape["model"] != 0
    # TP only pays for itself on wide models; small-d archs train pure
    # FSDP.  Folding the model axis into DP needs the global batch to
    # divide the whole mesh
    tp = (getattr(cfg, "d_model", 0) >= 4096 or shape.kind != "train"
          or shape.global_batch % mesh.size != 0)
    rules = production_rules(mesh, seq_shard=seq_shard, kv_seq_shard=kv_seq_shard,
                             tensor_parallel=tp)
    params = fam.init(cfg, 0, device=device)
    inputs = {k: _on(s, device, 0) for k, s in input_specs(cfg, mod.FAMILY, shape).items()}
    in_bytes = sum(shard_bytes(v, _batch_sharding(rules, v)) for v in inputs.values())
    mb = microbatches_for(mod, shape, mesh, tensor_parallel=tp)
    with use_rules(rules):
        if shape.kind == "train":
            opt = AdamW(lr=1e-4)
            state = init_state(params, opt, compress_grads)
            arg_bytes = tree_shard_bytes(state, state_shardings(state, rules)) + in_bytes
            step = make_train_step(lambda p, b: fam.loss(cfg, p, b), opt, microbatches=mb,
                                   compress_grads=compress_grads)
            tr = trace(step, state, inputs)
        else:
            fn, names = cell_call(fam, mod.FAMILY, cfg, shape)
            arg_bytes = tree_shard_bytes(params, param_shardings(params, rules)) + in_bytes
            if shape.kind == "decode":
                cache = _on(cache_specs(cfg, mod.FAMILY, shape), device, shape.seq_len)
                arg_bytes += tree_shard_bytes(
                    cache, _cache_shardings(cfg, mod.FAMILY, shape, rules, cache))
                inputs = dict(inputs, cache=cache)
            tr = trace(fn, params, *[inputs[k] for k in names])
    n = mesh.size
    temp_total = max(0, tr.peak_live_bytes - tr.argument_bytes - tr.output_bytes)
    out_dev, temp_dev = tr.output_bytes // n, temp_total // n
    return CellResult(
        arch, shape_name, mesh_kind, shape.kind, True, time.monotonic() - t0,
        flops_per_device=tr.flops / n, bytes_per_device=tr.bytes / n,
        argument_bytes=arg_bytes, output_bytes=out_dev, temp_bytes=temp_dev,
        peak_bytes_estimate=arg_bytes + out_dev + temp_dev,
        microbatches=mb, n_devices=n, flops_total=tr.flops, bytes_total=tr.bytes,
        peak_live_bytes=tr.peak_live_bytes, aten_counts=tr.aten_counts, op_calls=tr.op_calls,
        bytes_by_op=tr.bytes_by_op)


def cells() -> list:
    """Every (arch, shape, mesh) cell, in ``--all``'s order."""
    return [(arch, shape_name, mesh_kind) for arch in all_arch_ids()
            for shape_name in load_arch(arch).SHAPES for mesh_kind in ("single", "multi")]


def cell_path(out: str, arch: str, shape_name: str, mesh_kind: str, tag: str = "") -> str:
    return os.path.join(out, f"{tag + '-' if tag else ''}{arch}__{shape_name}__{mesh_kind}.json")


def run_and_write(arch: str, shape_name: str, mesh_kind: str, out: str, tag: str = "",
                  seq_shard: bool = False, compress_grads: bool = False) -> dict:
    """Run one cell, write its JSON and print its line; a failure is
    recorded (``ok: false``, the traceback), not raised."""
    try:
        res = dataclasses.asdict(run_cell(arch, shape_name, mesh_kind, seq_shard=seq_shard,
                                          compress_grads=compress_grads))
    except Exception as e:  # noqa: BLE001 — recorded in the cell, and the exit code
        res = dataclasses.asdict(CellResult(arch, shape_name, mesh_kind, "?", False, 0.0,
                                            error=f"{e}\n{traceback.format_exc()}"))
    os.makedirs(out, exist_ok=True)
    with open(cell_path(out, arch, shape_name, mesh_kind, tag), "w") as f:
        json.dump(res, f, indent=2)
    status = "SKIP" if res["kind"] == "skip" else ("OK" if res["ok"] else "FAIL")
    print(f"[{status}] {arch} {shape_name} {mesh_kind} ({res['seconds']:.1f}s) "
          f"flops/dev={res['flops_per_device']:.3e} "
          f"bytes/dev={res['bytes_per_device']:.3e} "
          f"peak={res['peak_bytes_estimate'] / 1e9:.2f}GB", flush=True)
    if not res["ok"]:
        print(res["error"])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape x mesh) cell, in this process")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    knobs = dict(out=args.out, tag=args.tag, seq_shard=args.seq_shard,
                 compress_grads=args.compress_grads)

    if args.all:
        failures = []
        for arch, shape_name, mesh_kind in cells():
            fname = cell_path(args.out, arch, shape_name, mesh_kind, args.tag)
            if os.path.exists(fname) and not args.force:
                print(f"[skip exists] {fname}")
                continue
            if not run_and_write(arch, shape_name, mesh_kind, **knobs)["ok"]:
                failures.append((arch, shape_name, mesh_kind))
        print(f"done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape (or --all)")
    if not run_and_write(args.arch, args.shape, args.mesh, **knobs)["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
