"""Kernel-contract verification over ``kernels.ops.OP_TABLE``.

The counterpart of ``repro.analysis.contracts``.  ``meta`` tensors take the
place of ``jax.eval_shape``: a meta tensor has a shape and a dtype and no
data, and ``kernels.ops`` sends it to the plain version, so on ``meta`` the
whole dispatch surface is checked on any host in milliseconds.  On
``cuda`` the same cases run through the Hopper kernels.  Four checks:

* **completeness** — every op in the table has contract cases and vice
  versa; the table's entries really are the module's public dispatchers.
* **signature congruence** — kernel wrapper, plain version, dispatcher and
  the wrapper's ``check_args`` take the declared array arguments
  positionally, in order; neither dispatcher nor wrapper takes a ``mode``
  or ``interpret`` argument (the port dispatches on the tensor's device).
* **shape/dtype congruence** — for each case, in float32 and bf16, the
  plain version and the dispatcher give the output tree the contract
  promises: the scans and the suffix-bank GEMM surface float32 even from
  bf16 inputs, attention returns the query dtype, page_gather the pool
  dtype.  On ``cuda`` each output is also held against the plain version
  on the same inputs (``TOL``, the kernel checks' tolerances; page_gather
  exactly), and each op's launch counter must move.
* **guards** — inputs a kernel does not take must raise before any launch:
  on ``meta`` through the wrapper's device-agnostic ``check_args``, on
  ``cuda`` through the full dispatch, with the launch counter unmoved.

The JAX package's block-size guards (``block_q``, ``block_k``,
``block_d``, ``chunk``, ``block_m`` not dividing their axis) have no
counterpart: the port's kernels take no block argument and any S.  The
port's own guards replace them: head dims the attention kernels do not
compile, more query heads per kv head than decode's ``MAX_GROUP``, a state
dim mamba_scan does not compile, int64 lengths or page tables, a
non-contiguous input and mixed float32/bf16 inputs; the bank's contraction
mismatch carries over.  The cases' shapes are the JAX package's, moved to
ones the kernels compile (head dim 8 -> 16, state dim 4 -> 8).

``run_contracts`` takes the table, cases and device as arguments so the
unit tests can feed it a deliberately skewed fake op and watch it fail.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

import torch

# the kernel checks' tolerances (the JAX package's kernel-test ones):
# float32 results differ only in summation order, bf16 ones also in where
# the final rounding lands
TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DEVICES = ("meta", "cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class Arg:
    """One array argument: shape, dtype (a numpy name) and, for a device
    with data, how its values are drawn (``fill``): ``normal``,
    ``positive`` (softplus of a normal, a step size), ``unit`` (sigmoid of
    a normal, a decay), ``negative`` (-exp of a normal, mamba's A) or
    ``index`` (integers in [0, ``high``)).  ``transposed`` lays the last
    two axes out swapped in memory, a non-contiguous view."""

    shape: tuple
    dtype: str
    fill: str = "normal"
    high: int = 0
    transposed: bool = False


def _arg(shape, dtype, fill="normal", high=0, transposed=False) -> Arg:
    return Arg(tuple(shape), dtype, fill, high, transposed)


def materialize(arg: Arg, device: str, gen: Optional[torch.Generator]) -> torch.Tensor:
    """The tensor ``arg`` describes, on ``device`` (no data on ``meta``)."""
    dtype = getattr(torch, arg.dtype)
    shape = arg.shape
    if arg.transposed:
        shape = (*shape[:-2], shape[-1], shape[-2])
    if device == "meta":
        t = torch.empty(shape, dtype=dtype, device="meta")
    elif arg.fill == "index":
        t = torch.randint(0, arg.high, shape, generator=gen, device=device).to(dtype)
    else:
        x = torch.randn(shape, generator=gen, device=device)
        if arg.fill == "positive":
            x = torch.nn.functional.softplus(x)
        elif arg.fill == "unit":
            x = torch.sigmoid(x)
        elif arg.fill == "negative":
            x = -torch.exp(0.5 * x)
        t = x.to(dtype)
    return t.transpose(-1, -2) if arg.transposed else t


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _sig_tree(x):
    """A comparable (shape, dtype-name) tree of tensors, or of Args."""
    if isinstance(x, (tuple, list)):
        return tuple(_sig_tree(e) for e in x)
    if isinstance(x, Arg):
        return (x.shape, x.dtype)
    return (tuple(x.shape), _dtype_name(x.dtype))


def _leaves(x) -> list:
    return [e for l in x for e in _leaves(l)] if isinstance(x, (tuple, list)) else [x]


@dataclasses.dataclass(frozen=True)
class Case:
    """One point of an op's contract grid.  ``arrays(dtype)`` gives the
    name -> Arg call kwargs; ``expect(dtype)`` the output tree (Args) the
    contract promises; ``static`` rides along as plain kwargs."""

    label: str
    arrays: Callable
    expect: Callable
    static: dict = dataclasses.field(default_factory=dict)
    dtypes: tuple = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class GuardCase:
    """Inputs the kernel must REJECT (raise before any launch) rather than
    miscompute.  ``arrays()`` gives the name -> Arg call kwargs."""

    label: str
    arrays: Callable
    static: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class OpContract:
    """An op's cases and guards, and how its outputs are held against the
    plain version on a device with data: ``"dtype"`` (``TOL`` of the input
    dtype), ``"float32"`` (``TOL["float32"]`` for either input dtype: the
    scans widen every input first) or ``"exact"``."""

    cases: tuple
    guards: tuple = ()
    tol: str = "dtype"


def build_contracts() -> dict:
    """The contract grid for every op in kernels/ops.py."""

    def flash(B, S, Hq, Hkv, D, kv_dtype=None, transposed=False):
        return lambda dt="float32": dict(q=_arg((B, S, Hq, D), dt),
                                         k=_arg((B, S, Hkv, D), kv_dtype or dt,
                                                transposed=transposed),
                                         v=_arg((B, S, Hkv, D), kv_dtype or dt))

    def decode(B, Smax, Hq, Hkv, D, lengths="int32"):
        return lambda dt="float32": dict(
            q=_arg((B, Hq, D), dt), k_cache=_arg((B, Smax, Hkv, D), dt),
            v_cache=_arg((B, Smax, Hkv, D), dt),
            lengths=_arg((B,), lengths, "index", high=Smax + 1))

    def rg_lru(B, S, d, b_dtype=None, transposed=False):
        return lambda dt="float32": dict(
            a=_arg((B, S, d), dt, "unit", transposed=transposed),
            b=_arg((B, S, d), b_dtype or dt), h0=_arg((B, d), dt))

    def mamba(B, S, di, n, transposed=False):
        return lambda dt="float32": dict(
            dt=_arg((B, S, di), dt, "positive", transposed=transposed),
            dtx=_arg((B, S, di), dt), Bmat=_arg((B, S, n), dt), Cmat=_arg((B, S, n), dt),
            A=_arg((di, n), dt, "negative"), h0=_arg((B, di, n), dt))

    def gather(P, W, N, table="int32"):
        return lambda dt="float32": dict(pool=_arg((P, W), dt),
                                         page_table=_arg((N,), table, "index", high=P))

    def bank(N, M, K, F, banked=True, bias=True, x_dtype=None, Kx=None):
        def arrays(dt="float32"):
            x = (N, M, Kx or K) if banked else (M, Kx or K)
            out = dict(x=_arg(x, x_dtype or dt), w=_arg((N, K, F), dt))
            if bias:
                out["b"] = _arg((N, F), dt)
            return out
        return arrays

    f32 = "float32"
    return {
        "flash_attention": OpContract(
            cases=(
                Case("gqa_causal", flash(2, 16, 4, 2, 16),
                     lambda dt: _arg((2, 16, 4, 16), dt)),
                Case("mha_windowed", flash(1, 32, 2, 2, 16),
                     lambda dt: _arg((1, 32, 2, 16), dt),
                     static=dict(causal=True, window=8)),
            ),
            guards=(
                GuardCase("head_dim_8_not_compiled", flash(2, 16, 4, 2, 8)),
                GuardCase("head_dim_48_not_compiled",
                          functools.partial(flash(2, 16, 4, 2, 48), "bfloat16")),
                GuardCase("mixed_f32_bf16", flash(2, 16, 4, 2, 16, kv_dtype="bfloat16")),
                GuardCase("non_contiguous_k", flash(2, 16, 4, 2, 16, transposed=True)),
            ),
        ),
        "decode_attention": OpContract(
            cases=(
                Case("gqa_cache", decode(2, 32, 4, 2, 16),
                     lambda dt: _arg((2, 4, 16), dt)),
                Case("mha_cache", decode(3, 64, 2, 2, 16),
                     lambda dt: _arg((3, 2, 16), dt)),
            ),
            guards=(
                GuardCase("head_dim_8_not_compiled", decode(2, 32, 4, 2, 8)),
                GuardCase("group_over_max_group", decode(1, 16, 32, 1, 16)),
                GuardCase("int64_lengths", decode(2, 32, 4, 2, 16, lengths="int64")),
            ),
        ),
        "rg_lru_scan": OpContract(
            cases=(
                # float32 accumulation is part of the contract: the carry
                # surfaces at float32 whatever the input dtype (a bf16 h0
                # is widened on load)
                Case("diag_recurrence", rg_lru(2, 8, 16),
                     lambda dt: (_arg((2, 8, 16), f32), _arg((2, 16), f32))),
            ),
            guards=(
                GuardCase("mixed_f32_bf16", rg_lru(2, 8, 16, b_dtype="bfloat16")),
                GuardCase("non_contiguous_a", rg_lru(2, 16, 16, transposed=True)),
            ),
            tol="float32",
        ),
        "mamba_scan": OpContract(
            cases=(
                Case("selective_scan", mamba(2, 8, 16, 8),
                     lambda dt: (_arg((2, 8, 16), f32), _arg((2, 16, 8), f32))),
            ),
            guards=(
                GuardCase("state_dim_4_not_compiled", mamba(2, 8, 16, 4)),
                GuardCase("non_contiguous_dt", mamba(2, 16, 16, 8, transposed=True)),
            ),
            tol="float32",
        ),
        "page_gather": OpContract(
            cases=(
                Case("paged_assembly", gather(8, 32, 4),
                     lambda dt: _arg((4, 32), dt)),
            ),
            guards=(
                GuardCase("int64_page_table", gather(8, 32, 4, table="int64")),
            ),
            tol="exact",
        ),
        "bank_matmul": OpContract(
            cases=(
                Case("banked_with_bias", bank(3, 16, 8, 16),
                     lambda dt: _arg((3, 16, 16), f32)),
                Case("broadcast_no_bias", bank(3, 16, 8, 16, banked=False, bias=False),
                     lambda dt: _arg((3, 16, 16), f32)),
            ),
            guards=(
                GuardCase("contraction_mismatch", bank(3, 16, 8, 16, bias=False, Kx=9)),
                GuardCase("mixed_f32_bf16", bank(3, 16, 8, 16, x_dtype="bfloat16")),
            ),
        ),
    }


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _positional_names(fn):
    sig = inspect.signature(fn)
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _check_signatures(spec, fail):
    arrays = list(spec.array_args) + list(spec.optional_args)
    if spec.check is None:
        fail(f"{spec.name}: no check_args (the guards have nothing to run "
             "through before a launch)")
    for role, fn in (("kernel", spec.kernel), ("ref", spec.ref),
                     ("dispatch", spec.dispatch), ("check", spec.check)):
        if fn is None:
            continue
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            fail(f"{spec.name}: {role} has no inspectable signature")
            continue
        pos = _positional_names(fn)
        if pos[:len(arrays)] != arrays:
            fail(f"{spec.name}: {role} positional args {pos[:len(arrays)]} "
                 f"!= declared array args {arrays}")
        if role in ("kernel", "dispatch"):
            for knob in ("mode", "interpret"):
                if knob in sig.parameters:
                    fail(f"{spec.name}: {role} takes a `{knob}` argument — "
                         "the tensor's device picks the kernel")


def case_ref_statics(spec, case) -> dict:
    """The subset of a case's statics the plain version understands."""
    params = inspect.signature(spec.ref).parameters
    return {k: v for k, v in case.static.items() if k in params}


def _hold(got, want, tol: str, dtype: str) -> Optional[str]:
    """None when every leaf of ``got`` matches ``want`` (the plain
    version's), else what differs."""
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        if tol == "exact":
            if not torch.equal(g, w):
                return f"output {i} differs from the plain version (exact)"
            continue
        try:
            torch.testing.assert_close(g.float(), w.float(),
                                       **TOL["float32" if tol == "float32" else dtype])
        except AssertionError as e:
            return f"output {i} not within tolerance of the plain version: {e}"
    return None


def _launches(spec) -> int:
    return getattr(spec.kernel, "launches", 0)


def _check_case(spec, contract, case, device, gen, fail) -> int:
    """Run one case in each dtype; returns the kernel launches it made."""
    launched = 0
    for dtype in case.dtypes:
        kwargs = {k: materialize(a, device, gen) for k, a in case.arrays(dtype).items()}
        want = _sig_tree(case.expect(dtype))
        where = f"{spec.name}:{case.label}:{dtype}"
        outs = {}
        for label, fn in (("ref", functools.partial(spec.ref, **case_ref_statics(spec, case))),
                          ("dispatch", functools.partial(spec.dispatch, **case.static))):
            before = _launches(spec)
            try:
                with torch.no_grad():
                    outs[label] = fn(**kwargs)
                if device == "cuda":
                    torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 — report, don't crash the gate
                fail(f"{where}:{label}: raised {type(e).__name__}: {e}")
                continue
            moved = _launches(spec) - before
            launched += moved
            got = _sig_tree(outs[label])
            if got != want:
                fail(f"{where}:{label}: output {got} != contract {want}")
            if label == "dispatch" and device == "cuda" and moved != 1:
                fail(f"{where}:dispatch: {moved} kernel launches (one expected)")
            if label == "dispatch" and device != "cuda" and moved:
                fail(f"{where}:dispatch: launched a kernel on {device}")
        if device != "meta" and len(outs) == 2:
            msg = _hold(outs["dispatch"], outs["ref"], contract.tol, dtype)
            if msg:
                fail(f"{where}: {msg}")
    return launched


def _check_guard(spec, guard, device, gen, fail) -> None:
    """The guard must raise: through ``check_args`` on a device without a
    kernel, through the full dispatch on ``cuda``, before any launch."""
    kwargs = {k: materialize(a, device, gen) for k, a in guard.arrays().items()}
    fn = spec.dispatch if device == "cuda" else spec.check
    if fn is None:
        fail(f"{spec.name}:guard:{guard.label}: no check_args to run it through")
        return
    before = _launches(spec)
    try:
        with torch.no_grad():
            fn(**kwargs, **guard.static)
    except Exception:  # the guard fired — the contract holds if nothing launched
        if _launches(spec) != before:
            fail(f"{spec.name}:guard:{guard.label}: raised, but after a kernel launch")
        return
    fail(f"{spec.name}:guard:{guard.label}: expected the kernel to reject "
         f"these inputs, but the call succeeded on {device}")


def run_contracts(table: Optional[dict] = None,
                  cases: Optional[dict] = None,
                  device: str = "meta") -> dict:
    """Verify every op contract on ``device`` (``meta``, ``cpu`` or
    ``cuda``); returns a JSON-able report dict with a ``failures`` list
    (empty == all contracts hold) and each op's kernel launches."""
    from repro_torch.kernels import ops

    if device not in DEVICES:
        raise ValueError(f"run_contracts: device {device!r} not in {DEVICES}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_contracts: device 'cuda' asked for and no card is present")
    bound_table = table is None
    table = ops.OP_TABLE if table is None else table
    cases = build_contracts() if cases is None else cases
    gen = None if device == "meta" else torch.Generator(device=device).manual_seed(0)

    failures: list = []
    checks = 0
    per_op: dict = {}

    def fail(msg):
        failures.append(msg)

    missing = sorted(set(table) - set(cases))
    extra = sorted(set(cases) - set(table))
    if missing:
        fail(f"ops without contract cases: {', '.join(missing)}")
    if extra:
        fail(f"contract cases without a table entry: {', '.join(extra)}")

    for name, spec in sorted(table.items()):
        before = len(failures)
        if spec.name != name:
            fail(f"{name}: table key != OpSpec.name {spec.name!r}")
        if bound_table and getattr(ops, name, None) is not spec.dispatch:
            fail(f"{name}: OP_TABLE dispatch is not the module's "
                 "public entry point")
        _check_signatures(spec, fail)
        contract = cases.get(name)
        n_cases = n_guards = launched = 0
        if contract is not None:
            for case in contract.cases:
                launched += _check_case(spec, contract, case, device, gen, fail)
                n_cases += 1
                checks += len(case.dtypes) * 2
            for guard in contract.guards:
                _check_guard(spec, guard, device, gen, fail)
                n_guards += 1
                checks += 1
            if device == "cuda" and contract.cases and not launched:
                fail(f"{name}: no kernel launch on cuda")
        per_op[name] = {"cases": n_cases, "guards": n_guards, "launches": launched,
                        "ok": len(failures) == before}
    return {"device": device, "ops": per_op, "checks": checks,
            "failures": failures, "ok": not failures}
