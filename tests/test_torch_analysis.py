"""The port's analysis tier against the JAX package's: both engines give
the same findings on the JAX package's own fixtures at mapped paths, each
port rule fires exactly once on its minimal fixture and stays quiet on its
legal idiom, the shipped port is strict-clean, the contract checker's
meta shapes and dtypes equal ``jax.eval_shape`` of the JAX package's ops in
``ref`` mode, and the checker rejects a skewed op and holds every guard."""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis import analyze_source as ref_analyze_source
from repro.kernels import ops as jops
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import analyze_paths, analyze_source
from repro_torch.analysis.contracts import (
    Case, GuardCase, OpContract, _arg, _sig_tree, build_contracts, materialize,
    run_contracts,
)
from repro_torch.analysis.engine import all_rules
from repro_torch.kernels import ops
from repro_torch.kernels.ops import OP_TABLE, OpSpec
from test_analysis import RULE_FIXTURES

# ---------------------------------------------------------------------------
# engine parity: the JAX package's fixtures through both engines
# ---------------------------------------------------------------------------

# the JAX package's negative-space and pragma fixtures (tests/test_analysis.py)
REF_SNIPPETS = {
    "clock_default_legal": ("A301", "src/repro/serving/ok.py", """\
        import time

        def serve(clock=time.monotonic):
            return clock()
        """),
    "seeded_rng_legal": ("A302", "src/repro/core/ok.py", """\
        import numpy as np
        import random

        def jitter(seed):
            g = np.random.default_rng(seed)
            r = random.Random(seed)
            return g.random() + r.random()
        """),
    "hash_probe_legal": ("A601", "src/repro/serving/ok.py", """\
        def cache_key(key):
            try:
                hash(key)
            except TypeError:
                key = repr(key)
            return key
        """),
    "single_bump_legal": ("A201", "src/repro/core/ok.py", """\
        class Store:
            def bump_epoch(self):
                self.epoch += 1

            def merge(self, key, leaf):
                self.buffers[key] = leaf
                self._gc()
                self.bump_epoch()

            def _gc(self):
                self.buffers.pop("stale", None)
        """),
    "pragma_suppresses": ("A601", "src/repro/core/p.py", """\
        def plan_key(sig):
            return hash(sig)  # repro: allow[A601] in-process cache key only
        """),
    "standalone_pragma": ("A601", "src/repro/core/p.py", """\
        def plan_key(sig):
            # repro: allow[A601] in-process cache key only
            return hash(sig)
        """),
}
PARITY_CASES = {f"{r}_fixture": (r, *RULE_FIXTURES[r])
                for r in ("A201", "A202", "A301", "A302", "A601")}
PARITY_CASES.update(REF_SNIPPETS)


def _port_path(rel: str) -> str:
    assert rel.startswith("src/repro/")
    return "src/repro_torch/" + rel[len("src/repro/"):]


def _key(findings) -> list:
    return [(f.rule, f.line, f.message, f.suppressed, f.reason) for f in findings]


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_engines_agree_on_the_reference_fixtures(case):
    rule_id, rel, src = PARITY_CASES[case]
    src = textwrap.dedent(src)
    want, want_p = ref_analyze_source(rel, src, rules=[rule_id])
    got, got_p = analyze_source(_port_path(rel), src, rules=[rule_id])
    assert _key(got) == _key(want)
    assert [(p.line, p.applies_to, p.rules, p.reason, p.used) for p in got_p] == \
        [(p.line, p.applies_to, p.rules, p.reason, p.used) for p in want_p]
    if case.endswith("_fixture"):
        assert len(got) == 1 and not got[0].suppressed


def test_engines_agree_on_the_reference_strict_fixture(tmp_path):
    src = textwrap.dedent("""\
        def f(sig):
            x = hash(sig)  # repro: allow[A601]
            # repro: allow[A999] unknown rule
            y = 1
            return x + y  # repro: allow[A601] fires nowhere here
        """)
    for rel in ("src/repro/core/h.py", "src/repro_torch/core/h.py"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    want = ref_analyze_paths(root=tmp_path, paths=["src/repro"])
    got = analyze_paths(root=tmp_path, paths=["src/repro_torch"])
    for r in (want, got):
        assert r.ok(strict=False) and not r.ok(strict=True)
    assert [(f.rule, f.line, f.message) for f in got.pragma_findings] == \
        [(f.rule, f.line, f.message) for f in want.pragma_findings]
    assert sorted(f.rule for f in got.pragma_findings) == ["A001", "A002", "A003", "A003"]
    assert _key(got.suppressed) == _key(want.suppressed)


# ---------------------------------------------------------------------------
# each port rule: fires exactly once, quiet on the legal idiom
# ---------------------------------------------------------------------------

# case -> (rule, path, source, findings expected)
PORT_FIXTURES = {
    "A101_wrapper_import": ("A101", "src/repro_torch/serving/bad.py", """\
        import repro_torch.kernels.flash_attention as fa

        def f(q, k, v):
            return fa.flash_attention(q, k, v)
        """, 1),
    "A101_plain_version_import": ("A101", "src/repro_torch/models/bad.py", """\
        from repro_torch.kernels.ref import bank_matmul_ref

        def head(x, w):
            return bank_matmul_ref(x, w)
        """, 1),
    "A101_ops_legal": ("A101", "src/repro_torch/models/ok.py", """\
        from repro_torch.kernels import ops as kops

        def head(x, w):
            return kops.bank_matmul(x, w)
        """, 0),
    "A102_wrapper_imports_ref": ("A102", "src/repro_torch/kernels/newop.py", """\
        from repro_torch.kernels import ref

        def newop(x):
            return ref.newop_ref(x)
        """, 1),
    "A102_wrapper_legal": ("A102", "src/repro_torch/kernels/newop.py", """\
        from repro_torch.kernels import _build

        def newop(x):
            return _build.load_library().newop_launch(x.data_ptr())
        """, 0),
    "A102_mode_dispatcher": ("A102", "src/repro_torch/kernels/ops.py", """\
        def newop(x, mode=None):
            return x
        """, 1),
    "A102_dispatcher_legal": ("A102", "src/repro_torch/kernels/ops.py", """\
        def newop(x, scale=None):
            return x

        def _helper(mode):
            return mode
        """, 0),
    "A102_kernel_mode_env": ("A102", "src/repro_torch/serving/badenv.py", """\
        import os

        def mode():
            return os.environ.get("REPRO_KERNEL_MODE", "kernel")
        """, 1),
    "A102_other_env_legal": ("A102", "src/repro_torch/kernels/_build.py", """\
        import os

        def home():
            return os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        """, 0),
    "A103_blocked_attention": ("A103", "src/repro_torch/models/badattn.py", """\
        from repro_torch.models import layers as L

        def attend(q, k, v, positions):
            return L.blocked_causal_attention(q, k, v, positions, block_q=64)
        """, 1),
    "A103_kernel_op_legal": ("A103", "src/repro_torch/models/ok.py", """\
        from repro_torch.kernels import ops as kops

        def attend(q, k, v):
            return kops.flash_attention(q, k, v, causal=True)
        """, 0),
    "A201_no_bump": ("A201", "src/repro_torch/core/badstore.py", RULE_FIXTURES["A201"][1], 1),
    "A202_foreign_epoch_write": ("A202", "src/repro_torch/serving/badswap.py",
                                 RULE_FIXTURES["A202"][1], 1),
    "A301_wall_clock": ("A301", "src/repro_torch/runtime/badclock.py", RULE_FIXTURES["A301"][1],
                        1),
    "A302_numpy_global": ("A302", "src/repro_torch/core/badrng.py", RULE_FIXTURES["A302"][1], 1),
    "A302_torch_manual_seed": ("A302", "src/repro_torch/serving/badseed.py", """\
        import torch

        def reset(seed):
            torch.manual_seed(seed)
        """, 1),
    "A302_torch_sampler_global": ("A302", "src/repro_torch/core/badrand.py", """\
        import torch

        def jitter(n):
            return torch.randn(n) * 0.1
        """, 1),
    "A302_torch_generator_legal": ("A302", "src/repro_torch/core/ok.py", """\
        import torch

        def jitter(n, seed):
            g = torch.Generator().manual_seed(seed)
            return torch.randn(n, generator=g) + torch.randint(0, 4, (n,), generator=g)
        """, 0),
    "A401_dag_edge": ("A401", "src/repro_torch/core/badlayer.py", """\
        import repro_torch.models.vision as V

        def attach(store):
            return V.SmallCNNConfig
        """, 1),
    "A401_jax_import": ("A401", "src/repro_torch/bench/badjax.py", """\
        from jax import numpy as jnp

        def zeros(n):
            return jnp.zeros(n)
        """, 1),
    "A401_reference_import": ("A401", "src/repro_torch/utils/badref.py", """\
        import importlib

        def ops():
            return importlib.import_module("repro.kernels.ops")
        """, 1),
    "A401_dag_legal": ("A401", "src/repro_torch/serving/ok.py", """\
        from repro_torch.kernels import ops
        from repro_torch.core import ParamStore
        import repro_torch.utils.tree as tree
        """, 0),
    "A501_local_body": ("A501", "src/repro_torch/serving/badgraph.py", """\
        def decode(graphs, params, pool):
            def body(params, pool, toks):
                n = int(toks.sum())
                return params["w"] * n
            graphs.capture("step", body, (params, pool), ((1,),))
        """, 1),
    "A501_factory_body": ("A501", "src/repro_torch/serving/badlane.py", """\
        def lane(graphs, dec, params, cache):
            def make(step):
                def run(params, cache, toks):
                    logits = step(params, cache, toks)
                    return logits.argmax(-1).item()
                return run
            graphs.capture(("k", 1), make(dec), (params, cache), ((1, 1),))
        """, 1),
    "A501_static_reads_legal": ("A501", "src/repro_torch/serving/ok.py", """\
        def decode(graphs, params, pool, probe):
            def body(params, pool, toks):
                B = int(toks.shape[0])
                return params["w"][:B].to(pool.dtype) * toks.dim()
            n = probe.sum().item()  # outside any captured body
            graphs.capture("step", body, (params, pool), ((1,),))
            return n
        """, 0),
    "A601_builtin_hash": ("A601", "src/repro_torch/core/badid.py", RULE_FIXTURES["A601"][1], 1),
}


@pytest.mark.parametrize("case", sorted(PORT_FIXTURES))
def test_port_rule_fixture(case):
    rule_id, rel, src, n = PORT_FIXTURES[case]
    fs, _ = analyze_source(rel, textwrap.dedent(src), rules=[rule_id])
    assert len(fs) == n, [f.format() for f in fs]
    assert all(f.rule == rule_id and not f.suppressed and f.hint for f in fs)


def test_every_port_rule_has_a_firing_fixture():
    fired = {r for r, _, _, n in PORT_FIXTURES.values() if n}
    assert fired == set(all_rules())


def test_a103_pragma_with_reason_suppresses():
    fs, pragmas = analyze_source("src/repro_torch/models/x.py", textwrap.dedent("""\
        def attend(L, q, k, v, positions):
            # repro: allow[A103] explicit positions need the masked plain path
            return L.blocked_causal_attention(q, k, v, positions)
        """), rules=["A103"])
    assert len(fs) == 1 and fs[0].suppressed and pragmas[0].used
    assert fs[0].reason == "explicit positions need the masked plain path"


def test_shipped_port_is_strict_clean():
    """`python -m repro_torch.analysis --strict` exits 0: no finding, and
    the only suppressions are A103's justified plain-attention sites."""
    report = analyze_paths()
    assert report.ok(strict=True), [f.format() for f in report.gating(strict=True)]
    assert {f.rule for f in report.suppressed} <= {"A103"}, \
        [f.format() for f in report.suppressed]
    assert all(f.reason for f in report.suppressed)
    assert report.files_scanned > 100
    assert all(f.path.startswith("src/repro_torch/") for f in report.suppressed)


def test_cli_strict_with_contracts_exits_zero(capsys):
    assert cli.main(["--strict", "--contracts"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "0 failure(s)" in out and "on meta" in out


def test_analysis_imports_no_jax():
    """The analysis tier and the whole port import without JAX: a fresh
    interpreter with ``jax`` and ``repro`` made unimportable runs the rules
    and the meta contracts."""
    code = textwrap.dedent("""\
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.analysis import analyze_paths
        from repro_torch.analysis.contracts import run_contracts
        assert analyze_paths().ok(strict=True)
        assert run_contracts(device="meta")["ok"]
        assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
                       if sys.modules[m] is not None)
        """)
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert r.returncode == 0, r.stderr[-2000:]


# ---------------------------------------------------------------------------
# contracts: meta shapes against jax.eval_shape of the JAX package's ops
# ---------------------------------------------------------------------------

CONTRACT_CASES = [(op, i, dt) for op, c in sorted(build_contracts().items())
                  for i, case in enumerate(c.cases) for dt in case.dtypes]


def _jax_tree(x):
    if isinstance(x, (tuple, list)):
        return tuple(_jax_tree(e) for e in x)
    return (tuple(x.shape), jnp.dtype(x.dtype).name)


def _port_tree(x):
    if isinstance(x, (tuple, list)):
        return tuple(_port_tree(e) for e in x)
    return (tuple(x.shape), str(x.dtype).removeprefix("torch."))


@pytest.mark.parametrize("op,i,dtype", CONTRACT_CASES)
def test_contract_shapes_match_the_reference_ops(op, i, dtype):
    case = build_contracts()[op].cases[i]
    args = case.arrays(dtype)
    got = _port_tree(OP_TABLE[op].dispatch(
        **{k: materialize(a, "meta", None) for k, a in args.items()}, **case.static))
    sds = {k: jax.ShapeDtypeStruct(a.shape, jnp.dtype(a.dtype)) for k, a in args.items()}
    want = _jax_tree(jax.eval_shape(functools.partial(getattr(jops, op), mode="ref",
                                                      **case.static), **sds))
    assert got == want == _sig_tree(case.expect(dtype))


# ---------------------------------------------------------------------------
# the checker itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_contracts_hold_for_real_op_table(device):
    before = ops.kernel_launches()
    res = run_contracts(device=device)
    assert res["ok"], res["failures"]
    assert set(res["ops"]) == set(OP_TABLE) and res["device"] == device
    assert all(r["cases"] > 0 and r["guards"] > 0 and r["launches"] == 0
               for r in res["ops"].values())
    assert ops.kernel_launches() == before  # no kernel off the card


def test_contract_cases_cover_every_op():
    assert set(build_contracts()) == set(OP_TABLE)


GUARDS = [(op, i) for op, c in sorted(build_contracts().items()) for i in range(len(c.guards))]


@pytest.mark.parametrize("op,i", GUARDS)
def test_every_guard_raises_through_check_args(op, i):
    guard = build_contracts()[op].guards[i]
    kwargs = {k: materialize(a, "meta", None) for k, a in guard.arrays().items()}
    with pytest.raises((TypeError, ValueError)):
        OP_TABLE[op].check(**kwargs, **guard.static)
    # the same inputs with the guard's fault undone are taken
    case = build_contracts()[op].cases[0]
    OP_TABLE[op].check(**{k: materialize(a, "meta", None)
                          for k, a in case.arrays("float32").items()}, **case.static)


@pytest.mark.parametrize("op", ["rg_lru_scan", "mamba_scan"])
def test_scans_take_a_bf16_h0_and_A(op):
    """A bf16 ``h0`` (and mamba's ``A``) is widened on load, as the JAX
    package's kernels do; the checks take it."""
    args = build_contracts()[op].cases[0].arrays("float32")
    args = {k: materialize(a, "meta", None) for k, a in args.items()}
    args["h0"] = args["h0"].to(torch.bfloat16)
    if op == "mamba_scan":
        args["A"] = args["A"].to(torch.bfloat16)
    OP_TABLE[op].check(**args)
    with pytest.raises(TypeError):
        OP_TABLE[op].check(**{**args, "h0": args["h0"].to(torch.float16)})


def _fake_table(kernel, ref, dispatch=None, check=None):
    dispatch = dispatch or (lambda x: ref(x))
    return {"fake_op": OpSpec("fake_op", kernel, ref, dispatch, ("x",),
                              check=check or (lambda x: None))}


def test_contracts_reject_shape_skewed_op():
    def ref(x):  # the plain version disagrees with the contract: one column wider
        return torch.zeros((x.shape[0], 5), dtype=x.dtype, device=x.device)

    cases = {"fake_op": OpContract(cases=(
        Case("skew", lambda dt: dict(x=_arg((2, 3), dt)), lambda dt: _arg((2, 4), dt)),
    ))}
    res = run_contracts(table=_fake_table(lambda x: x, ref), cases=cases)
    assert not res["ok"]
    assert any("fake_op:skew" in f and "(2, 5)" in f for f in res["failures"])


def test_contracts_reject_signature_skewed_op():
    def kernel(y, mode=None):  # wrong array name, and a mode knob
        return y

    res = run_contracts(table=_fake_table(kernel, lambda x: x),
                        cases={"fake_op": OpContract(cases=())})
    assert any("kernel positional args ['y']" in f for f in res["failures"])
    assert any("takes a `mode` argument" in f for f in res["failures"])


def test_contracts_reject_missing_guard():
    cases = {"fake_op": OpContract(
        cases=(),
        guards=(GuardCase("must_reject", lambda: dict(x=_arg((2, 3), "float32"))),),
    )}
    res = run_contracts(table=_fake_table(lambda x: x, lambda x: x), cases=cases)
    assert any("must_reject" in f and "expected" in f for f in res["failures"])


def test_contracts_flag_op_without_cases():
    res = run_contracts(table=_fake_table(lambda x: x, lambda x: x), cases={})
    assert any("without contract cases" in f for f in res["failures"])


def test_contracts_hold_values_on_a_device_with_data():
    """On a device with data the dispatcher's outputs are held against the
    plain version's: a dispatcher that computes something else fails."""
    cases = {"fake_op": OpContract(cases=(
        Case("values", lambda dt: dict(x=_arg((2, 3), dt)), lambda dt: _arg((2, 3), dt)),
    ))}
    res = run_contracts(table=_fake_table(lambda x: x, lambda x: x * 2.0,
                                          dispatch=lambda x: x * 3.0),
                        cases=cases, device="cpu")
    assert any("not within tolerance" in f for f in res["failures"])
    assert run_contracts(table=_fake_table(lambda x: x, lambda x: x * 2.0,
                                           dispatch=lambda x: x * 2.0),
                         cases=cases, device="cpu")["ok"]
