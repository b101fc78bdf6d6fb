"""The port's dry run and roofline against the JAX package's: meta tensors
through the kernel ops, the ops' cost functions against the kernel checks'
bound inputs, the cell enumeration, ``microbatches_for`` and the
parameter counts, a meta trace against the same trace on CPU tensors at
each family's tiny config, per-device argument bytes on a (2, 4) mesh,
and the roofline's ``analyse`` and collective lane.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so everything that needs it runs in a subprocess."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import ShapeSpec, input_specs
from repro_torch.configs.registry import all_arch_ids, load_arch
from repro_torch.distributed.partitioning import param_shardings
from repro_torch.distributed.sharding import make_mesh
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import production_rules
from repro_torch.models.registry import get_family
from repro_torch.utils.tree import flatten_paths
from test_torch_kernels import BANK_ROUTES

HBM, BF16 = 3.35e12, 989e12  # chip_smoke.py's rates: bound = max(bytes/HBM, ops/peak)


def _small(shape):  # the CPU twin of a route-grid shape: the same residues mod 8
    return tuple(n if n <= 256 else 256 + n % 8 for n in shape)


def _pair(shape, dtype, device, low=None):
    if low is not None:
        return torch.randint(0, low, shape, dtype=dtype, device="cpu").to(device)
    return torch.zeros(shape, dtype=dtype, device=device) if device == "meta" else \
        torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(dtype)


def _op_cases():
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    cases = []
    for case, xs, ws, dtype, _ in BANK_ROUTES:
        dt = getattr(torch, dtype)
        cases.append((f"bank-{case}", "bank_matmul",
                      [(_small(xs), dt, None), (_small(ws), dt, None)], {}))
    for D_ in (16, 64, 128, 256):
        for dt in (bf16, f32):
            for Hq in (1, 16):
                cases.append((f"flash-D{D_}-{dt}-Hq{Hq}", "flash_attention",
                              [((2, 24, Hq, D_), dt, None)] * 3, dict(causal=True)))
    cases.append(("flash-window", "flash_attention", [((2, 40, 8, 16), bf16, None),
                                                       ((2, 40, 2, 16), bf16, None),
                                                       ((2, 40, 2, 16), bf16, None)],
                  dict(window=8)))
    for dt in (bf16, f32):
        cases.append((f"decode-{dt}", "decode_attention",
                      [((4, 8, 16), dt, None), ((4, 40, 2, 16), dt, None),
                       ((4, 40, 2, 16), dt, None), ((4,), i32, 41)], {}))
        cases.append((f"gather-{dt}", "page_gather", [((30, 64), dt, None), ((17,), i32, 30)],
                      {}))
        for S in (1, 2, 13):
            cases.append((f"mamba-S{S}-{dt}", "mamba_scan",
                          [((3, S, 24), dt, None), ((3, S, 24), dt, None), ((3, S, 8), dt, None),
                           ((3, S, 8), dt, None), ((24, 8), f32, None), ((3, 24, 8), f32, None)],
                          {}))
            cases.append((f"rg_lru-S{S}-{dt}", "rg_lru_scan",
                          [((3, S, 24), dt, None), ((3, S, 24), dt, None), ((3, 24), f32, None)],
                          {}))
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("case,name,specs,kw", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_meta_takes_the_plain_version_with_the_cpu_calls_shapes(case, name, specs, kw):
    fn = ops.OP_TABLE[name].dispatch
    ops.reset_dispatch_counts()
    ops.reset_kernel_launches()
    outs = {dev: fn(*[_pair(s, dt, dev, low) for s, dt, low in specs], **kw)
            for dev in ("cpu", "meta")}
    got, want = outs["meta"], outs["cpu"]
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(t.shape, t.dtype, "meta") for t in want]
    assert ops.dispatch_counts() == {name: 2}
    assert not any(ops.kernel_launches().values())  # no kernel wrapper was reached


def test_a_meta_call_never_reaches_a_kernel_wrapper(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran for a meta tensor")

    for mod, name in [(ops._flash_mod, "flash_attention"), (ops._decode_mod, "decode_attention"),
                      (ops._gather_mod, "page_gather"), (ops._bank_mod, "bank_matmul"),
                      (ops._rg_lru_mod, "rg_lru_scan"), (ops._mamba_mod, "mamba_scan")]:
        monkeypatch.setattr(mod, name, refuse)
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    ops.reset_kernel_launches()
    ops.flash_attention(m(1, 8, 2, 16), m(1, 8, 2, 16), m(1, 8, 2, 16))
    ops.decode_attention(m(1, 2, 16), m(1, 8, 2, 16), m(1, 8, 2, 16), m(1, dt=torch.int32))
    ops.page_gather(m(4, 8), m(2, dt=torch.int32))
    ops.bank_matmul(m(2, 3, 8), m(2, 8, 8))
    ops.rg_lru_scan(m(1, 2, 8), m(1, 2, 8), m(1, 8, dt=torch.float32))
    ops.mamba_scan(m(1, 2, 8), m(1, 2, 8), m(1, 2, 4), m(1, 2, 4), m(8, 4), m(1, 8, 4))
    assert ops.kernel_launches() == dict.fromkeys(ops.OP_TABLE, 0)


# ---------------------------------------------------------------------------
# cost functions: the kernel checks' bound inputs at the main-path shapes
# ---------------------------------------------------------------------------


def _meta(*shape, dt=torch.bfloat16):
    return torch.empty(shape, dtype=dt, device="meta")


def _ms(c, peak=BF16):
    return max(c.bytes / HBM, c.flops / peak) * 1e3


def test_cost_functions_equal_the_kernel_checks_bound_inputs():
    # bank_matmul, stablelm head: 1.277 ms (operations)
    c = ops.bank_matmul_cost(_meta(3, 1024, 2048), _meta(3, 2048, 100352))
    assert c.flops == 2 * 3 * 1024 * 2048 * 100352
    assert c.bytes == 3 * 1024 * 2048 * 2 + 3 * 2048 * 100352 * 2 + 3 * 1024 * 100352 * 4
    assert round(_ms(c), 3) == 1.277
    # with a bias: N M F more operations, the bias read
    cb = ops.bank_matmul_cost(_meta(8, 16, dt=torch.float32), _meta(2, 16, 64, dt=torch.float32),
                              _meta(2, 64, dt=torch.float32))
    assert cb.flops == 2 * 2 * 8 * 16 * 64 + 2 * 8 * 64
    assert cb.bytes == 4 * (8 * 16 + 2 * 16 * 64 + 2 * 64 + 2 * 8 * 64)
    # flash_attention (8,128,32,64) bf16 causal: 0.00501 ms (bytes)
    q = _meta(8, 128, 32, 64)
    c = ops.flash_attention_cost(q, q, q, causal=True)
    assert c.flops == 4 * 64 * (128 * 129 // 2) * 8 * 32
    assert c.bytes == 4 * 8 * 128 * 32 * 64 * 2
    assert round(_ms(c), 5) == 0.00501
    assert ops.attention_pairs(256, True, 32) == sum(min(i + 1, 32) for i in range(256))
    assert ops.attention_pairs(5, False, None) == 25
    # page_gather: pool (128, 32768) bf16, 64 ids: 0.00250 ms (bytes)
    c = ops.page_gather_cost(_meta(128, 32768), _meta(64, dt=torch.int32))
    assert (c.flops, c.bytes) == (0.0, 64 * 4 + 2 * 64 * 32768 * 2)
    assert round(_ms(c), 5) == 0.00250
    # decode_attention, 8 rows over Smax 128 with 624 keys: 0.00155 ms (bytes)
    lens = torch.tensor([128, 1, 77, 64, 96, 17, 128, 113], dtype=torch.int32)
    kv = _meta(8, 128, 32, 64)
    c = ops.decode_attention_cost(_meta(8, 32, 64), kv, kv, lens)
    assert c.flops == 4 * 64 * 624 * 32
    assert c.bytes == 2 * 8 * 32 * 64 * 2 + 8 * 4 + 2 * 624 * 32 * 64 * 2
    assert round(_ms(c), 5) == 0.00155
    # lengths on meta hold no values: the whole cache
    c = ops.decode_attention_cost(_meta(8, 32, 64), kv, kv, _meta(8, dt=torch.int32))
    assert c.flops == 4 * 64 * 8 * 128 * 32
    # mamba_scan (8,128,8192) x 16 f32: 0.0328 ms (bytes), one exp per element
    f = torch.float32
    c = ops.mamba_scan_cost(_meta(8, 128, 8192, dt=f), _meta(8, 128, 8192, dt=f),
                            _meta(8, 128, 16, dt=f), _meta(8, 128, 16, dt=f),
                            _meta(8192, 16, dt=f), _meta(8, 8192, 16, dt=f))
    work = 8 * 128 * 8192 * 16
    assert (c.flops, c.exps) == (6 * work, work)
    assert c.bytes == 4 * (2 * 8 * 128 * 8192 + 2 * 8 * 128 * 16 + 8192 * 16 + 8 * 8192 * 16
                           + 8 * 128 * 8192 + 8 * 8192 * 16)
    assert round(_ms(c, 67e12), 3) == 0.033  # the table's 0.0328: 0.032748 ms
    # rg_lru_scan (8,128,4096) f32: 0.0151 ms (bytes)
    c = ops.rg_lru_scan_cost(_meta(8, 128, 4096, dt=f), _meta(8, 128, 4096, dt=f),
                             _meta(8, 4096, dt=f))
    assert c.flops == 2 * 8 * 128 * 4096
    assert c.bytes == 4 * (3 * 8 * 128 * 4096 + 2 * 8 * 4096)
    assert round(_ms(c, 67e12), 4) == 0.0151
    assert {n: s.cost for n, s in ops.OP_TABLE.items()} == {
        "flash_attention": ops.flash_attention_cost,
        "decode_attention": ops.decode_attention_cost,
        "page_gather": ops.page_gather_cost, "bank_matmul": ops.bank_matmul_cost,
        "mamba_scan": ops.mamba_scan_cost, "rg_lru_scan": ops.rg_lru_scan_cost}


# ---------------------------------------------------------------------------
# the reference's counts and cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", all_arch_ids())
def test_param_counts_equal_the_references(arch):
    from benchmarks import roofline as jroof

    from repro_torch.bench import roofline as troof

    assert troof._param_counts(arch) == jroof._param_counts(arch)


_REF_CELLS = r"""
import json
import repro.launch.dryrun as D
from repro.configs.registry import all_arch_ids, load_arch
from repro.launch.mesh import make_production_mesh
meshes = {k: make_production_mesh(multi_pod=(k == "multi")) for k in ("single", "multi")}
out = {"cells": [], "mb": {}}
for arch in all_arch_ids():
    mod = load_arch(arch)
    for shape_name, shape in mod.SHAPES.items():
        for k, mesh in meshes.items():
            out["cells"].append([arch, shape_name, k, mod.SKIP.get(shape_name)])
            for tp in (True, False):
                out["mb"][f"{arch}|{shape_name}|{k}|{tp}"] = D.microbatches_for(
                    mod, shape, mesh, tensor_parallel=tp)
print(json.dumps(out))
"""


def test_cells_skips_and_microbatches_equal_the_references():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_CELLS], capture_output=True, text=True,
                       env=env, timeout=300, check=True)
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    ours = [[a, s, m, load_arch(a).SKIP.get(s)] for a, s, m in D.cells()]
    assert ours == ref["cells"]
    from repro_torch.launch.mesh import make_production_mesh

    meshes = {k: make_production_mesh(multi_pod=(k == "multi"), device="meta")
              for k in ("single", "multi")}
    for key, want in ref["mb"].items():
        arch, shape_name, k, tp = key.split("|")
        mod = load_arch(arch)
        got = D.microbatches_for(mod, mod.SHAPES[shape_name], meshes[k],
                                 tensor_parallel=tp == "True")
        assert got == want, key
    # a skipped cell is recorded as the reference records it
    res = D.run_cell("stablelm-1.6b", "long_500k", "single")
    assert (res.kind, res.ok, res.error) == ("skip", True, load_arch("stablelm-1.6b").SKIP[
        "long_500k"])


# ---------------------------------------------------------------------------
# the trace: meta against CPU, and the per-device argument bytes
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["stablelm-1.6b", "deepseek-moe-16b", "falcon-mamba-7b", "recurrentgemma-9b",
                "internvl2-2b", "seamless-m4t-medium"]
TINY = {"train": ShapeSpec("train", 16, 8, "train"),
        "prefill": ShapeSpec("prefill", 16, 2, "prefill"),
        "decode": ShapeSpec("decode", 16, 2, "decode")}


def _mesh24():
    return make_mesh((2, 4), ("data", "model"), "meta")


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_trace_equals_the_cpu_trace(arch, kind):
    cfg = load_arch(arch).smoke_config()
    res = {dev: D.run_cell(arch, kind, "single", cfg=cfg, shape=TINY[kind], mesh=_mesh24(),
                           device=dev) for dev in ("meta", "cpu")}
    m, c = res["meta"], res["cpu"]
    assert m.flops_total > 0 and m.bytes_total > 0
    assert m.flops_total == c.flops_total
    assert m.bytes_total == c.bytes_total
    assert m.aten_counts == c.aten_counts
    assert m.op_calls == c.op_calls
    assert (m.argument_bytes, m.output_bytes, m.peak_live_bytes) == \
        (c.argument_bytes, c.output_bytes, c.peak_live_bytes)
    fam = load_arch(arch).FAMILY
    if fam != "encdec":  # the encdec family calls no kernel op
        assert sum(m.op_calls.values()) > 0
    assert m.collective_wire_bytes is None and m.collective_bytes == {} and m.n_devices == 8


def _shard_sum(tensors_and_specs, mesh) -> int:
    total = 0
    for t, spec in tensors_and_specs:
        spec = tuple(spec) + (None,) * (t.dim() - len(tuple(spec)))
        n = 1
        for dim, axes in zip(t.shape, spec):
            names = () if axes is None else (axes if isinstance(axes, tuple) else (axes,))
            ext = math.prod(mesh.shape[a] for a in names)
            assert dim % ext == 0
            n *= dim // ext
        total += n * t.element_size()
    return total


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_are_the_sum_of_shard_shapes(kind):
    arch = "stablelm-1.6b"
    mod = load_arch(arch)
    cfg = dataclasses.replace(mod.smoke_config(), dtype="bfloat16")
    mesh, shape = _mesh24(), TINY[kind]
    res = D.run_cell(arch, kind, "single", cfg=cfg, shape=shape, mesh=mesh)
    tp = shape.kind != "train" or shape.global_batch % mesh.size != 0
    rules = production_rules(mesh, tensor_parallel=tp)
    params = get_family(mod.FAMILY).init(cfg, 0, device="meta")
    flat, shardings = flatten_paths(params), flatten_paths(param_shardings(params, rules))
    pairs = [(flat[p], shardings[p].spec) for p in flat]
    want = _shard_sum(pairs, mesh)
    if kind == "train":  # AdamW's two float32 moments, sharded as the params
        want += 2 * _shard_sum([(t.float(), s) for t, s in pairs], mesh)
    batch_axes = rules.rules["batch"]
    for x in input_specs(cfg, mod.FAMILY, shape).values():
        want += _shard_sum([(x, (batch_axes,))], mesh)
    assert res.argument_bytes == want
    whole = sum(t.numel() * t.element_size() for t in flat.values())
    assert res.argument_bytes < whole  # the params are split over the mesh
    assert res.peak_bytes_estimate == res.argument_bytes + res.output_bytes + res.temp_bytes


def test_cli_writes_a_cell_with_every_field(tmp_path):
    D.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    cell = json.loads((tmp_path / "stablelm-1.6b__decode_32k__single.json").read_text())
    assert set(cell) == {f.name for f in dataclasses.fields(D.CellResult)}
    assert cell["ok"] and cell["kind"] == "decode" and cell["n_devices"] == 256
    assert cell["collective_wire_bytes"] is None
    assert cell["op_calls"] == {"decode_attention": 24}
    # the whole KV cache at 32k read once; the weights and activations
    # (a few GB) besides
    kv = 2 * 24 * 128 * 32768 * 32 * 64 * 2
    assert cell["bytes_by_op"]["decode_attention"] > kv
    assert kv < cell["bytes_total"] < kv + 5e9


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

PEAKS = dict(PEAK_FLOPS=1e12, HBM_BW=1e11, LINK_BW=1e10)


@pytest.fixture
def both_rooflines(monkeypatch, tmp_path):
    from benchmarks import common as jcommon
    from benchmarks import roofline as jroof

    from repro_torch.bench import common as tcommon
    from repro_torch.bench import roofline as troof

    for mod in (jroof, troof):
        for k, v in PEAKS.items():
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(jcommon, "ARTIFACTS", str(tmp_path / "ref"))
    monkeypatch.setattr(tcommon, "ARTIFACTS", str(tmp_path / "port"))
    return jroof, troof


@pytest.mark.parametrize("cell", [
    dict(arch="stablelm-1.6b", shape="decode_32k", mesh="single", kind="decode",
         flops_per_device=4.66e9, bytes_per_device=3.2e9, collective_wire_bytes=2e8,
         n_devices=256, peak_bytes_estimate=20e9),
    dict(arch="olmoe-1b-7b", shape="train_4k", mesh="multi", kind="train",
         flops_per_device=9.2e13, bytes_per_device=4.5e11, collective_wire_bytes=0,
         n_devices=512, peak_bytes_estimate=45e9),
    dict(arch="falcon-mamba-7b", shape="prefill_32k", mesh="single", kind="prefill",
         flops_per_device=1e14, bytes_per_device=1e9, collective_wire_bytes=5e13,
         n_devices=256, peak_bytes_estimate=1e9),
], ids=["memory", "compute-moe", "collective"])
def test_analyse_equals_the_references(both_rooflines, cell):
    jroof, troof = both_rooflines
    want, got = jroof.analyse(dict(cell)), troof.analyse(dict(cell))
    want.pop("fits_hbm"), got.pop("fits_hbm")
    want["source"] = got["source"]  # the reference's default tag is "scanned"
    assert got == want
    # one controller: no collective term, the dominant one of the other two
    got = troof.analyse(dict(cell, collective_wire_bytes=None))
    assert got["collective_s"] is None
    assert got["dominant"] == max(("compute", "memory"), key=lambda k: got[f"{k}_s"])


def test_bank_collectives_emit_the_references_skip_row(both_rooflines, monkeypatch):
    jroof, troof = both_rooflines
    monkeypatch.setattr(troof, "device_count", lambda: 1)
    want = jroof.run_bank_collectives(quiet=True)
    assert troof.run_bank_collectives() == want


def test_roofline_reads_the_dry_runs_cells(both_rooflines, tmp_path, monkeypatch):
    _, troof = both_rooflines
    out = tmp_path / "dryrun"
    for shape in ("decode_32k", "long_500k"):
        D.main(["--arch", "olmo-1b", "--shape", shape, "--out", str(out)])
    monkeypatch.setattr(troof, "DRYRUN_DIR", str(out))
    res = troof.run()
    assert [r["shape"] for r in res["rows"]] == ["decode_32k"]
    assert res["rows"][0]["source"] == "traced" and res["rows"][0]["collective_s"] is None
    assert res["derived"]["cells_skipped_by_design"] == 1
    assert (tmp_path / "port" / "roofline.json").exists()
