"""The port's Hopper kernels on a card (marker ``gpu``; every test skips on
a host without one).  This file imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the JAX package's kernel-test ones (tests/test_kernels.py
TOL): 2e-3 for float32, 2e-2 for bfloat16 (the kernel and the plain
version sum in different orders; a bf16 output may round to the
neighbouring value).
"""
import pytest
import torch

from repro_torch.kernels import bank_matmul as kbank
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as krglru

TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(device, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(getattr(torch, dtype))
    return rnd


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(cuda_device, dtype):
    rnd = _rnd(cuda_device, dtype, 0)
    for B, S, Hq, Hkv, D, window in [(2, 200, 8, 2, 128, None), (2, 128, 4, 4, 64, 32),
                                     (1, 1, 2, 1, 64, None), (2, 130, 16, 1, 256, None),
                                     (1, 300, 4, 1, 256, 64)]:
        q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        before = ops.kernel_launches()["flash_attention"]
        out = ops.flash_attention(q, k, v, window=window)
        assert ops.kernel_launches()["flash_attention"] == before + 1
        torch.testing.assert_close(out.float(), tref.flash_attention_ref(
            q, k, v, window=window).float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bank_kernel_matches_plain_version(cuda_device, dtype):
    rnd = _rnd(cuda_device, dtype, 1)
    for x, w, b in [(rnd(3, 100, 70), rnd(3, 70, 33), rnd(3, 33)),
                    (rnd(8, 16), rnd(2, 16, 4), None),
                    (rnd(1, 1), rnd(1, 1, 1), rnd(1, 1))]:
        before = ops.kernel_launches()["bank_matmul"]
        out = ops.bank_matmul(x, w, b)
        assert ops.kernel_launches()["bank_matmul"] == before + 1
        torch.testing.assert_close(out, tref.bank_matmul_ref(x, w, b), **TOL[dtype])


BANK_WGMMA_CASES = {  # N, M, K, F, broadcast x, bias
    "aligned-bias": (3, 256, 256, 512, False, True),
    "m8": (3, 8, 2048, 1024, False, False),
    "broadcast": (2, 300, 128, 264, True, True),
    "ragged": (3, 130, 72, 264, False, True),  # M, K, F not multiples of the tile
    "n1-m1": (1, 1, 8, 8, False, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BANK_WGMMA_CASES))
def test_bank_wgmma_route_matches_plain_version(cuda_device, case):
    N, M, K, F, broadcast, bias = BANK_WGMMA_CASES[case]
    rnd = _rnd(cuda_device, "bfloat16", 11)
    x = rnd(M, K) if broadcast else rnd(N, M, K)
    w, b = rnd(N, K, F), (rnd(N, F) if bias else None)
    assert kbank.route(x, w) == "wgmma"
    before = ops.route_launches()["bank_matmul"]
    out = ops.bank_matmul(x, w, b)
    assert ops.route_launches()["bank_matmul"] == {"wgmma": before["wgmma"] + 1,
                                                   "simt": before["simt"]}
    torch.testing.assert_close(out, tref.bank_matmul_ref(x, w, b), **TOL["bfloat16"])


@pytest.mark.gpu
def test_bank_wgmma_route_is_row_stable_across_m_and_n(cuda_device):
    """A row's sum order depends on K alone: the same bits at M = 1, 8 and
    300, for N = 1 and N = 3, and for banked or broadcast x."""
    rnd = _rnd(cuda_device, "bfloat16", 12)
    x, w = rnd(3, 300, 512), rnd(3, 512, 768)
    out = ops.bank_matmul(x, w)
    assert torch.equal(ops.bank_matmul(x[:, :1].contiguous(), w), out[:, :1])
    assert torch.equal(ops.bank_matmul(x[:, :8].contiguous(), w), out[:, :8])
    assert torch.equal(ops.bank_matmul(x[:1].contiguous(), w[:1].contiguous()), out[:1])
    assert torch.equal(ops.bank_matmul(x[2], w)[2], out[2])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_mma_route_matches_plain_version(cuda_device, D):
    """Causal and windowed, ragged S, GQA, S = 1, bidirectional, and a
    window of 1 (each row sees only itself)."""
    rnd = _rnd(cuda_device, "bfloat16", 13)
    for B, S, Hq, Hkv, causal, window in [(2, 200, 8, 2, True, None), (2, 130, 4, 4, True, 32),
                                          (1, 1, 4, 1, True, None), (1, 300, 8, 1, True, 64),
                                          (2, 77, 4, 2, False, None), (2, 64, 2, 2, True, 1)]:
        q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        assert kflash.route(q) == "mma"
        before = ops.route_launches()["flash_attention"]
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert ops.route_launches()["flash_attention"] == {"mma": before["mma"] + 1,
                                                           "simt": before["simt"]}
        torch.testing.assert_close(out.float(), tref.flash_attention_ref(
            q, k, v, causal=causal, window=window).float(), **TOL["bfloat16"])


@pytest.mark.gpu
def test_float32_takes_the_simt_routes(cuda_device):
    rnd = _rnd(cuda_device, "float32", 14)
    ops.reset_kernel_launches()
    ops.bank_matmul(rnd(8, 16), rnd(2, 16, 64), rnd(2, 64))
    q = rnd(1, 70, 2, 64)
    ops.flash_attention(q, q, q)
    assert ops.route_launches() == {"bank_matmul": {"wgmma": 0, "simt": 1},
                                    "flash_attention": {"mma": 0, "simt": 1},
                                    "mamba_scan": {"step": 0, "scan": 0},
                                    "rg_lru_scan": {"scan": 0, "step": 0, "plain": 0}}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_version(cuda_device, dtype):
    rnd = _rnd(cuda_device, dtype, 4)
    for B, Smax, Hq, Hkv, D, lengths in [(8, 128, 32, 32, 64, (128, 1, 77, 64, 65, 3, 100, 9)),
                                         (4, 1000, 32, 8, 128, (1000, 0, 513, 64)),
                                         (2, 70, 16, 1, 64, (0, 70))]:
        q, k, v = rnd(B, Hq, D), rnd(B, Smax, Hkv, D), rnd(B, Smax, Hkv, D)
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        before = ops.kernel_launches()["decode_attention"]
        out = ops.decode_attention(q, k, v, lens)
        again = ops.decode_attention(q, k, v, lens)
        assert ops.kernel_launches()["decode_attention"] == before + 2
        assert torch.equal(out, again)  # one shape, the same bits
        for b in (lens == 0).nonzero().flatten().tolist():
            assert torch.equal(out[b], torch.zeros_like(out[b]))
        torch.testing.assert_close(out.float(), tref.decode_attention_ref(
            q, k, v, lens).float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_gather_kernel_is_exact(cuda_device, dtype):
    rnd = _rnd(cuda_device, dtype, 5)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    for P, W, N in [(128, 32768, 64), (300, 1000, 500), (7, 3, 11)]:
        pool = rnd(P, W)
        table = torch.randint(0, P, (N,), generator=g, device=cuda_device, dtype=torch.int32)
        before = ops.kernel_launches()["page_gather"]
        out = ops.page_gather(pool, table)
        assert ops.kernel_launches()["page_gather"] == before + 1
        assert out.dtype == pool.dtype and torch.equal(out, tref.page_gather_ref(pool, table))
    # a view whose rows are not 16-byte aligned takes the narrow copy
    pool = rnd(9, 1001)[:, 1:]
    table = torch.tensor([8, 0, 3], dtype=torch.int32, device=cuda_device)
    assert torch.equal(ops.page_gather(pool.contiguous(), table), pool[table.long()])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_matches_plain_version(cuda_device, dtype):
    """Ragged S, one decode step with a carried state, both compiled state
    dims.  The kernel and the plain version both widen to float32 first, so
    every input dtype is held at the float32 tolerance."""
    rnd = _rnd(cuda_device, dtype, 7)
    f32 = _rnd(cuda_device, "float32", 8)
    for B, S, di, n, zero_h0 in [(2, 13, 300, 16, True), (8, 1, 512, 16, False),
                                 (3, 70, 128, 8, False)]:
        dt = torch.nn.functional.softplus(rnd(B, S, di).float()).to(getattr(torch, dtype))
        args = (dt, rnd(B, S, di), rnd(B, S, n), rnd(B, S, n), -torch.exp(0.5 * f32(di, n)),
                torch.zeros((B, di, n), device=cuda_device) if zero_h0 else f32(B, di, n))
        before = ops.kernel_launches()["mamba_scan"]
        y, h = ops.mamba_scan(*args)
        assert ops.kernel_launches()["mamba_scan"] == before + 1
        assert y.dtype == h.dtype == torch.float32
        yr, hr = tref.mamba_scan_ref(*args)
        torch.testing.assert_close(y, yr, **TOL["float32"])
        torch.testing.assert_close(h, hr, **TOL["float32"])


RG_LRU_SHAPES = {  # shapes (B, S, d) that take the route in float32 and in bf16
    "scan": [(2, 13, 304), (1, 200, 64), (8, 129, 4096), (8, 13, 4096), (2, 2, 8)],
    "step": [(8, 1, 4096), (3, 1, 1000)],
    "plain": [(2, 13, 1001), (8, 1, 1001), (3, 13, 302)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", list(RG_LRU_SHAPES))
def test_rg_lru_kernel_matches_plain_version(cuda_device, dtype, path):
    """Each route's shapes, the scan's partial tiles (S = 13, 129; d under
    a tile) among them, against rg_lru_ref at the float32 tolerance; every
    launch counted on the route :func:`kernels.rg_lru.route` names."""
    rnd = _rnd(cuda_device, dtype, 9)
    f32 = _rnd(cuda_device, "float32", 10)
    for B, S, d in RG_LRU_SHAPES[path]:
        a = torch.sigmoid(rnd(B, S, d).float()).to(getattr(torch, dtype))
        args = (a, rnd(B, S, d), f32(B, d))
        assert krglru.route(*args) == path
        before = ops.kernel_launches()["rg_lru_scan"]
        routes = ops.route_launches()["rg_lru_scan"]
        y, h = ops.rg_lru_scan(*args)
        assert ops.kernel_launches()["rg_lru_scan"] == before + 1
        assert ops.route_launches()["rg_lru_scan"][path] == routes[path] + 1
        yr, hr = tref.rg_lru_ref(*args)
        torch.testing.assert_close(y, yr, **TOL["float32"])
        torch.testing.assert_close(h, hr, **TOL["float32"])


@pytest.mark.gpu
def test_rg_lru_scan_repeats_bitwise_inside_a_cuda_graph(cuda_device):
    """A "scan" launch (its TMA maps are kernel parameters) captured in a
    CUDA graph: every replayed launch gives the eager launch's bits."""
    rnd = _rnd(cuda_device, "float32", 11)
    a, b, h0 = torch.sigmoid(rnd(8, 129, 4096)), rnd(8, 129, 4096), rnd(8, 4096)
    assert krglru.route(a, b, h0) == "scan"
    want = ops.rg_lru_scan(a, b, h0)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(3):
            outs.append(ops.rg_lru_scan(a, b, h0))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for y, h in outs:
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 32"):
        ops.flash_attention(q, q, q)
    x = torch.zeros((4, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.bank_matmul(x, torch.zeros((2, 8, 3), device=cuda_device, dtype=torch.float16))
    q3, kv = torch.zeros((2, 4, 64), device=cuda_device), torch.zeros((2, 8, 2, 64),
                                                                     device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention(q3, kv, kv, lens.long())
    with pytest.raises(ValueError, match="head dim 32"):
        ops.decode_attention(q3[..., :32].contiguous(), kv[..., :32].contiguous(),
                             kv[..., :32].contiguous(), lens)
    with pytest.raises(ValueError, match="query heads per kv head"):
        ops.decode_attention(torch.zeros((2, 32, 64), device=cuda_device), kv[:, :, :1].contiguous(),
                             kv[:, :, :1].contiguous(), lens)
    strided = torch.zeros((2, 2, 8, 64), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q3, strided, strided, lens)
    with pytest.raises(TypeError, match="int32"):
        ops.page_gather(x, torch.zeros(2, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="pool \\(P, W\\)"):
        ops.page_gather(x[None], torch.zeros(2, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.page_gather(x, torch.zeros(2, dtype=torch.int32))
    dt = torch.zeros((2, 3, 16), device=cuda_device)
    with pytest.raises(ValueError, match="state dim 4"):
        ops.mamba_scan(dt, dt, dt[..., :4].contiguous(), dt[..., :4].contiguous(),
                       torch.zeros((16, 4), device=cuda_device),
                       torch.zeros((2, 16, 4), device=cuda_device))
    # a bf16 A or h0 is widened on load (test_scans_widen_a_bf16_h0_and_A); float16 is not taken
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.mamba_scan(dt, dt, dt[..., :8].contiguous(), dt[..., :8].contiguous(),
                       torch.zeros((16, 8), device=cuda_device, dtype=torch.float16),
                       torch.zeros((2, 16, 8), device=cuda_device))
    with pytest.raises(TypeError, match="h0 float32 or bfloat16"):
        ops.rg_lru_scan(dt, dt, torch.zeros((2, 16), device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rg_lru_scan(dt.transpose(0, 1), dt.transpose(0, 1), torch.zeros((3, 16),
                                                                            device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scans_widen_a_bf16_h0_and_A(cuda_device, dtype):
    """A bf16 h0 (and mamba's A) is widened to float32 on load, as the JAX
    package's kernels do: the result is bitwise the call with the float32
    copies."""
    rnd = _rnd(cuda_device, dtype, 11)
    f32 = _rnd(cuda_device, "float32", 12)
    a, b = torch.sigmoid(rnd(3, 13, 64).float()).to(getattr(torch, dtype)), rnd(3, 13, 64)
    h0 = f32(3, 64).to(torch.bfloat16)
    got, want = ops.rg_lru_scan(a, b, h0), ops.rg_lru_scan(a, b, h0.float())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dt = torch.nn.functional.softplus(rnd(2, 9, 32).float()).to(getattr(torch, dtype))
    dtx, Bm, Cm = rnd(2, 9, 32), rnd(2, 9, 16), rnd(2, 9, 16)
    A, h0 = (-torch.exp(0.5 * f32(32, 16))).to(torch.bfloat16), f32(2, 32, 16).to(torch.bfloat16)
    got = ops.mamba_scan(dt, dtx, Bm, Cm, A, h0)
    want = ops.mamba_scan(dt, dtx, Bm, Cm, A.float(), h0.float())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_kernel_contracts_hold_on_the_card(cuda_device):
    """The contract checker on the card: every case through the Hopper
    kernels within the kernel checks' tolerances of the plain versions,
    every op launched, every guard raising before a launch."""
    from repro_torch.analysis.contracts import run_contracts

    res = run_contracts(device="cuda")
    assert res["ok"], res["failures"]
    assert set(res["ops"]) == set(ops.OP_TABLE)
    assert all(r["launches"] > 0 and r["guards"] > 0 for r in res["ops"].values()), res["ops"]


@pytest.mark.gpu
def test_merged_dense_group_serves_through_both_kernels(cuda_device):
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.models.transformer import DenseLMConfig
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
    from repro_torch.serving.workload import (
        deadline_microbatches, instances_from_store, pad_stack,
    )

    adapter = get_adapter("dense")
    cfg = DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
                        head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                        norm="layernorm", dtype="bfloat16")
    mids = ("A", "B", "C")
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device=cuda_device)
                                    for i, m in enumerate(mids)})
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=(1, 2, 4), simulate_dma=False)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    reqs = [Request(m, torch.randint(0, cfg.vocab_size, (1, 16), generator=g,
                                     device=cuda_device), 0.0, 30.0 + (j * 3 + i) * 1e-3)
            for j in range(2) for i, m in enumerate(mids)]
    for r in reqs:
        eng.submit(r)
    ops.reset_kernel_launches()
    stats = eng.serve(horizon_s=60.0, warmup=reqs[0].payload)
    assert stats["completed"] == len(reqs)
    launches = ops.kernel_launches()
    assert launches["flash_attention"] > 0 and launches["bank_matmul"] > 0
    assert stats["suffix_dispatches"] == stats["microbatches"]
    res = {id(c.request): c.result for c in eng.completions}
    for mb in deadline_microbatches(reqs, (1, 2, 4)):  # the engine's own batches
        batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
        for j, r in enumerate(mb.requests):
            assert res[id(r)].is_cuda and res[id(r)].dtype == torch.float32
            direct = adapter.forward(cfg, store.materialize(r.instance_id), batch)[j]
            torch.testing.assert_close(res[id(r)], direct, **TOL["bfloat16"])


@pytest.mark.gpu
def test_paged_streaming_decode_replays_through_the_unpaged_decode(cuda_device):
    """A merged pair plus a singleton, 2 layers, head dim 64, bf16: every
    request streams through the paged path (page_gather + decode_attention +
    bank_matmul) and its tokens equal the teacher-forced unpaged replay's
    wherever the replay's top-2 margin exceeds the bf16 tolerance."""
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.models.transformer import DenseLMConfig
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.decode import DecodeRequest, replay_unpaged
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
    from repro_torch.serving.workload import instances_from_store

    adapter = get_adapter("dense")
    cfg = DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                        norm="layernorm", dtype="bfloat16")
    mids = ("A", "B", "C")
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device=cuda_device)
                                    for i, m in enumerate(mids)})
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in ("A", "B") for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=(1, 2, 4), simulate_dma=False)
    g = torch.Generator().manual_seed(7)
    reqs = [DecodeRequest(m, torch.randint(0, cfg.vocab_size, (9,), generator=g).numpy(),
                          max_new_tokens=6) for _ in range(2) for m in mids]
    ops.reset_kernel_launches()
    stats = eng.serve_decode(reqs, page_size=4, num_pages=32, max_slots=6, max_len=16,
                             record_logits=True, chunked_prefill=True)
    launches = ops.kernel_launches()
    assert stats["completed"] == len(reqs) and stats["pool_identity_ok"]
    assert stats["bank_dispatches"] == stats["group_steps"] > 0
    assert launches["page_gather"] == 2 * launches["decode_attention"] > 0
    assert launches["bank_matmul"] > 0
    dec = eng.last_decoder
    for c in dec.completions:
        rows = replay_unpaged(dec, c)
        for i, row in enumerate(rows):
            row_t, got = torch.from_numpy(row), torch.from_numpy(c.logits[i])
            torch.testing.assert_close(got, row_t, **TOL["bfloat16"])
            top2 = torch.topk(row_t, 2).values
            if top2[0] - top2[1] > 2e-2 + 2e-2 * top2[0].abs():
                assert c.tokens[i] == int(row_t.argmax())


def _merged_engine(family, cfg, mids, device, buckets):
    """An engine over ``mids`` with every trunk group merged."""
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
    from repro_torch.serving.workload import instances_from_store

    adapter = get_adapter(family)
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device=device)
                                    for i, m in enumerate(mids)})
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    return adapter, MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo"),
        [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
        capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
        buckets=buckets, simulate_dma=False)


def _serve_and_check(adapter, cfg, eng, mids, device, S):
    """Two requests per member, interleaved; every served row against the
    member's direct forward on the engine's own padded batch."""
    from repro_torch.serving.executor import Request
    from repro_torch.serving.workload import deadline_microbatches, pad_stack

    g = torch.Generator(device=device).manual_seed(3)
    reqs = [Request(m, torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=device),
                    0.0, 30.0 + (j * len(mids) + i) * 1e-3)
            for j in range(2) for i, m in enumerate(mids)]
    for r in reqs:
        eng.submit(r)
    ops.reset_kernel_launches()
    stats = eng.serve(horizon_s=60.0, warmup=reqs[0].payload)
    launches = ops.kernel_launches()
    assert stats["completed"] == len(reqs)
    res = {id(c.request): c.result for c in eng.completions}
    for mb in deadline_microbatches(reqs, eng.buckets):
        batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
        for j, r in enumerate(mb.requests):
            assert res[id(r)].device.type == device.type and res[id(r)].dtype == torch.float32
            direct = adapter.forward(cfg, eng.store.materialize(r.instance_id), batch)[j]
            torch.testing.assert_close(res[id(r)], direct, **TOL["bfloat16"])
    return stats, launches


@pytest.mark.gpu
def test_merged_ssm_group_serves_and_streams_through_the_kernels(cuda_device):
    """A merged trio of a small bf16 mamba (state dim 16): served through
    mamba_scan and bank_matmul, then streamed (mamba_scan at S = 1 with the
    state from the pool) with tokens equal to the teacher-forced unpaged
    replay wherever the replay's top-2 margin exceeds the bf16 tolerance."""
    from repro_torch.models.ssm import MambaConfig
    from repro_torch.serving.decode import DecodeRequest, replay_unpaged

    cfg = MambaConfig(name="gpu-mamba", n_layers=2, d_model=128, d_inner=256, d_state=16,
                      dt_rank=8, vocab_size=300, tie_embeddings=False, dtype="bfloat16")
    mids = ("A", "B", "C")
    adapter, eng = _merged_engine("ssm", cfg, mids, cuda_device, (1, 2, 4))
    stats, launches = _serve_and_check(adapter, cfg, eng, mids, cuda_device, 19)
    assert launches["mamba_scan"] > 0 and launches["bank_matmul"] > 0
    assert launches["flash_attention"] == 0
    assert stats["suffix_dispatches"] == stats["microbatches"]
    g = torch.Generator().manual_seed(7)
    reqs = [DecodeRequest(m, torch.randint(0, cfg.vocab_size, (9,), generator=g).numpy(),
                          max_new_tokens=6) for _ in range(2) for m in mids]
    ops.reset_kernel_launches()
    stats = eng.serve_decode(reqs, page_size=4, num_pages=32, max_slots=6, max_len=16,
                             record_logits=True, chunked_prefill=True)
    launches = ops.kernel_launches()
    assert stats["completed"] == len(reqs) and stats["pool_identity_ok"]
    assert stats["trunk_dispatches"] == stats["bank_dispatches"] == stats["group_steps"] > 0
    assert launches["mamba_scan"] > 0 and launches["bank_matmul"] > 0
    dec = eng.last_decoder
    for c in dec.completions:
        for i, row in enumerate(replay_unpaged(dec, c)):
            row_t, got = torch.from_numpy(row), torch.from_numpy(c.logits[i])
            torch.testing.assert_close(got, row_t, **TOL["bfloat16"])
            top2 = torch.topk(row_t, 2).values
            if top2[0] - top2[1] > 2e-2 + 2e-2 * top2[0].abs():
                assert c.tokens[i] == int(row_t.argmax())


@pytest.mark.gpu
def test_merged_tied_hybrid_group_serves_through_the_kernels(cuda_device):
    """A merged trio of a small bf16 griffin with recurrentgemma's shape of
    attention (head dim 256, 4 query heads on one kv head, a window shorter
    than the sequence) and a tied head: rg_lru_scan and flash_attention
    run, the heads fan out per member (no bank)."""
    from repro_torch.models.griffin import GriffinConfig

    cfg = GriffinConfig(name="gpu-griffin", n_layers=3, d_model=128, d_rnn=128, n_heads=4,
                        n_kv_heads=1, head_dim=256, d_ff=256, vocab_size=300, window=8,
                        tie_embeddings=True, dtype="bfloat16")
    mids = ("A", "B", "C")
    adapter, eng = _merged_engine("hybrid", cfg, mids, cuda_device, (1, 2, 4))
    stats, launches = _serve_and_check(adapter, cfg, eng, mids, cuda_device, 24)
    assert launches["rg_lru_scan"] > 0 and launches["flash_attention"] > 0
    assert launches["bank_matmul"] == 0
    assert stats["suffix_dispatches"] == stats["suffix_runs"] > stats["microbatches"]


# ---------------------------------------------------------------------------
# decode_attention: keys split across blocks, merged in chunk order
# ---------------------------------------------------------------------------


def _split_edge_lengths(Smax):
    """Lengths around the kernel's chunk size T: 0, 1, T - 1, T, T + 1, two
    chunks and a bit, and Smax."""
    T = kdecode.CHUNK
    return (0, 1, T - 1, T, T + 1, 2 * T + 5, Smax)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_decode_kernel_over_head_dims_groups_and_split_edges(cuda_device, dtype, D, G):
    Hkv, Smax = 2, 3 * kdecode.CHUNK + 7
    lengths = _split_edge_lengths(Smax)
    rnd = _rnd(cuda_device, dtype, 20 + G)
    B = len(lengths)
    q, k, v = rnd(B, G * Hkv, D), rnd(B, Smax, Hkv, D), rnd(B, Smax, Hkv, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = ops.kernel_launches()["decode_attention"]
    out = ops.decode_attention(q, k, v, lens)
    again = ops.decode_attention(q, k, v, lens)
    assert ops.kernel_launches()["decode_attention"] == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # length 0
    torch.testing.assert_close(out.float(), tref.decode_attention_ref(
        q, k, v, lens).float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_decode_row_alone_is_bitwise_the_row_in_its_batch(cuda_device, dtype, G):
    """A row's output depends on its own q, keys and length only: computed
    alone (B = 1, Smax = its length rounded up to 16) it has the bits it
    has inside the batch."""
    Hkv, D, Smax = 2, 128 if G == 4 else 64, 3 * kdecode.CHUNK + 7
    lengths = _split_edge_lengths(Smax)
    rnd = _rnd(cuda_device, dtype, 30 + G)
    B = len(lengths)
    q, k, v = rnd(B, G * Hkv, D), rnd(B, Smax, Hkv, D), rnd(B, Smax, Hkv, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    out = ops.decode_attention(q, k, v, lens)
    for b, n in enumerate(lengths):
        S1 = -(-n // 16) * 16
        alone = ops.decode_attention(q[b:b + 1].contiguous(), k[b:b + 1, :S1].contiguous(),
                                     v[b:b + 1, :S1].contiguous(), lens[b:b + 1].contiguous())
        assert torch.equal(alone[0], out[b]), f"row {b} (length {n})"


@pytest.mark.gpu
def test_decode_kernel_repeats_bitwise_inside_a_cuda_graph(cuda_device):
    """Replays of a captured graph give the eager bits, and every launch
    leaves the chunk counters at zero (rows of length 0 included)."""
    rnd = _rnd(cuda_device, "bfloat16", 40)
    B, Smax, Hq, Hkv, D = 4, 1000, 32, 8, 128
    q, k, v = rnd(B, Hq, D), rnd(B, Smax, Hkv, D), rnd(B, Smax, Hkv, D)
    lens = torch.tensor([1000, 0, 513, 64], dtype=torch.int32, device=cuda_device)
    want = ops.decode_attention(q, k, v, lens)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(5):
            outs.append(ops.decode_attention(q, k, v, lens))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)
    assert int(kdecode._COUNTERS[q.device][-1].abs().sum()) == 0


# ---------------------------------------------------------------------------
# mamba_scan: one kernel for every S
# ---------------------------------------------------------------------------


def _mamba_args(device, dtype, seed, B, S, di, n, zero_h0=False):
    rnd = _rnd(device, dtype, seed)
    f32 = _rnd(device, "float32", seed + 1)
    dt = torch.nn.functional.softplus(rnd(B, S, di).float()).to(getattr(torch, dtype))
    return (dt, rnd(B, S, di), rnd(B, S, n), rnd(B, S, n), -torch.exp(0.5 * f32(di, n)),
            torch.zeros((B, di, n), device=device) if zero_h0 else f32(B, di, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("S", [1, 2, 13, 128, 300])
def test_mamba_scan_kernel_over_state_dims_and_lengths(cuda_device, dtype, n, S):
    """Ragged di (not a multiple of a block's channels), held at the float32
    tolerance for either input dtype; repeat launches give the same bits."""
    args = _mamba_args(cuda_device, dtype, 50 + S, 3, S, 1000, n)
    before = ops.route_launches()["mamba_scan"]
    y, h = ops.mamba_scan(*args)
    y2, h2 = ops.mamba_scan(*args)
    path = "step" if S == 1 else "scan"
    assert ops.route_launches()["mamba_scan"][path] == before[path] + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yr, hr = tref.mamba_scan_ref(*args)
    torch.testing.assert_close(y, yr, **TOL["float32"])
    torch.testing.assert_close(h, hr, **TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 16])
def test_mamba_serve_scan_is_bitwise_its_chained_decode_steps(cuda_device, dtype, n):
    """A scan of S steps ("scan" route) and S launches at S = 1 ("step"
    route) that carry h_last as the next h0 give the same y and h_last,
    bit for bit: a serve scan and decode steps agree exactly."""
    S = 13
    dt, dtx, Bm, Cm, A, h0 = _mamba_args(cuda_device, dtype, 60 + n, 4, S, 520, n)
    y, h = ops.mamba_scan(dt, dtx, Bm, Cm, A, h0)
    hc, ys = h0, []
    for t in range(S):
        sl = slice(t, t + 1)
        yt, hc = ops.mamba_scan(dt[:, sl].contiguous(), dtx[:, sl].contiguous(),
                                Bm[:, sl].contiguous(), Cm[:, sl].contiguous(), A, hc)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(hc, h)


@pytest.mark.gpu
def test_mamba_scan_repeats_bitwise_inside_a_cuda_graph(cuda_device):
    args = _mamba_args(cuda_device, "float32", 70, 8, 1, 8192, 16)
    want = ops.mamba_scan(*args)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(5):
            outs.append(ops.mamba_scan(*args))
    graph.replay()
    torch.cuda.synchronize()
    for y, h in outs:
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])


# ---------------------------------------------------------------------------
# the tied head on tensor cores; griffin streaming decode
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("tied", [True, False])
def test_unembed_takes_bf16_operands_on_the_card(cuda_device, tied):
    """``layers.unembed`` on bf16 CUDA tensors: float32 logits within 2e-3
    of the row maximum of the widened float32 product, and no float32 copy
    of the table (peak memory grows by less than half of one)."""
    from repro_torch.models import layers

    rnd = _rnd(cuda_device, "bfloat16", 21)
    V, d = 32768, 1024
    w = rnd(V, d) if tied else rnd(d, V)
    x = rnd(2, 4, d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = layers.unembed(x, w, transpose=tied)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < w.numel() * 4 // 2
    assert out.shape == (2, 4, V) and out.dtype == torch.float32
    want = torch.matmul(x.float(), (w.t() if tied else w).float())
    scale = want.abs().amax(dim=-1, keepdim=True)
    torch.testing.assert_close(out / scale, want / scale, rtol=0, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_lru_decode_steps_carry_h0(cuda_device, dtype):
    """rg_lru_scan at S = 1, each launch taking the last one's h_last as its
    h0 (a decode step's recurrence), at recurrentgemma's width: every step
    against rg_lru_ref, and the chain ("step" route) bitwise the one S = 16
    launch ("scan" route)."""
    rnd = _rnd(cuda_device, dtype, 22)
    f32 = _rnd(cuda_device, "float32", 23)
    B, S, d = 8, 16, 4096
    a = torch.sigmoid(rnd(B, S, d).float()).to(getattr(torch, dtype))
    b, h0 = rnd(B, S, d), f32(B, d)
    ops.reset_kernel_launches()
    y, h = ops.rg_lru_scan(a, b, h0)
    hc, ys = h0, []
    for t in range(S):
        at, bt = a[:, t:t + 1].contiguous(), b[:, t:t + 1].contiguous()
        yt, hn = ops.rg_lru_scan(at, bt, hc)
        yr, hr = tref.rg_lru_ref(at, bt, hc)
        torch.testing.assert_close(yt, yr, **TOL["float32"])
        torch.testing.assert_close(hn, hr, **TOL["float32"])
        ys.append(yt)
        hc = hn
    assert ops.route_launches()["rg_lru_scan"] == {"scan": 1, "step": S, "plain": 0}
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(hc, h)


@pytest.mark.gpu
def test_merged_tied_hybrid_group_streams_on_the_card_against_the_plain_path(cuda_device):
    """A merged trio of a small float32 griffin (tied head, window 8)
    streamed on the card with chunked prefill, every request past the
    window so the ring wraps: rg_lru_scan launches once per recurrent layer
    per trunk pass, and every emitted logits row matches a replay of the
    same tokens on the CPU through the plain versions (2e-3)."""
    from repro_torch.models import griffin
    from repro_torch.models.griffin import GriffinConfig
    from repro_torch.serving.decode import DecodeRequest
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    cfg = GriffinConfig(name="gpu-griffin", n_layers=6, d_model=128, d_rnn=128, n_heads=4,
                        n_kv_heads=1, head_dim=64, d_ff=256, vocab_size=300, window=8,
                        tie_embeddings=True, dtype="float32")
    mids = ("A", "B", "C")
    _, eng = _merged_engine("hybrid", cfg, mids, cuda_device, (1, 2, 4))
    g = torch.Generator().manual_seed(8)
    reqs = [DecodeRequest(m, torch.randint(0, cfg.vocab_size, (9,), generator=g).numpy(),
                          max_new_tokens=8) for _ in range(2) for m in mids]
    ops.reset_kernel_launches()
    stats = eng.serve_decode(reqs, page_size=4, num_pages=32, max_slots=6, max_len=16,
                             record_logits=True, chunked_prefill=True)
    launches = ops.kernel_launches()
    dec = eng.last_decoder
    assert stats["completed"] == len(reqs) and stats["pool_identity_ok"]
    assert stats["trunk_dispatches"] == stats["group_steps"] > 0
    assert stats["bank_dispatches"] == 0 and stats["head_dispatches"] >= stats["group_steps"]
    n_rec = cfg.pattern.count("rec") * cfg.n_repeats
    passes = dec.trunk_passes
    assert launches["rg_lru_scan"] == n_rec * (passes["warmup"] + passes["run"]) > 0
    assert launches["flash_attention"] == launches["bank_matmul"] == 0
    for c in dec.completions:
        params = unflatten_paths({p: t.cpu() for p, t in flatten_paths(
            eng.store.materialize(c.request.instance_id)).items()})
        cache = griffin.init_cache(cfg, 1, 16, device="cpu")
        seq = [int(t) for t in c.request.prompt] + c.tokens[:-1]
        rows = []
        for i, tok in enumerate(seq):
            logits, cache = griffin.decode_step(cfg, params, cache,
                                                torch.tensor([[tok]], dtype=torch.int64))
            if i >= len(c.request.prompt) - 1:
                rows.append(logits[0, 0])
        assert len(rows) == len(c.tokens) == 8
        for row, got in zip(rows, c.logits):
            torch.testing.assert_close(torch.from_numpy(got), row, **TOL["float32"])


@pytest.mark.gpu
def test_flash_attention_refuses_a_call_autograd_would_record(cuda_device):
    """The kernel has no backward: under grad with an input that requires
    grad the call raises instead of returning a result cut from the graph;
    under ``torch.no_grad()`` it launches."""
    rnd = _rnd(cuda_device, "bfloat16", 21)
    q, k, v = rnd(1, 16, 2, 64), rnd(1, 16, 2, 64), rnd(1, 16, 2, 64)
    q.requires_grad_(True)
    before = ops.kernel_launches()["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    assert ops.kernel_launches()["flash_attention"] == before
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert ops.kernel_launches()["flash_attention"] == before + 1
    assert out.grad_fn is None
    torch.testing.assert_close(out.float(), tref.flash_attention_ref(
        q.detach(), k, v).float(), **TOL["bfloat16"])


def _small_cnn_pair(device):
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter

    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    mids = ("A", "B")
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device=device)
                                    for i, m in enumerate(mids)})
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    return adapter, cfg, mids, store, enumerate_groups(recs)


@pytest.mark.gpu
def test_plan_applies_on_a_cuda_store(cuda_device):
    from repro_torch.core import MergePlan

    adapter, cfg, mids, cloud, groups = _small_cnn_pair(cuda_device)
    for g in groups:
        cloud.merge_group(g)
    payload = cloud.export_plan(groups, include_weights=True).to_json()
    edge = _small_cnn_pair(cuda_device)[3]
    keys = edge.apply_plan(MergePlan.from_json(payload))
    assert edge.epoch == 1 and edge.bindings == cloud.bindings
    assert keys and set(keys) == cloud.shared_keys()
    for k in keys:
        assert edge.buffers[k].is_cuda and torch.equal(edge.buffers[k], cloud.buffers[k])


@pytest.mark.gpu
def test_merge_trainer_sums_shared_gradients_on_the_card(cuda_device):
    from repro_torch.core import MergeTrainer
    from repro_torch.core.merging import joint_grads
    from repro_torch.train.optimizer import AdamW

    torch.backends.cudnn.allow_tf32 = False
    adapter, cfg, mids, store, groups = _small_cnn_pair(cuda_device)
    for g in groups:
        store.merge_group(g)
    regs = [adapter.registered(cfg, m, 10 + i, device=cuda_device, accuracy_target=0.0)
            for i, m in enumerate(mids)]
    bindings = {m: dict(store.bindings[m]) for m in mids}
    keys = sorted({k for b in bindings.values() for k in b.values()})
    buffers = {k: store.buffers[k] for k in keys}
    loss_fns = {r.model_id: r.loss_fn for r in regs}
    batches = {r.model_id: r.train_batches(0)[0] for r in regs}
    _, grads = joint_grads(bindings, loss_fns, buffers, batches)
    per = {m: joint_grads({m: bindings[m]}, loss_fns, buffers, batches)[1] for m in mids}
    for k in store.shared_keys():
        summed = per["A"][k] + per["B"][k]
        assert grads[k].is_cuda
        assert (2 * grads[k] - summed).abs().max() <= 1e-5 * summed.abs().max()
    before = {k: store.buffers[k].clone() for k in store.shared_keys()}
    res = MergeTrainer(optimizer=AdamW(lr=1e-3), max_epochs=1).train(store, regs)
    assert res.success and res.epochs_used == 1
    assert all(not torch.equal(store.buffers[k], v) for k, v in before.items())


@pytest.mark.gpu
def test_wire_codec_round_trips_a_cuda_bf16_tensor(cuda_device):
    from repro_torch.core.signatures import decode_weight_entry, encode_weight_entry

    t = _rnd(cuda_device, "bfloat16", 22)(33, 17)
    entry = encode_weight_entry(t)
    assert entry["dtype"] == "bfloat16" and entry["kind"] == "full"
    back = decode_weight_entry(entry)
    assert back.dtype == torch.bfloat16 and torch.equal(back.to(cuda_device), t)
    assert encode_weight_entry(t, base=t.clone())["kind"] == "same"


@pytest.mark.gpu
def test_edge_executor_serves_and_decodes_on_the_card(cuda_device):
    """The time-shared baseline on the card: a store of three unmerged
    float32 members whose capacity holds one, served (batch 2) and decoded
    one request at a time, against the same executor on a CPU copy of the
    store through the plain versions (float32 on both sides, so the rows
    are held to the float32 tolerance; the bf16 lanes at full width are
    chip_smoke.py's ``stablelm_timeshare*``).  Serving launches
    flash_attention and no bank; decoding launches decode_attention and
    neither page_gather nor the bank."""
    from repro_torch.core import ParamStore
    from repro_torch.models.registry import get_adapter
    from repro_torch.models.transformer import DenseLMConfig
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.decode import DecodeRequest
    from repro_torch.serving.executor import EdgeExecutor, ModelProgram, Request
    from repro_torch.serving.workload import instances_from_store
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    adapter = get_adapter("dense")
    cfg = DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                        norm="layernorm", dtype="float32")
    mids = ("A", "B", "C")
    params = {m: adapter.init(cfg, seed=i, device=cuda_device) for i, m in enumerate(mids)}
    cpu = torch.device("cpu")
    stores = {
        "cuda": ParamStore.from_models(params),
        "cpu": ParamStore.from_models({m: unflatten_paths({k: v.cpu() for k, v in
                                                           flatten_paths(p).items()})
                                       for m, p in params.items()}),
    }
    act = int(costs_for("tiny-yolo").activation_gb(2) * 1e9)
    capacity = act + int(1.5 * stores["cpu"].model_bytes("A"))
    g = torch.Generator().manual_seed(5)
    tokens = [torch.randint(0, cfg.vocab_size, (1, 16), generator=g) for _ in range(6)]
    prompts = [torch.randint(0, cfg.vocab_size, (9,), generator=g).numpy() for _ in range(3)]
    out, launches = {}, {}
    for name, device in (("cuda", cuda_device), ("cpu", cpu)):
        store = stores[name]
        ex = EdgeExecutor(store, instances_from_store(store, "tiny-yolo"),
                          {m: adapter.bound_forward(cfg) for m in mids},
                          capacity_bytes=capacity, costs={"tiny-yolo": costs_for("tiny-yolo")},
                          simulate_dma=False)
        for i, t in enumerate(tokens):
            ex.submit(Request(mids[i % 3], t.to(device), 0.0, 60.0 + i * 1e-3, meta=i))
        ops.reset_kernel_launches()
        stats = ex.serve(horizon_s=120.0, batch=2, warmup=tokens[0].to(device), drain=True)
        serve_launches = ops.kernel_launches()
        reqs = [DecodeRequest(mids[i], prompts[i], max_new_tokens=4) for i in range(3)]
        ops.reset_kernel_launches()
        dstats = ex.serve_decode(reqs, [ModelProgram.from_adapter(adapter, m, cfg=cfg)
                                        for m in mids], max_len=32)
        out[name] = (stats, {c.request.meta: c.result for c in ex.completions},
                     dstats, ex.decode_completions, ex.scheduler.stats)
        launches[name] = (serve_launches, ops.kernel_launches())
    (stats, res, dstats, comps, sched), (cstats, cres, cdstats, ccomps, csched) = \
        out["cuda"], out["cpu"]
    assert stats == cstats and stats["completed"] == 6 and sched == csched
    assert sched["evictions"] > 0
    serve_l, decode_l = launches["cuda"]
    assert serve_l["flash_attention"] > 0 and serve_l["bank_matmul"] == 0
    assert decode_l["decode_attention"] > 0
    assert decode_l["page_gather"] == 0 and decode_l["bank_matmul"] == 0
    assert not any(launches["cpu"][0].values()) and not any(launches["cpu"][1].values())
    for i in res:
        assert res[i].is_cuda and res[i].dtype == torch.float32
        torch.testing.assert_close(res[i].cpu(), cres[i], **TOL["float32"])
    keys = ("completed", "steps", "tokens_decoded", "prompt_tokens")
    assert {k: dstats[k] for k in keys} == {k: cdstats[k] for k in keys}
    assert dstats["steps"] == dstats["tokens_decoded"] == 3 * 4
    for c, cc in zip(comps, ccomps):
        assert c.request is cc.request or c.request.instance_id == cc.request.instance_id
        logits = adapter.forward(cfg, stores["cpu"].materialize(cc.request.instance_id),
                                 torch.from_numpy(cc.request.prompt.astype("int64"))[None])
        row = logits[0, -1].float()
        top2 = torch.topk(row, 2).values
        if top2[0] - top2[1] > 2e-3 + 2e-3 * top2[0].abs():
            assert c.tokens[0] == cc.tokens[0] == int(row.argmax())


def _edge_serve_rows(adapter, cfg, params, device, tokens, mids):
    """``EdgeExecutor.serve`` (batch 2, drained) of ``tokens`` over a store of
    ``params`` moved to ``device``, at a capacity that holds one member:
    the rows by request as float32 on the CPU, and the serve's launches."""
    from repro_torch.core import ParamStore
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import EdgeExecutor, Request
    from repro_torch.serving.workload import instances_from_store
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    store = ParamStore.from_models({m: unflatten_paths({k: v.to(device) for k, v in
                                                        flatten_paths(p).items()})
                                    for m, p in params.items()})
    act = int(costs_for("tiny-yolo").activation_gb(2) * 1e9)
    ex = EdgeExecutor(store, instances_from_store(store, "tiny-yolo"),
                      {m: adapter.bound_forward(cfg) for m in mids},
                      capacity_bytes=act + int(1.5 * store.model_bytes(mids[0])),
                      costs={"tiny-yolo": costs_for("tiny-yolo")}, simulate_dma=False)
    for i, t in enumerate(tokens):
        ex.submit(Request(mids[i % len(mids)], t.to(device), 0.0, 60.0 + i * 1e-3, meta=i))
    ops.reset_kernel_launches()
    stats = ex.serve(horizon_s=120.0, batch=2, warmup=tokens[0].to(device), drain=True)
    assert stats["completed"] == len(tokens) and ex.scheduler.stats["evictions"] > 0
    return {c.request.meta: c.result.float().cpu() for c in ex.completions}, ops.kernel_launches()


@pytest.mark.gpu
def test_edge_executor_bf16_serve_strays_from_float32_no_more_than_the_cpu(cuda_device):
    """The bf16 serve at the config of the test above.  Two bf16 runs of it
    (the card's kernels, the CPU's plain versions) each round their own way,
    and at this config bf16 alone moves some logits by more than the bf16
    kernel tolerance from their float32 values.  So the card's bf16 rows are
    held against float32 rows of the same (bf16-valued) weights on the CPU,
    to twice the gap that the CPU's own bf16 rows show against them, at the
    largest element and in RMS.  The gaps are printed (``-s``)."""
    import dataclasses

    from repro_torch.models.registry import get_adapter
    from repro_torch.models.transformer import DenseLMConfig
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    adapter = get_adapter("dense")
    cfg = DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                        norm="layernorm", dtype="bfloat16")
    mids = ("A", "B", "C")
    cpu = torch.device("cpu")
    params = {m: adapter.init(cfg, seed=i, device=cpu) for i, m in enumerate(mids)}
    params32 = {m: unflatten_paths({k: v.float() for k, v in flatten_paths(p).items()})
                for m, p in params.items()}
    g = torch.Generator().manual_seed(5)
    tokens = [torch.randint(0, cfg.vocab_size, (1, 16), generator=g) for _ in range(6)]
    card, launches = _edge_serve_rows(adapter, cfg, params, cuda_device, tokens, mids)
    host, host_launches = _edge_serve_rows(adapter, cfg, params, cpu, tokens, mids)
    f32, _ = _edge_serve_rows(adapter, dataclasses.replace(cfg, dtype="float32"), params32,
                              cpu, tokens, mids)
    assert launches["flash_attention"] > 0 and launches["bank_matmul"] == 0
    assert not any(host_launches.values())
    assert sorted(card) == sorted(host) == sorted(f32) == list(range(len(tokens)))

    def gap(rows, ref):
        d = torch.stack([rows[i] - ref[i] for i in sorted(ref)])
        return d.abs().max().item(), d.pow(2).mean().sqrt().item()

    card_gap, host_gap = gap(card, f32), gap(host, f32)
    print(f"edge bf16 serve, max and RMS gap to float32: card {card_gap}, cpu {host_gap}, "
          f"card to cpu bf16 {gap(card, host)}, elements {sum(r.numel() for r in f32.values())}")
    assert card_gap[0] <= 2 * host_gap[0] and card_gap[1] <= 2 * host_gap[1], (card_gap, host_gap)


def _merged_small_cnn_trio(device):
    """Three small-CNN members on ``device`` with every trunk group merged,
    and a monitor over their originals."""
    from repro_torch.core import ParamStore, RegisteredModel, enumerate_groups
    from repro_torch.core.drift import DriftMonitor
    from repro_torch.models.registry import get_adapter

    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    zoo = {m: adapter.init(cfg, seed=i, device=device) for i, m in enumerate("ABC")}
    store = ParamStore.from_models(dict(zoo))
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m, p in zoo.items() for r in adapter.records(cfg, p, m) if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    regs = [RegisteredModel(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in zoo]
    return adapter, cfg, zoo, store, DriftMonitor(store, dict(zoo), regs)


@pytest.mark.gpu
def test_drift_revert_on_a_cuda_store_keeps_survivors_shared_buffers(cuda_device):
    from repro_torch.core.drift import DriftReport

    _, _, zoo, store, monitor = _merged_small_cnn_trio(cuda_device)
    shared = {k: store.buffers[k] for k in store.shared_keys()}
    assert shared and all(t.is_cuda for t in shared.values())
    epoch0 = store.epoch
    monitor.revert(DriftReport({}, {"B"}, set()))
    assert store.epoch == epoch0 + 1
    for k, t in shared.items():
        assert store.buffers[k] is t  # the same tensors, not copies
        assert k in set(store.bindings["A"].values()) and k in set(store.bindings["C"].values())
    assert all(key == f"B:{path}" for path, key in store.bindings["B"].items())
    assert store.materialize("B")["stem"]["w"] is zoo["B"]["stem"]["w"]
    assert set(store.buffers) == {k for b in store.bindings.values() for k in b.values()}


@pytest.mark.gpu
def test_swap_failure_rolls_back_on_a_cuda_store(cuda_device):
    from repro_torch.core import MergePlan, ParamStore
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import (
        MergeAwareEngine, ModelProgram, PlanApplyError, Request,
    )
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.workload import instances_from_store

    adapter, cfg, zoo, cloud, _ = _merged_small_cnn_trio(cuda_device)
    plan = MergePlan.from_json(cloud.export_plan(_trunk_groups_of(adapter, cfg, zoo),
                                                 include_weights=True).to_json())
    store = ParamStore.from_models(dict(zoo))
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo", model_ids=list(zoo)),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in zoo],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=(1, 2, 4))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for i in range(6):
        eng.submit(Request("ABC"[i % 3], torch.randn((1, 32, 32, 3), generator=gen,
                                                     device=cuda_device), 0.0, 60.0))
    epoch0 = store.epoch
    bind0 = {m: dict(b) for m, b in store.bindings.items()}
    buffers0 = dict(store.buffers)
    FaultInjector().arm_swap_failure(store, fail_after_columns=1)
    with pytest.raises(PlanApplyError):
        eng.apply_plan(plan)
    assert store.epoch == epoch0 + 1 and store.bindings == bind0
    assert set(store.buffers) == set(buffers0)
    assert all(store.buffers[k] is t for k, t in buffers0.items())
    assert sum(len(q) for q in eng.queues.values()) == 6
    out = eng.apply_plan(plan)
    assert out["epoch_bumps"] == 1 and out["pending_requests"] == 6
    assert all(store.buffers[k].is_cuda for k in out["shared_keys"])
    stats = eng.serve(horizon_s=60.0)
    assert stats["completed"] == 6 and eng.skipped == 0


def _trunk_groups_of(adapter, cfg, zoo):
    from repro_torch.core import enumerate_groups

    trunk = adapter.split(cfg).prefix_paths
    return enumerate_groups([r for m, p in zoo.items() for r in adapter.records(cfg, p, m)
                             if r.path in trunk])


def _reverted_serve_rows(adapter, cfg, zoo, new_b, device, tokens):
    """A merged dense trio on ``device``, its member B reverted to ``new_b``
    through the engine's ``revert`` with ``tokens`` queued (B's every other
    request), then served: B's rows by request as float32 on the CPU, and
    the serve's launches."""
    from repro_torch.core import ParamStore, RegisteredModel
    from repro_torch.core.drift import DriftMonitor, DriftReport
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
    from repro_torch.serving.workload import instances_from_store
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    def on(p):
        return unflatten_paths({k: v.to(device) for k, v in flatten_paths(p).items()})

    originals = {m: on(p) for m, p in zoo.items()}
    store = ParamStore.from_models(dict(originals))
    for g in _trunk_groups_of(adapter, cfg, originals):
        store.merge_group(g)
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo", model_ids=list(zoo)),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in zoo],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=(1, 2, 4))
    for i, t in enumerate(tokens):
        eng.submit(Request("ABCB"[i % 4], t.to(device), 0.0, 60.0 + i * 1e-3, meta=i))
    originals["B"] = on(new_b)
    regs = [RegisteredModel(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in zoo]
    out = eng.revert(DriftMonitor(store, originals, regs), DriftReport({}, {"B"}, set()))
    assert out["epoch_bumps"] == 1 and out["pending_requests"] == len(tokens)
    ops.reset_kernel_launches()
    stats = eng.serve(horizon_s=120.0, warmup=tokens[0].to(device))
    assert stats["completed"] == len(tokens) and eng.skipped == 0
    return ({c.request.meta: c.result.float().cpu() for c in eng.completions
             if c.request.instance_id == "B"}, ops.kernel_launches())


@pytest.mark.gpu
def test_engine_revert_serves_the_new_original_within_the_bf16_allowance(cuda_device):
    """The engine's ``revert`` on a merged bf16 dense trio on the card: the
    reverted member's served rows against float32 rows of the same (bf16
    valued) weights on the CPU, to twice the gap the CPU's own bf16 serve
    shows against them, at the largest element and in RMS — the allowance
    of the bf16 ``EdgeExecutor`` test above.  The gaps are printed (``-s``)."""
    import dataclasses

    from repro_torch.models.registry import get_adapter
    from repro_torch.models.transformer import DenseLMConfig
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    adapter = get_adapter("dense")
    cfg = DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                        norm="layernorm", dtype="bfloat16")
    cpu = torch.device("cpu")
    zoo = {m: adapter.init(cfg, seed=i, device=cpu) for i, m in enumerate("ABC")}
    new_b = adapter.init(cfg, seed=9, device=cpu)

    def f32(p):
        return unflatten_paths({k: v.float() for k, v in flatten_paths(p).items()})

    g = torch.Generator().manual_seed(6)
    tokens = [torch.randint(0, cfg.vocab_size, (1, 16), generator=g) for _ in range(8)]
    card, launches = _reverted_serve_rows(adapter, cfg, zoo, new_b, cuda_device, tokens)
    host, host_launches = _reverted_serve_rows(adapter, cfg, zoo, new_b, cpu, tokens)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        want = {i: adapter.forward(cfg32, f32(new_b), tokens[i])[0] for i in card}
    assert launches["flash_attention"] > 0 and not any(host_launches.values())
    assert sorted(card) == sorted(host) == [i for i in range(len(tokens)) if i % 2 == 1]

    def gap(rows):
        d = torch.stack([rows[i] - want[i] for i in sorted(want)])
        return d.abs().max().item(), d.pow(2).mean().sqrt().item()

    card_gap, host_gap = gap(card), gap(host)
    print(f"reverted bf16 serve, max and RMS gap to float32: card {card_gap}, cpu {host_gap}")
    assert card_gap[0] <= 2 * host_gap[0] and card_gap[1] <= 2 * host_gap[1], (card_gap, host_gap)


# ---------------------------------------------------------------------------
# CUDA graphs of the decode steps (serving.graphs): a graphed run against the
# same steps run eagerly (the modules' StepGraphs replaced by None, which is
# what they use on the CPU)
# ---------------------------------------------------------------------------


def _graph_cfg():
    from repro_torch.models.transformer import DenseLMConfig

    return DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                         norm="layernorm", dtype="bfloat16")


def _stream(device, monkeypatch, eager: bool, swap_at=None):
    """A merged pair (A, B) and a singleton C, or all three unmerged with
    the plan merging A and B applied (``apply_plan``) after step
    ``swap_at``, streamed with chunked prefill and recorded logits; with
    ``eager`` the decoder runs its step bodies without graphs.  Returns
    (stats, completions, launches, routes, decoder)."""
    from repro_torch.core import MergePlan, ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.serving import decode as decode_mod
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.decode import DecodeRequest
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
    from repro_torch.serving.workload import instances_from_store

    adapter, cfg, mids = get_adapter("dense"), _graph_cfg(), ("A", "B", "C")
    zoo = {m: adapter.init(cfg, seed=i, device=device) for i, m in enumerate(mids)}
    trunk = adapter.split(cfg).prefix_paths
    cloud = ParamStore.from_models(dict(zoo))
    groups = enumerate_groups([r for m in ("A", "B") for r in adapter.records(cfg, zoo[m], m)
                               if r.path in trunk])
    for g in groups:
        cloud.merge_group(g)
    plan = MergePlan.from_json(cloud.export_plan(groups, include_weights=True).to_json())
    store = cloud if swap_at is None else ParamStore.from_models(dict(zoo))
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=(1, 2, 4), simulate_dma=False)
    g = torch.Generator().manual_seed(7)
    reqs = [DecodeRequest(m, torch.randint(0, cfg.vocab_size, (9,), generator=g).numpy(),
                          max_new_tokens=6) for _ in range(2) for m in mids]

    def on_step(dec, step):
        if step == swap_at:
            assert eng.apply_plan(plan)["epoch_bumps"] == 1

    if eager:
        monkeypatch.setattr(decode_mod, "StepGraphs", lambda device: None)
    ops.reset_kernel_launches()
    stats = eng.serve_decode(reqs, page_size=4, num_pages=32, max_slots=6, max_len=16,
                             record_logits=True, chunked_prefill=True, on_step=on_step)
    monkeypatch.undo()
    return stats, eng.last_decoder.completions, ops.kernel_launches(), \
        ops.route_launches(), eng.last_decoder


def _same_completions(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.request.instance_id == y.request.instance_id and x.tokens == y.tokens
        assert len(x.logits) == len(y.logits) == len(x.tokens)
        for rx, ry in zip(x.logits, y.logits):
            assert torch.equal(torch.from_numpy(rx), torch.from_numpy(ry))


@pytest.mark.gpu
def test_graphed_streaming_decode_is_bitwise_its_eager_steps(cuda_device, monkeypatch):
    """The banked pair and the singleton replay captured graphs (every
    shape captured in the warm-up); tokens, logits, stats and kernel
    launches (by route too) equal those of the same steps run eagerly."""
    stats, comps, launches, routes, dec = _stream(cuda_device, monkeypatch, eager=False)
    estats, ecomps, elaunches, eroutes, edec = _stream(cuda_device, monkeypatch, eager=True)
    assert edec.graphs is None and dec.graphs.replays > 0
    assert dec.graphs.replays == (stats["trunk_dispatches"] + stats["singleton_dispatches"]
                                  + stats["prefill_chunk_dispatches"])
    assert dec.trunk_passes == edec.trunk_passes
    assert {k: v for k, v in stats.items() if k not in ("elapsed_s", "tokens_per_s")} == \
        {k: v for k, v in estats.items() if k not in ("elapsed_s", "tokens_per_s")}
    assert stats["bank_dispatches"] == stats["group_steps"] > 0
    assert launches == elaunches and routes == eroutes
    assert launches["decode_attention"] > 0 and launches["bank_matmul"] > 0
    _same_completions(comps, ecomps)


@pytest.mark.gpu
def test_graphs_are_captured_again_after_a_mid_stream_plan(cuda_device, monkeypatch):
    """Three singletons; the plan merging A and B applied after step 3: the
    epoch move drops the graphs, the merged pair's banked step is captured
    (once per bucket it meets) under the new epoch, and every row equals
    the eager run's, which reads the new bindings each step."""
    stats, comps, launches, _, dec = _stream(cuda_device, monkeypatch, eager=False, swap_at=3)
    estats, ecomps, elaunches, _, _ = _stream(cuda_device, monkeypatch, eager=True, swap_at=3)
    assert stats["epoch_bumps"] == estats["epoch_bumps"] == 1
    assert stats["bank_dispatches"] == estats["bank_dispatches"] > 0
    keys = [k for k, _ in dec.graphs.items()]
    assert keys and all(k[-1] == dec.store.epoch for k in keys)
    assert any(k[:2] == ("trunk", "bank") for k in keys)
    assert dec.graphs.captures > len(keys)  # the first epoch's graphs were dropped
    assert launches == elaunches
    _same_completions(comps, ecomps)


@pytest.mark.gpu
def test_graphed_edge_decode_is_bitwise_its_eager_steps(cuda_device, monkeypatch):
    """``EdgeExecutor.serve_decode`` replays one graph per (model, step
    length) on one zeroed cache, the warm-up capturing every prompt length
    a model meets (two for A and B): each replay's logits equal the same
    request's steps run eagerly on a fresh cache, bitwise; tokens and
    kernel launches equal the eager lane's."""
    from repro_torch.core import ParamStore
    from repro_torch.models.registry import get_adapter
    from repro_torch.serving import executor as executor_mod
    from repro_torch.serving import graphs as graphs_mod
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.decode import DecodeRequest
    from repro_torch.serving.executor import EdgeExecutor, ModelProgram
    from repro_torch.serving.workload import instances_from_store

    adapter, cfg, mids = get_adapter("dense"), _graph_cfg(), ("A", "B", "C")
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device=cuda_device)
                                    for i, m in enumerate(mids)})
    g = torch.Generator().manual_seed(5)
    reqs = [DecodeRequest(mids[i % 3], torch.randint(0, cfg.vocab_size, ((9, 7)[i % 2],),
                                                     generator=g).numpy(), max_new_tokens=5,
                          deadline_s=10.0 + i) for i in range(5)]
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids]
    recorded = []
    replay = graphs_mod.StepGraphs.replay

    def recording_replay(self, *a, **kw):
        out = replay(self, *a, **kw)
        recorded.append(out.clone())
        return out

    def lane(eager):
        ex = EdgeExecutor(store, instances_from_store(store, "tiny-yolo"),
                          {m: adapter.bound_forward(cfg) for m in mids}, capacity_bytes=10 ** 9,
                          costs={"tiny-yolo": costs_for("tiny-yolo")}, simulate_dma=False)
        if eager:
            monkeypatch.setattr(executor_mod, "StepGraphs", lambda device: None)
        else:
            monkeypatch.setattr(graphs_mod.StepGraphs, "replay", recording_replay)
        ops.reset_kernel_launches()
        stats = ex.serve_decode(reqs, programs, max_len=16)
        monkeypatch.undo()
        return ex, stats, ops.kernel_launches()

    ex, stats, launches = lane(eager=False)
    eex, estats, elaunches = lane(eager=True)
    assert eex.decode_graphs is None and ex.decode_graphs.replays == stats["steps"] == 25
    # per model its prompt lengths and the token step: A 9, 7, 1; B 7, 9, 1; C 9, 1
    assert ex.decode_graphs.captures == 8
    assert launches == elaunches and launches["decode_attention"] > 0
    assert [c.tokens for c in ex.decode_completions] == [c.tokens for c in eex.decode_completions]
    step = adapter.decode_split(cfg).step_unpaged
    i = 0
    for c in ex.decode_completions:
        params = store.materialize_cached(c.request.instance_id)
        cache = adapter.decode_split(cfg).init_cache(1, 16, device=cuda_device)
        for toks in [list(c.request.prompt)] + [[t] for t in c.tokens[:-1]]:
            want, cache = step(params, cache, torch.tensor([toks], dtype=torch.int32,
                                                           device=cuda_device))
            assert torch.equal(recorded[i], want)
            i += 1
    assert i == len(recorded)


@pytest.mark.gpu
def test_unpaged_cache_length_lives_on_the_device(cuda_device):
    """The dense and griffin unpaged caches keep ``length`` as a 0-d int32
    tensor on the card, advanced in place, so a captured step reads it
    there."""
    from repro_torch.models import griffin, transformer
    from repro_torch.models.griffin import GriffinConfig

    gcfg = GriffinConfig(name="gpu-griffin", n_layers=3, d_model=128, d_rnn=128, n_heads=4,
                         n_kv_heads=1, head_dim=64, d_ff=256, vocab_size=300, window=8,
                         tie_embeddings=True, dtype="float32")
    for mod, cfg in ((transformer, _graph_cfg()), (griffin, gcfg)):
        params = mod.init(cfg, 0, cuda_device)
        cache = mod.init_cache(cfg, 2, 16, device=cuda_device)
        length = cache["length"]
        assert length.is_cuda and length.dtype == torch.int32 and length.dim() == 0
        _, cache = mod.decode_step(cfg, params, cache, torch.zeros((2, 3), dtype=torch.int32,
                                                                    device=cuda_device))
        _, cache = mod.decode_step(cfg, params, cache, torch.zeros((2, 1), dtype=torch.int32,
                                                                    device=cuda_device))
        assert cache["length"] is length and int(length) == 4


@pytest.mark.gpu
def test_a_step_that_cannot_be_captured_raises(cuda_device, monkeypatch):
    """A trunk step that reads a value back to the host runs eagerly (the
    warm-up) but cannot be captured: the decoder raises instead of serving
    the step eagerly.  (Last in this file: a failed capture is left to the
    CUDA runtime to clean up.)"""
    import dataclasses

    from repro_torch.models.registry import get_adapter
    from repro_torch.serving.decode import DecodeRequest

    adapter, cfg = get_adapter("dense"), _graph_cfg()
    _, eng = _merged_engine("dense", cfg, ("A", "B"), cuda_device, (1, 2))
    ds = adapter.decode_split(cfg)

    def host_reading_trunk(params, pool, tables, lengths, tokens):
        tokens.sum().item()
        return ds.trunk_step(params, pool, tables, lengths, tokens)

    bad = dataclasses.replace(ds, trunk_step=host_reading_trunk)
    for p in eng.programs.values():
        p.decode = bad
    reqs = [DecodeRequest(m, torch.randint(0, cfg.vocab_size, (3,)).numpy(), max_new_tokens=2)
            for m in ("A", "B")]
    with pytest.raises(RuntimeError):
        eng.serve_decode(reqs, page_size=4, num_pages=8, max_slots=2, max_len=8)
    assert eng.last_decoder.completions == [] and eng.last_decoder.graphs.replays == 0


@pytest.mark.gpu
def test_plan_wire_lane_on_the_card(cuda_device):
    """fig14's plan-wire lane on a small float32 dense config (head dim 64,
    which the flash kernel compiles) on the card: lm-C bitwise across the
    delta_q8 apply, the quantized members within the drift monitor's
    threshold, both entry kinds present, the changed buffers shipped as
    int8 residuals, and the forwards through the flash kernel.  The zoo is
    drawn on the CPU and moved, so the scenario (which columns lm-C binds)
    is the one the CPU draws."""
    import dataclasses

    from repro_torch.bench import fig14_bandwidth as F14B
    from repro_torch.bench import lm_merging as LMB
    from repro_torch.models.transformer import DenseLMConfig
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    cfg = DenseLMConfig(name="gpu-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=256, vocab_size=300, rotary_pct=0.25,
                        norm="layernorm", dtype="float32")
    scn = LMB.numpy_scenario(cfg, "cpu")

    def move(tree):
        return unflatten_paths({p: t.to(cuda_device) for p, t in flatten_paths(tree).items()})

    scn = dataclasses.replace(scn, zoo={m: move(p) for m, p in scn.zoo.items()},
                              calibration=move(scn.calibration))
    before = ops.kernel_launches()["flash_attention"]
    rows, derived, _ = F14B.plan_wire(scn, F14B.numpy_batch(cfg, cuda_device))
    assert derived["unchanged_bitwise"] and derived["quant_within_drift"], derived
    assert derived["changed_keys"] > 0 and derived["unchanged_keys"] > 0, derived
    assert [r["lane"] for r in rows] == ["full", "delta", "delta_q8"]
    assert rows[2]["n_delta_q8"] == derived["changed_keys"], rows
    assert ops.kernel_launches()["flash_attention"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_head_dim_16_and_olmo_heads(cuda_device, dtype):
    """flash_attention (causal and windowed) and decode_attention at the
    tiny LM configs' head dim 16, and at olmo / olmoe's 16 heads of 128,
    against their plain versions."""
    rnd = _rnd(cuda_device, dtype, 40)
    for B, S, Hq, Hkv, D, window in [(2, 70, 2, 2, 16, None), (3, 40, 4, 1, 16, 8),
                                     (2, 128, 16, 16, 128, None)]:
        q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        before = ops.kernel_launches()["flash_attention"]
        out = ops.flash_attention(q, k, v, window=window)
        assert ops.kernel_launches()["flash_attention"] == before + 1
        assert kflash.route(q) == ("mma" if dtype == "bfloat16" else "simt")
        torch.testing.assert_close(out.float(), tref.flash_attention_ref(
            q, k, v, window=window).float(), **TOL[dtype])
    for B, Smax, Hq, Hkv, D in [(3, 16, 2, 2, 16), (2, 300, 4, 2, 16), (8, 128, 16, 16, 128)]:
        q, k, v = rnd(B, Hq, D), rnd(B, Smax, Hkv, D), rnd(B, Smax, Hkv, D)
        lens = torch.tensor([Smax - 3 * b for b in range(B)][:-1] + [0], dtype=torch.int32,
                            device=cuda_device)
        out = ops.decode_attention(q, k, v, lens)
        assert torch.equal(out[-1], torch.zeros_like(out[-1]))
        torch.testing.assert_close(out.float(), tref.decode_attention_ref(
            q, k, v, lens).float(), **TOL[dtype])


def _moe_cfg(dtype):
    from repro_torch.models.moe import MoELMConfig

    return MoELMConfig(name="gpu-moe", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       head_dim=64, vocab_size=300, n_experts=8, top_k=2,
                       d_ff_expert=64, group_size=64, qk_norm=True, dtype=dtype)


@pytest.mark.gpu
def test_moe_forward_on_the_card_matches_the_cpu(cuda_device):
    """The moe trunk (flash attention at head dim 64, routed expert GEMMs
    with float32 gate and up sums) on the card against the same params'
    forward on the CPU, float32; the routing decisions equal."""
    from repro_torch.models import moe
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    cfg = _moe_cfg("float32")
    cpu = moe.init(cfg, seed=0, device="cpu")
    card = unflatten_paths({p: t.to(cuda_device) for p, t in flatten_paths(cpu).items()})
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    before = ops.kernel_launches()["flash_attention"]
    got, aux = moe.forward(cfg, card, toks.to(cuda_device))
    want, aux_cpu = moe.forward(cfg, cpu, toks)
    assert ops.kernel_launches()["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, **TOL["float32"])
    torch.testing.assert_close(aux.cpu(), aux_cpu, **TOL["float32"])
    x = torch.randn((1, 64, cfg.d_model), generator=torch.Generator().manual_seed(2))
    w = cpu["blocks"]["0"]["moe"]["router"]["w"]
    d_cpu, _, _ = moe.route(cfg, w, x)
    d_card, _, _ = moe.route(cfg, w.to(cuda_device), x.to(cuda_device))
    assert torch.equal(d_card.cpu(), d_cpu)


@pytest.mark.gpu
def test_moe_paged_decode_step_on_the_card(cuda_device):
    """One paged decode step of a bf16 moe (page_gather, decode_attention,
    per-token routing) against its unpaged twin on the card, and the pool
    written in place."""
    import dataclasses

    from repro_torch.models import moe

    cfg = dataclasses.replace(_moe_cfg("bfloat16"), group_size=1)
    params = moe.init(cfg, seed=3, device=cuda_device)
    page, maxp, B = 4, 3, 2
    pool = moe.init_kv_pool(cfg, 8, page, device=cuda_device)
    cache = moe.init_cache(cfg, B, page * maxp, device=cuda_device)
    tables = torch.tensor([[0, 1, 2], [5, 6, 7]], dtype=torch.int32, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (B, 5), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(4))
    before = ops.kernel_launches()
    for t in range(5):
        lengths = torch.full((B,), t, dtype=torch.int32, device=cuda_device)
        lp, new = moe.paged_decode_step(cfg, params, pool, tables, lengths, toks[:, t])
        lu, cache = moe.decode_step(cfg, params, cache, toks[:, t:t + 1])
        assert new["k"] is pool["k"]
        torch.testing.assert_close(lp.float(), lu.float(), **TOL["bfloat16"])
    after = ops.kernel_launches()
    assert after["page_gather"] - before["page_gather"] == 2 * 5 * cfg.n_layers
    assert after["decode_attention"] - before["decode_attention"] == 2 * 5 * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("bench", ["lm_merging", "decode_serve", "fig14_bandwidth"])
def test_lm_bench_defaults_run_on_the_card(cuda_device, bench, tmp_path, monkeypatch):
    """The LM benches at their defaults (the dense adapter's tiny config,
    head dim 16) on the card: they run and meet their structural gates."""
    import importlib

    from repro_torch.bench import common

    monkeypatch.setattr(common, "ARTIFACTS", str(tmp_path))
    mod = importlib.import_module(f"repro_torch.bench.{bench}")
    before = ops.kernel_launches()["flash_attention"]
    if bench == "fig14_bandwidth":
        out = mod.run_plan_wire(device=cuda_device)
        assert out["derived"]["unchanged_bitwise"] and out["derived"]["quant_within_drift"]
    elif bench == "decode_serve":  # its structural gates (smoke=True leaves out the timed one)
        out = mod.run(device=cuda_device)
        assert all(mod.gates(out["derived"], smoke=True).values()), out["derived"]
    else:
        out = mod.run(device=cuda_device)
        assert all(mod.gates(out["derived"]).values()), out["derived"]
    assert ops.kernel_launches()["flash_attention"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(40, 8), (64, 8)])
def test_flash_kernel_at_qwen_head_groups(cuda_device, dtype, Hq, Hkv):
    """qwen3-14b's 40 query heads on 8 kv heads (a group of 5) and
    qwen2-72b's 64 on 8, at head dim 128, causal, S = 128 and a ragged 75."""
    rnd = _rnd(cuda_device, dtype, 5)
    for S in (128, 75):
        q, k, v = rnd(2, S, Hq, 128), rnd(2, S, Hkv, 128), rnd(2, S, Hkv, 128)
        out = ops.flash_attention(q, k, v)
        torch.testing.assert_close(out.float(), tref.flash_attention_ref(q, k, v).float(),
                                   **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_group_5_and_on_a_kv_repl_cache(cuda_device, dtype):
    """A group of 5 (qwen3-14b: 40 on 8) against the plain version, and
    qwen2-72b's cache of every kv head stored twice (64 query heads on 16
    stored, a group of 4) against the plain version on the cache without
    the copies (64 on 8): query head h reads stored head h // 4, a copy of
    kv head h // 8."""
    rnd = _rnd(cuda_device, dtype, 6)
    lens = torch.tensor([129, 136, 1], dtype=torch.int32, device=cuda_device)
    q, k, v = rnd(3, 40, 128), rnd(3, 136, 8, 128), rnd(3, 136, 8, 128)
    torch.testing.assert_close(ops.decode_attention(q, k, v, lens).float(),
                               tref.decode_attention_ref(q, k, v, lens).float(), **TOL[dtype])
    q = rnd(3, 64, 128)
    kr, vr = (t.repeat_interleave(2, dim=2).contiguous() for t in (k, v))
    before = ops.kernel_launches()["decode_attention"]
    out = ops.decode_attention(q, kr, vr, lens)
    assert ops.kernel_launches()["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(), tref.decode_attention_ref(q, k, v, lens).float(),
                               **TOL[dtype])


@pytest.mark.gpu
def test_vlm_prefill_and_decode_on_the_card(cuda_device):
    """A tiny-width vlm (head dim 16, 4 query heads on 2 kv heads, a cache
    of each kv head stored twice) in float32: forward, prefill and two
    decode steps on the card against the same calls on the CPU (the plain
    versions), with flash_attention launched by the forward and the
    prefill and decode_attention by the steps."""
    from repro_torch.models import vlm
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    cfg = vlm.VLMConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                        d_ff=128, vocab_size=512, n_patches=8, kv_repl=2)
    cpu = torch.device("cpu")
    params = vlm.init(cfg, 0, cpu)
    gen = torch.Generator(device=cpu).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    patches = torch.randn((2, cfg.n_patches, cfg.d_model), generator=gen)
    dev = {k: v.to(cuda_device) for k, v in flatten_paths(params).items()}
    dparams = unflatten_paths(dev)
    before = ops.kernel_launches()
    got = vlm.forward(cfg, dparams, toks.to(cuda_device), patches.to(cuda_device))
    torch.testing.assert_close(got.cpu(), vlm.forward(cfg, params, toks, patches),
                               **TOL["float32"])
    assert ops.kernel_launches()["flash_attention"] - before["flash_attention"] == cfg.n_layers
    max_len = cfg.n_patches + 12
    lc, cc = vlm.prefill(cfg, params, toks[:, :10], patches, max_len)
    lg, cg = vlm.prefill(cfg, dparams, toks[:, :10].to(cuda_device), patches.to(cuda_device),
                         max_len)
    torch.testing.assert_close(lg.cpu(), lc, **TOL["float32"])
    assert ops.kernel_launches()["flash_attention"] - before["flash_attention"] == \
        2 * cfg.n_layers
    for t in (10, 11):
        lc, cc = vlm.decode_step(cfg, params, cc, toks[:, t:t + 1])
        lg, cg = vlm.decode_step(cfg, dparams, cg, toks[:, t:t + 1].to(cuda_device))
        torch.testing.assert_close(lg.cpu(), lc, **TOL["float32"])
    assert int(cg["length"]) == cfg.n_patches + 12
    after = ops.kernel_launches()
    assert after["decode_attention"] - before["decode_attention"] == 2 * cfg.n_layers


@pytest.mark.gpu
def test_shard_local_bank_matmul_is_bitwise_the_unsharded_one(cuda_device):
    """The stablelm-1.6b head's bank (N = 4 members, K = 2048, F = 100352,
    bf16) split over the 4 shards of a (2, 4) mesh of the card: four
    launches at one member each give the bits of the one launch at four."""
    from repro_torch.distributed.partitioning import MeshPlacement
    from repro_torch.distributed.sharding import LogicalRules, make_mesh, shard_bank_fn

    rnd = _rnd(cuda_device, "bfloat16", 31)
    x, scale, w = rnd(8, 2048), rnd(4, 2048), rnd(4, 2048, 100352)

    def head(b, feats):  # bank_head's shape: a per-member scale, then one GEMM
        return ops.bank_matmul(feats[None] * b["s"][:, None], b["w"])

    mesh = make_mesh((2, 4), ("data", "model"), cuda_device)
    placement = MeshPlacement(LogicalRules(mesh, {}))
    bank = {"w": placement.place_bank(w), "s": placement.place_bank(scale)}
    assert [t.shape[0] for t in bank["w"].shards] == [1] * 4
    before = dict(ops.route_launches()["bank_matmul"])
    whole = head({"w": w, "s": scale}, x)
    mid = dict(ops.route_launches()["bank_matmul"])
    got = shard_bank_fn(head, mesh, "model")(bank, x)
    after = ops.route_launches()["bank_matmul"]
    assert mid["wgmma"] - before["wgmma"] == 1 and after["wgmma"] - mid["wgmma"] == 4
    assert torch.equal(got, whole)


@pytest.mark.gpu
def test_sharded_decode_of_a_bf16_group_is_bitwise_its_unsharded_decode(cuda_device, tmp_path,
                                                                        monkeypatch):
    """``bench.shard_serve`` on the dense adapter's tiny config in bf16, the
    merged four-member group, on a (2, 4) mesh of the card: tokens and
    logits bitwise, every gate, and
    ``bank_matmul`` launched ``n_shards`` times for each launch the
    unsharded lane makes (graph replays included)."""
    import dataclasses

    from repro_torch.bench import common
    from repro_torch.bench import lm_merging as LMB
    from repro_torch.bench import shard_serve as SSB

    monkeypatch.setattr(common, "ARTIFACTS", str(tmp_path))
    cfg = dataclasses.replace(LMB.get_adapter("dense").default_config(), dtype="bfloat16")
    scn = LMB.numpy_scenario(cfg, cuda_device)
    # the merged group alone: a foreign lm-C drawn on the card may merge too,
    # and a bank of five would not divide over four shards
    scn = dataclasses.replace(scn, zoo={m: scn.zoo[m] for m in ("lm-A", "lm-B", "lm-D", "lm-E")})
    launches = {}
    last = [ops.kernel_launches()["bank_matmul"]]

    def on_lane(name, eng, stats):
        now = ops.kernel_launches()["bank_matmul"]
        launches[name] = (now - last[0], stats["bank_dispatches"],
                          eng.last_decoder.graphs.replays)
        last[0] = now

    with torch.no_grad():
        out = SSB.run(scn, on_lane=on_lane)
    d = out["derived"]
    assert all(SSB.gates(d).values()), d
    assert d["bitwise"] and d["max_logit_diff"] == 0.0, d
    (plain, plain_dispatches, plain_replays) = launches["unsharded"]
    (sharded, dispatches, replays) = launches["sharded"]
    assert dispatches == plain_dispatches > 0 and replays > 0 and plain_replays > 0
    assert plain > 0 and sharded == SSB.mesh_placement(cuda_device).n_shards * plain


@pytest.mark.gpu
def test_bf16_cuda_state_round_trips_through_the_checkpoint_bitwise(cuda_device, tmp_path):
    """A bf16 train state on the card (params, float32 moments and error
    feedback) saved and restored onto the card: every leaf bitwise, bf16
    written as its uint16 bits."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import init_state
    from repro_torch.utils.tree import flatten_paths

    rnd = _rnd(cuda_device, "bfloat16", 41)
    params = {"embed": {"table": rnd(512, 64)}, "blocks": [{"w": rnd(64, 64)}, {"w": rnd(64, 8)}]}
    state = init_state(params, AdamW(), compress_grads=True)
    state["err"] = {k: torch.randn_like(v) for k, v in state["err"].items()}
    state["step"] = 11
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=11)
    got = mgr.restore_latest(device=cuda_device)
    assert got["step"] == 11 and got["opt"].step == 0
    for a, b in [(state["params"], got["params"]), (state["err"], got["err"]),
                 (state["opt"].mu, got["opt"].mu)]:
        fa, fb = flatten_paths(a), flatten_paths(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fb[k].is_cuda and fb[k].dtype == fa[k].dtype
            assert torch.equal(fa[k].view(torch.int16) if fa[k].dtype == torch.bfloat16
                               else fa[k], fb[k].view(torch.int16)
                               if fb[k].dtype == torch.bfloat16 else fb[k]), k


@pytest.mark.gpu
def test_trainer_on_a_dense_loss_raises_on_the_card(cuda_device):
    """The dense trunk's attention is the CUDA kernel, which has no
    backward: the first step raises, and nothing falls back."""
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.data.synthetic import LMStream
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer

    cfg = stablelm_1_6b.smoke_config()
    params = transformer.init(cfg, seed=0, device=cuda_device)
    tr = Trainer(lambda p, b: transformer.loss_fn(cfg, p, b), AdamW())
    before = ops.kernel_launches()["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        tr.fit(params, iter(LMStream(cfg.vocab_size, 2, 16, device=cuda_device)), 2)
    assert ops.kernel_launches()["flash_attention"] == before


@pytest.mark.gpu
def test_encdec_trainer_resumes_bitwise_on_the_card(cuda_device, tmp_path):
    """seamless-m4t-medium's smoke config in bf16 (its loss calls no
    kernel): 4 steps straight equal 2 steps, a checkpoint and a fresh
    Trainer resuming to 4, bitwise, with microbatches and int8 feedback."""
    import dataclasses
    import itertools

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import seamless_m4t_medium
    from repro_torch.launch.train import batches
    from repro_torch.models import encdec
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import flatten_paths

    cfg = dataclasses.replace(seamless_m4t_medium.smoke_config(), dtype="bfloat16")

    def fit(steps, start, mgr=None):
        data = itertools.islice(batches(cfg, "encdec", 4, 32, cuda_device), start, None)
        tr = Trainer(lambda p, b: encdec.loss_fn(cfg, p, b),
                     AdamW(lr=warmup_cosine(1e-3, 2, 4)), microbatches=2, compress_grads=True,
                     ckpt_manager=mgr, ckpt_every=2)
        return tr.fit(encdec.init(cfg, seed=0, device=cuda_device), data, steps, log_every=1)

    straight = fit(4, 0)
    fit(2, 0, CheckpointManager(str(tmp_path)))
    resumed = fit(4, 2, CheckpointManager(str(tmp_path)))
    assert resumed["history"] == straight["history"][2:]
    for tree in ("params", "err"):
        a, b = flatten_paths(straight["state"][tree]), flatten_paths(resumed["state"][tree])
        assert all(torch.equal(a[k], b[k]) for k in a), tree
    assert all(torch.equal(straight["state"]["opt"].nu[k], v)
               for k, v in resumed["state"]["opt"].nu.items())


def _op_args(device):
    """Arguments of each op at small shapes (bf16 where the kernel takes it)."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, dt=torch.bfloat16):
        t = torch.randn(shape, generator=g).to(dt)
        return t.to(device) if device != "meta" else torch.empty(shape, dtype=dt, device="meta")

    lens = torch.tensor([40, 1, 17, 0], dtype=torch.int32)
    table = torch.tensor([3, 0, 3, 7], dtype=torch.int32)
    f32 = torch.float32
    return {
        "flash_attention": ((rnd(2, 40, 4, 64), rnd(2, 40, 2, 64), rnd(2, 40, 2, 64)), {}),
        "decode_attention": ((rnd(4, 4, 64), rnd(4, 48, 2, 64), rnd(4, 48, 2, 64),
                              lens.to(device) if device != "meta" else
                              torch.empty(4, dtype=torch.int32, device="meta")), {}),
        "page_gather": ((rnd(8, 256), table.to(device) if device != "meta" else
                         torch.empty(4, dtype=torch.int32, device="meta")), {}),
        "bank_matmul": ((rnd(3, 16, 64), rnd(3, 64, 128)), {}),
        "mamba_scan": ((rnd(2, 5, 64, dt=f32).abs(), rnd(2, 5, 64, dt=f32), rnd(2, 5, 16, dt=f32),
                        rnd(2, 5, 16, dt=f32), -rnd(64, 16, dt=f32).abs(),
                        rnd(2, 64, 16, dt=f32)), {}),
        "rg_lru_scan": ((rnd(2, 5, 64, dt=f32).sigmoid(), rnd(2, 5, 64, dt=f32),
                         rnd(2, 64, dt=f32)), {}),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ops.OP_TABLE))
def test_meta_call_gives_the_kernels_output_shapes(cuda_device, name):
    """An op on meta tensors (the plain version, shapes only) and the same op
    on the card (the kernel) give outputs of one shape and dtype; the meta
    call launches nothing."""
    spec = ops.OP_TABLE[name]
    ops.reset_kernel_launches()
    margs, mkw = _op_args("meta")[name]
    meta = spec.dispatch(*margs, **mkw)
    assert ops.kernel_launches()[name] == 0
    cargs, ckw = _op_args(cuda_device)[name]
    with torch.no_grad():
        card = spec.dispatch(*cargs, **ckw)
    torch.cuda.synchronize()
    assert ops.kernel_launches()[name] == 1
    meta, card = (meta, card) if isinstance(meta, tuple) else ((meta,), (card,))
    assert [(t.shape, t.dtype) for t in meta] == [(t.shape, t.dtype) for t in card]
    assert all(t.device.type == "meta" for t in meta)


@pytest.mark.gpu
def test_cloud_edge_plan_example_serves_through_the_bank_on_the_card(cuda_device):
    """``examples/cloud_edge_plan.py``'s port on the card: one epoch bump,
    9 queued requests kept and served, rows against the direct forward,
    the private heads through ``bank_matmul`` (float32: the simt route)."""
    from repro_torch.examples import cloud_edge_plan as ex

    ops.reset_kernel_launches()
    out = ex.main(["--device", "cuda"])
    edge = out["edge"]
    assert (edge["epoch_bumps"], edge["pending_requests"]) == (1, 9)
    assert edge["stats"]["completed"] == 9
    assert edge["resident_bytes_after"] < edge["resident_bytes_before"]
    launches, routes = ops.kernel_launches(), ops.route_launches()
    assert launches["bank_matmul"] > 0 and routes["bank_matmul"]["wgmma"] == 0
    cfg, store = ex.CFG, edge["store"]
    for c in edge["engine"].completions:
        want = ex.ADAPTER.forward(cfg, store.materialize(c.request.instance_id),
                                  c.request.payload)[0]
        torch.testing.assert_close(c.result.float(), want.float(), rtol=1e-5, atol=1e-5)
