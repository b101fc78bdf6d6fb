"""The port's kernel layer against the JAX package: the plain PyTorch
versions against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode, and the device dispatch and its counters.  The Hopper
kernels themselves are tested on a card by tests/test_torch_gpu.py.

Tolerances:
  * port plain version vs JAX plain version, float32: 1e-5 — the same
    float32 arithmetic, reduced in a different order by XLA and PyTorch;
  * anything in bfloat16, and anything against a Pallas kernel: the JAX
    package's own kernel-test tolerances (tests/test_kernels.py TOL,
    2e-3 float32 / 2e-2 bfloat16) — a bf16 output may round to the
    neighbouring value, and the Pallas attention casts probabilities to
    the value dtype before P @ V;
  * the scans widen bf16 inputs to float32 before any arithmetic in both
    packages, so in either input dtype they are held at 1e-5 against the
    JAX plain version and at the float32 TOL against the Pallas kernel.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bank_matmul import bank_matmul as pallas_bank_matmul
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba
from repro.kernels.page_gather import page_gather as pallas_gather
from repro.kernels.rg_lru import rg_lru_scan as pallas_rg_lru
from repro_torch import bridge
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bank_matmul as kbank
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mamba_scan as kmamba
from repro_torch.kernels import page_gather as kgather
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as krglru

TIGHT = dict(rtol=1e-5, atol=1e-5)
TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, shapes, dtype):
    """The same numpy draws for both packages: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    tx = [bridge.array_to_tensor(np.asarray(a), torch.device("cpu")) for a in jx]
    return jx, tx


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, S, Hq, Hkv, D, causal, window
    (2, 64, 4, 4, 16, True, None),   # causal MHA
    (2, 64, 4, 4, 16, True, 8),      # sliding window
    (2, 64, 8, 2, 32, True, None),   # GQA 4:1
    (1, 32, 4, 1, 16, False, None),  # MQA, bidirectional
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", FLASH_CASES)
def test_flash_ref_matches_jax_ref_and_pallas(dtype, B, S, Hq, Hkv, D, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        S, [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = TIGHT if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# bank matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_bank_ref_matches_jax_ref_and_pallas(dtype, broadcast, bias):
    N, M, K, F = 3, 16, 64, 96
    shapes = [(M, K) if broadcast else (N, M, K), (N, K, F)] + ([(N, F)] if bias else [])
    jx, tx = _inputs(7, shapes, dtype)
    jb, tb = (jx[2], tx[2]) if bias else (None, None)
    got = tref.bank_matmul_ref(tx[0], tx[1], tb)
    assert got.dtype == torch.float32 and got.shape == (N, M, F)
    want = jref.bank_matmul_ref(jx[0], jx[1], jb)
    # float32 sums of exact products either way: tight in both dtypes
    np.testing.assert_allclose(_np(got), np.asarray(want), **TIGHT)
    pallas = pallas_bank_matmul(jx[0], jx[1], jb, block_m=8, block_k=32,
                                block_f=32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_bank_ref_ragged_shape_the_pallas_kernel_rejects(dtype, broadcast):
    N, M, K, F = 2, 130, 70, 200  # M and F are not multiples of the 128 block
    shapes = [(M, K) if broadcast else (N, M, K), (N, K, F), (N, F)]
    jx, tx = _inputs(11, shapes, dtype)
    with pytest.raises(AssertionError):
        pallas_bank_matmul(jx[0], jx[1], jx[2], interpret=True)
    got = tref.bank_matmul_ref(*tx)
    np.testing.assert_allclose(_np(got), np.asarray(jref.bank_matmul_ref(*jx)), **TIGHT)


def test_bank_ref_is_bitwise_per_member():
    """The plain version IS the per-member contraction (the CPU bank ==
    per-member serving contract)."""
    _, (x, w) = _inputs(3, [(3, 8, 32), (3, 32, 64)], "bfloat16")
    out = tref.bank_matmul_ref(x, w)
    for i in range(3):
        assert torch.equal(out[i], torch.matmul(x[i].float(), w[i].float()))


BANK_ROUTES = [  # case, x shape, w shape, dtype, route the wrapper must take
    ("stablelm-head", (3, 1024, 2048), (3, 2048, 100352), "bfloat16", "wgmma"),
    ("falcon-mamba-head", (3, 1024, 4096), (3, 4096, 65024), "bfloat16", "wgmma"),
    ("stablelm-decode", (3, 8, 2048), (3, 2048, 100352), "bfloat16", "wgmma"),
    ("falcon-mamba-decode", (3, 8, 4096), (3, 4096, 65024), "bfloat16", "wgmma"),
    ("broadcast-x", (1024, 2048), (3, 2048, 256), "bfloat16", "wgmma"),
    ("m1-k8-f8", (1, 1, 8), (1, 8, 8), "bfloat16", "wgmma"),
    ("stablelm-head-f32", (3, 1024, 2048), (3, 2048, 100352), "float32", "simt"),
    ("small_cnn-fc1", (8, 16), (2, 16, 64), "float32", "simt"),
    ("small_cnn-fc2", (2, 8, 64), (2, 64, 4), "float32", "simt"),
    ("f4-bf16", (2, 8, 64), (2, 64, 4), "bfloat16", "simt"),
    ("f33", (3, 100, 72), (3, 72, 33), "bfloat16", "simt"),
    ("k70", (3, 100, 70), (3, 70, 40), "bfloat16", "simt"),
]


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("case,xs,ws,dtype,want", BANK_ROUTES, ids=[c[0] for c in BANK_ROUTES])
def test_bank_route_is_a_function_of_dtype_and_shape(device, case, xs, ws, dtype, want):
    """bf16 with 16-byte rows (K and F multiples of 8) takes the tensor-core
    kernel, float32 and other shapes the CUDA-core one.  Full-size shapes
    only on meta tensors (no storage)."""
    if device == "cpu":  # the same residues mod 8, at most a few hundred wide
        xs, ws = (tuple(n if n <= 256 else 256 + n % 8 for n in s) for s in (xs, ws))
    dt = getattr(torch, dtype)
    x, w = torch.empty(xs, dtype=dt, device=device), torch.empty(ws, dtype=dt, device=device)
    assert kbank.route(x, w) == want


def test_bank_route_takes_simt_for_a_view_starting_mid_row():
    base = torch.zeros(3 * 16 * 64 + 1, dtype=torch.bfloat16)
    x = base[1:].view(3, 16, 64)  # contiguous, but 2 bytes past a 16-byte boundary
    w = torch.zeros((3, 64, 64), dtype=torch.bfloat16)
    assert x.is_contiguous() and kbank.route(x, w) == "simt"
    assert kbank.route(x.clone(), w) == "wgmma"


@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype,want", [("bfloat16", "mma"), ("float32", "simt")])
@pytest.mark.parametrize("Hq", [1, 16])
def test_flash_route_is_a_function_of_dtype_and_head_dim(D, dtype, want, Hq):
    dt = getattr(torch, dtype)
    q = torch.empty((8, 128, Hq, D), dtype=dt, device="meta")
    assert kflash.route(q) == want


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [  # B, Smax, Hq, Hkv, D, lengths (a 0 row must give exact zeros)
    (3, 64, 4, 4, 16, (64, 17, 0)),    # G = 1, full / ragged / empty rows
    (2, 64, 4, 2, 64, (1, 40)),        # G = 2
    (4, 96, 8, 2, 16, (96, 0, 33, 5)),  # G = 4, Smax = 3 tiles of 32
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,lengths", DECODE_CASES)
def test_decode_ref_matches_jax_ref_and_pallas(dtype, B, Smax, Hq, Hkv, D, lengths):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        Smax + D, [(B, Hq, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D)], dtype)
    lens = np.array(lengths, np.int32)
    got = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for b in np.flatnonzero(lens == 0):
        assert torch.equal(got[b], torch.zeros_like(got[b]))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    tol = TIGHT if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(lens), block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32), **tol)


@pytest.mark.parametrize("length", [0, 1, 127, 128, 129, 255, 256, 257, 1000, 4096])
def test_decode_row_chunks_cut_key_positions(length):
    """The kernel's chunks of a row: consecutive, CHUNK keys each but the
    last, starting at multiples of CHUNK and covering exactly the row."""
    T = kdecode.CHUNK
    chunks = kdecode.row_chunks(length)
    assert [s for s, _ in chunks] == list(range(0, length, T))
    assert all(0 < e - s <= T for s, e in chunks)
    assert all(e == s2 for (_, e), (s2, _) in zip(chunks, chunks[1:]))
    assert (chunks[-1][1] if chunks else 0) == length


def test_decode_chunk_plan_of_a_row_ignores_batch_smax_and_other_rows():
    """What a row's blocks take is its own length's cut, whether the row is
    alone (Smax its length rounded up to 16) or anywhere in a batch with
    other lengths and a larger Smax; lengths outside [0, Smax] are clamped
    as the kernel clamps them."""
    rng = np.random.default_rng(0)
    for length in [0, 1, 127, 128, 129, 300, 1000]:
        want = kdecode.row_chunks(length)
        alone = torch.tensor([length], dtype=torch.int32)
        assert kdecode.chunk_plan(alone, -(-length // 16) * 16) == [want]
        for Smax in (length, length + 1, 1000, 4096):
            if Smax < length:
                continue
            others = rng.integers(0, Smax + 1, size=7)
            for pos in (0, 3, 7):
                lens = torch.tensor(np.insert(others, pos, length), dtype=torch.int32)
                plan = kdecode.chunk_plan(lens, Smax)
                assert plan[pos] == want
                assert [len(p) for p in plan] == [len(kdecode.row_chunks(int(n)))
                                                  for n in lens]
    assert kdecode.chunk_plan(torch.tensor([500, -3], dtype=torch.int32), 300) == \
        [kdecode.row_chunks(300), []]
    assert [kdecode.grid_chunks(s) for s in (0, 1, 128, 129, 4096)] == [1, 1, 1, 2, 32]


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("B,Smax,Hq,Hkv,D,want", [
    (8, 128, 32, 32, 64, 0),                       # stablelm decode: one chunk a row
    (1, 0, 2, 1, 64, 0),                           # an empty cache
    (8, 129, 32, 32, 64, 8 * 32 * 2 * 1 * 66),     # one key past a chunk
    (4, 1000, 32, 8, 128, 4 * 8 * 8 * 4 * 130),    # gqa-len0
    (8, 4096, 32, 32, 64, 8 * 32 * 32 * 1 * 66),   # long-cache
    (2, 300, 32, 2, 64, 2 * 2 * 3 * 16 * 66),      # 16 query heads a kv head
])
def test_decode_workspace_is_sized_by_shapes_alone(device, B, Smax, Hq, Hkv, D, want):
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.empty((B, Hq, D), dtype=dtype, device=device)
        k = torch.empty((B, Smax, Hkv, D), dtype=dtype, device=device)
        assert kdecode.workspace_floats(q, k) == want


# ---------------------------------------------------------------------------
# page gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,W,N", [(12, 64, 20), (5, 1000, 3), (300, 24, 500)])
def test_page_gather_ref_is_bitwise_the_jax_ref_and_pallas(dtype, P, W, N):
    (jpool,), (tpool,) = _inputs(P + W, [(P, W)], dtype)
    table = np.random.default_rng(N).integers(0, P, N).astype(np.int32)
    got = tref.page_gather_ref(tpool, torch.from_numpy(table))
    assert got.dtype == tpool.dtype and got.shape == (N, W)
    for want in (jref.page_gather_ref(jpool, jnp.asarray(table)),
                 pallas_gather(jpool, jnp.asarray(table), interpret=True)):
        np.testing.assert_array_equal(bridge.tensor_to_array(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the scans: mamba_scan and rg_lru_scan
# ---------------------------------------------------------------------------

SCAN_CASES = [  # B, S, chunk of the Pallas kernel, zero h0
    (2, 16, 16, True),   # one exact chunk from a zero state
    (2, 13, 16, False),  # ragged S: the Pallas kernel gets identity padding
    (3, 1, 1, False),    # one decode step carrying a state
]


def _identity_pad(S, chunk, arrays, fills):
    """Pad the time axis up to a chunk multiple with identity steps, as the
    JAX models' ``_run_scan`` / ``_run_scan_diag`` do for the Pallas kernel."""
    pad = (-S) % chunk
    return [jnp.pad(a, [(0, 0), (0, pad), (0, 0)], constant_values=f)
            for a, f in zip(arrays, fills)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,chunk,zero_h0", SCAN_CASES)
def test_mamba_scan_ref_matches_jax_ref_and_pallas(dtype, B, S, chunk, zero_h0):
    di, n = 64, 8
    rng = np.random.default_rng(S + B)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    arrs = [dt] + [rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, di), (B, S, n), (B, S, n))]
    A = -np.exp(0.5 * rng.standard_normal((di, n))).astype(np.float32)
    h0 = (np.zeros if zero_h0 else rng.standard_normal)((B, di, n)).astype(np.float32)
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    tx = [bridge.array_to_tensor(np.asarray(a), torch.device("cpu")) for a in jx]
    ty, th = tref.mamba_scan_ref(*tx, torch.from_numpy(A), torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == (B, S, di) and th.shape == (B, di, n)
    jy, jh = jref.mamba_scan_ref(*jx, jnp.asarray(A), jnp.asarray(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TIGHT)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TIGHT)
    padded = _identity_pad(S, chunk, jx, (0.0,) * 4)  # dt = dtx = 0: exp(0) h + 0
    py, ph = pallas_mamba(*padded, jnp.asarray(A), jnp.asarray(h0), chunk=chunk,
                          block_di=di, interpret=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(py)[:, :S], **TOL["float32"])
    np.testing.assert_allclose(th.numpy(), np.asarray(ph), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,chunk,zero_h0", SCAN_CASES)
def test_rg_lru_ref_matches_jax_ref_and_pallas(dtype, B, S, chunk, zero_h0):
    d = 128
    rng = np.random.default_rng(S * B)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, d))))).astype(np.float32)
    b = rng.standard_normal((B, S, d)).astype(np.float32)
    h0 = (np.zeros if zero_h0 else rng.standard_normal)((B, d)).astype(np.float32)
    ja, jb = (jnp.asarray(x).astype(JDT[dtype]) for x in (a, b))
    ta, tb = (bridge.array_to_tensor(np.asarray(x), torch.device("cpu")) for x in (ja, jb))
    ty, th = tref.rg_lru_ref(ta, tb, torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == (B, S, d) and th.shape == (B, d)
    jy, jh = jref.rg_lru_ref(ja, jb, jnp.asarray(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TIGHT)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TIGHT)
    pa, pb = _identity_pad(S, chunk, (ja, jb), (1.0, 0.0))  # a = 1, b = 0
    py, ph = pallas_rg_lru(pa, pb, jnp.asarray(h0), chunk=chunk, block_d=d, interpret=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(py)[:, :S], **TOL["float32"])
    np.testing.assert_allclose(th.numpy(), np.asarray(ph), **TOL["float32"])


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,want", [(1, "step"), (2, "scan"), (13, "scan"), (128, "scan")])
def test_mamba_route_is_a_function_of_the_step_count(device, dtype, S, want):
    """A decode step (S = 1) takes the lane-spread "step" route, anything
    longer the "scan" route, for every batch, width and state dim."""
    for B, di in [(1, 8), (8, 8192), (3, 1000)]:
        assert kmamba.route(torch.empty((B, S, di), dtype=dtype, device=device)) == want


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_ops_dispatch_cpu_tensors_to_plain_versions_and_count():
    _, (q, k, v) = _inputs(0, [(1, 16, 2, 16)] * 3, "float32")
    _, (x, w, b) = _inputs(1, [(4, 8), (2, 8, 5), (2, 5)], "float32")
    lens = torch.tensor([16], dtype=torch.int32)
    table = torch.tensor([1, 0, 1], dtype=torch.int32)
    ops.reset_dispatch_counts()
    ops.reset_kernel_launches()
    assert torch.equal(ops.flash_attention(q, k, v), tref.flash_attention_ref(q, k, v))
    assert torch.equal(ops.flash_attention(q, k, v, window=4),
                       tref.flash_attention_ref(q, k, v, window=4))
    assert torch.equal(ops.bank_matmul(x, w, b), tref.bank_matmul_ref(x, w, b))
    assert torch.equal(ops.decode_attention(q[:, 0], k, v, lens),
                       tref.decode_attention_ref(q[:, 0], k, v, lens))
    assert torch.equal(ops.page_gather(x, table), tref.page_gather_ref(x, table))
    _, (dt, Bm, A, h) = _inputs(2, [(2, 3, 4), (2, 3, 8), (4, 8), (2, 4, 8)], "float32")
    for got, want in zip(ops.mamba_scan(dt, dt, Bm, Bm, A, h),
                         tref.mamba_scan_ref(dt, dt, Bm, Bm, A, h)):
        assert torch.equal(got, want)
    for got, want in zip(ops.rg_lru_scan(dt, dt, h[:, :, 0]),
                         tref.rg_lru_ref(dt, dt, h[:, :, 0])):
        assert torch.equal(got, want)
    assert ops.dispatch_counts() == {"flash_attention": 2, "bank_matmul": 1,
                                     "decode_attention": 1, "page_gather": 1,
                                     "mamba_scan": 1, "rg_lru_scan": 1}
    assert ops.kernel_launches() == {name: 0 for name in ops.OP_TABLE}
    ops.reset_dispatch_counts()
    assert ops.dispatch_counts() == {}


def test_route_launch_counters_reset_and_cpu_dispatch_leaves_them():
    kbank.bank_matmul.route_launches["wgmma"] += 2
    kflash.flash_attention.route_launches["simt"] += 1
    kmamba.mamba_scan.route_launches["step"] += 3
    ops.reset_kernel_launches()
    assert ops.route_launches() == {"bank_matmul": {"wgmma": 0, "simt": 0},
                                    "flash_attention": {"mma": 0, "simt": 0},
                                    "mamba_scan": {"step": 0, "scan": 0}}
    _, (x, w) = _inputs(1, [(3, 4, 8), (3, 8, 8)], "bfloat16")
    ops.bank_matmul(x, w)
    assert ops.route_launches()["bank_matmul"] == {"wgmma": 0, "simt": 0}


def test_kernel_wrappers_take_cuda_tensors_only():
    _, (q, x, w) = _inputs(0, [(1, 16, 2, 64), (4, 8), (2, 8, 5)], "float32")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kbank.bank_matmul(x, w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kdecode.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kgather.page_gather(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kmamba.mamba_scan(x[None], x[None], w, w, x.t(), w)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        krglru.rg_lru_scan(x[None], x[None], x)
    # meta tensors take the plain version, as CPU tensors do: shapes only,
    # no kernel reached
    ops.reset_kernel_launches()
    y, h = ops.rg_lru_scan(x[None].to("meta"), x[None].to("meta"), x.to("meta"))
    assert [(t.device.type, t.shape) for t in (y, h)] == \
        [("meta", t.shape) for t in ops.rg_lru_scan(x[None], x[None], x)]
    g = ops.page_gather(x.to("meta"), torch.zeros(2, dtype=torch.int32, device="meta"))
    assert (g.device.type, g.shape) == ("meta", (2, 8))
    b = ops.bank_matmul(x.to("meta"), w.to("meta"))
    assert (b.device.type, b.shape, b.dtype) == ("meta", (2, 4, 5), torch.float32)
    assert not any(ops.kernel_launches().values())


def test_op_table_names_each_kernel_its_source_and_the_tpu_kernel():
    root = Path(__file__).resolve().parents[1]
    assert set(ops.OP_TABLE) == {"flash_attention", "bank_matmul", "decode_attention",
                                 "page_gather", "mamba_scan", "rg_lru_scan"}
    assert {str(p.relative_to(root)) for p in _build.sources()} == \
        {s.source for s in ops.OP_TABLE.values()}
    for spec in ops.OP_TABLE.values():
        assert spec.dispatch is getattr(ops, spec.name)
        assert 'extern "C"' in (root / spec.source).read_text()
        path, line = spec.replaces.split(":")
        assert "pallas_call" in (root / path).read_text().splitlines()[int(line) - 1]


def test_sass_mma_counts_reads_each_kernels_tensor_core_instructions(monkeypatch):
    """The build line's HGMMA / HMMA counts, parsed from a cuobjdump -sass
    listing (predicated instructions included, names left mangled when no
    cu++filt is found)."""
    listing = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _Z4bankv",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x00000a0000017a02 */",
        "        /*0010*/              @P0  HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], RZ ;  /* 0x0 */",
        "        /*0020*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], R24 ; /* 0x0 */",
        "\t\tFunction : _Z5flashv",
        "        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x0 */",
        "        /*0010*/                   LDSM.16.M88.4 R8, [R2] ;  /* 0x0 */",
    ])
    monkeypatch.setattr(_build, "find_tool", lambda name: "cuobjdump" if name == "cuobjdump" else None)
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: type("Done", (), {"stdout": listing})())
    assert _build.sass_mma_counts(Path("libkernels.so")) == {
        "_Z4bankv": {"HGMMA": 2, "HMMA": 0}, "_Z5flashv": {"HGMMA": 0, "HMMA": 1}}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_compiles_every_source_and_times_each(monkeypatch, tmp_path):
    """``build`` starts one compiler a source, drains each one's report
    while the others run, times each and links: here with a stand-in
    compiler that writes its output file and a long report (more than a
    pipe holds)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "out=''; prev=''\n"
                    "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
                    "head -c 200000 /dev/zero | tr '\\0' 'x'; echo\n"
                    "echo 'ptxas info    : Used 8 registers'\n"
                    ": > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "build_info", {})
    lib = _build.build()
    assert lib.is_file() and lib.parent.parent == tmp_path / "build"
    names = {p.name for p in _build.sources()}
    assert set(_build.build_info["source_seconds"]) == set(_build.build_info["ptxas"]) == names
    assert all("Used 8 registers" in log for log in _build.build_info["ptxas"].values())
    assert _build.build() == lib and _build.build_info["cached"]
