"""The port's family call surface (``repro_torch.configs``,
``repro_torch.models.registry.FAMILIES``) against the JAX package's, for
all ten architectures.

JAX params (``scan_layers=False``, the port's per-layer layout) cross
through ``repro_torch.bridge``; tokens, patch and frame embeddings come
from numpy.  Tolerances:
  * configs, shapes, input and cache specs, the family table and
    ``pod_sizing``'s rows: exactly equal;
  * forward, prefill (logits and cache) and the decode steps after it, at
    the smoke configs in float32: 1e-4 (XLA and PyTorch reduce the same
    float32 GEMMs, norms and softmaxes in different orders);
  * ``blocked_causal_attention`` and explicit positions: 1e-5;
  * inside the port, prefill plus one decode step against the forward over
    the prompt and the token: 2e-4, the JAX package's own
    ``tests/test_models.py`` tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import lm_merging as JLM
from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.models import griffin as JG
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.registry import FAMILIES as JAX_FAMILIES
from repro_torch import bridge
from repro_torch.bench import lm_merging as TLM
from repro_torch.configs import base, registry
from repro_torch.models import griffin as TG
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.registry import FAMILIES, get_family
from repro_torch.utils.tree import dtype_name, flatten_paths

ARCH_IDS = jax_registry.all_arch_ids()
# layout and compile fields of the JAX configs that the port does not have:
# the stacked-layer layout, its remat policy, the probe's unrolling and the
# Pallas scans' tile ``chunk`` (the port's scan kernels take any length)
LAYOUT_FIELDS = {"scan_layers", "remat_policy", "probe_unroll", "chunk"}
XTOL = dict(rtol=1e-4, atol=1e-4)
ATOL5 = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
B, S, NEW = 2, 8, 2


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if not isinstance(out["dtype"], str):
        out["dtype"] = jnp.dtype(out["dtype"]).name
    return out


def test_arch_registry_lists_the_reference_ids_in_order():
    assert registry.ARCHS == jax_registry.ARCHS
    assert registry.all_arch_ids() == ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.load_arch("gpt-2")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_shapes_and_skips_equal_the_reference(arch):
    jmod, tmod = jax_registry.load_arch(arch), registry.load_arch(arch)
    assert (tmod.ARCH_ID, tmod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY)
    for name in ("full_config", "smoke_config"):
        j, t = getattr(jmod, name)(), getattr(tmod, name)()
        assert type(t).__name__ == type(j).__name__
        want = {k: v for k, v in _fields(j).items() if k not in LAYOUT_FIELDS}
        assert _fields(t) == want, name
    assert {k: dataclasses.astuple(v) for k, v in tmod.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jmod.SHAPES.items()}
    assert tmod.SKIP == jmod.SKIP


def _spec_tree(tree) -> dict:
    return {p: (tuple(int(n) for n in leaf.shape), dtype_name(leaf.dtype)
                if isinstance(leaf, torch.Tensor) else jnp.dtype(leaf.dtype).name)
            for p, leaf in flatten_paths(tree or {}).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_the_reference(arch):
    jmod, tmod = jax_registry.load_arch(arch), registry.load_arch(arch)
    for cfg_name in ("full_config", "smoke_config"):
        jcfg, tcfg = getattr(jmod, cfg_name)(), getattr(tmod, cfg_name)()
        for shape in jmod.SHAPES.values():
            tshape = tmod.SHAPES[shape.name]
            got = base.input_specs(tcfg, tmod.FAMILY, tshape)
            assert all(t.device.type == "meta" for t in got.values())
            assert _spec_tree(got) == _spec_tree(jax_base.input_specs(jcfg, jmod.FAMILY, shape))
            assert _spec_tree(base.cache_specs(tcfg, tmod.FAMILY, tshape)) == \
                _spec_tree(jax_base.cache_specs(jcfg, jmod.FAMILY, shape))


def test_family_table_equals_the_reference():
    assert sorted(FAMILIES) == sorted(JAX_FAMILIES)
    for name, jfam in JAX_FAMILIES.items():
        fam = get_family(name)
        assert fam.name == jfam.name and fam.has_decode == jfam.has_decode
        assert fam.config_cls.__name__ == jfam.config_cls.__name__
        for fn in ("init_cache", "decode_step", "prefill"):
            assert (getattr(fam, fn) is None) == (getattr(jfam, fn) is None), (name, fn)
    assert not get_family("small_cnn").has_decode
    assert get_family("encdec").init_cache is None


def test_pod_sizing_rows_equal_the_jax_bench():
    assert TLM.pod_sizing() == JLM.pod_sizing()


# ---------------------------------------------------------------------------
# the ten smoke configs through the family surface
# ---------------------------------------------------------------------------


def _arch(arch):
    jmod, tmod = jax_registry.load_arch(arch), registry.load_arch(arch)
    jcfg = dataclasses.replace(jmod.smoke_config(), scan_layers=False)
    return jmod.FAMILY, jcfg, tmod.smoke_config()


def _inputs(family, cfg, n_tokens, seed=0):
    """(tokens (B, n_tokens), extra) from numpy: vlm's 8 patch embeddings,
    encdec's 6 source frames, else None."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(np.int32)
    extra = None
    if family == "vlm":
        extra = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    elif family == "encdec":
        extra = rng.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
    return toks, extra


def _call(fam, family, name, cfg, params, toks, extra, jit=False, **static):
    """``fam.<name>(cfg, params, <the family's inputs>, **static)``; with
    ``jit`` the JAX package's function jitted (its eager dispatch is slow)."""
    fn = functools.partial(getattr(fam, name), cfg, **static)
    fn = jax.jit(fn) if jit else fn
    if family in ("vlm", "encdec"):
        a, b = (toks, extra) if family == "vlm" else (extra, toks)
        return fn(params, a, b)
    return fn(params, toks)


def _assert_cache(tc, jc):
    jflat = flatten_paths(jc)
    tflat = flatten_paths(tc)
    assert sorted(tflat) == sorted(jflat)
    for p, j in jflat.items():
        if p == "length":
            assert int(np.asarray(j)) == int(tflat[p])
        else:
            np.testing.assert_allclose(_np(tflat[p]), np.asarray(j, np.float32), **XTOL,
                                       err_msg=p)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_prefill_and_decode_match_the_reference(arch):
    family, jcfg, tcfg = _arch(arch)
    jfam, fam = JAX_FAMILIES[family], get_family(family)
    jp = jfam.init(jcfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jp, device=CPU)
    toks, extra = _inputs(family, tcfg, S + NEW)
    tt, te = torch.from_numpy(toks), None if extra is None else torch.from_numpy(extra)

    jout = _call(jfam, family, "forward", jcfg, jp, toks[:, :S], extra, jit=True)
    tout = _call(fam, family, "forward", tcfg, tp, tt[:, :S], te)
    if family == "moe":  # (logits, router aux loss)
        np.testing.assert_allclose(float(tout[1]), float(jout[1]), **XTOL)
        jout, tout = jout[0], tout[0]
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **XTOL)

    max_len = S + 4 + (tcfg.n_patches if family == "vlm" else 0)
    jl, jc = _call(jfam, family, "prefill", jcfg, jp, toks[:, :S], extra, jit=True,
                   max_len=max_len)
    tl, tc = _call(fam, family, "prefill", tcfg, tp, tt[:, :S], te, max_len=max_len)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
    _assert_cache(tc, jc)
    jdecode = jax.jit(functools.partial(jfam.decode_step, jcfg))
    for i in range(NEW):
        jl, jc = jdecode(jp, jc, toks[:, S + i:S + i + 1])
        tl, tc = fam.decode_step(tcfg, tp, tc, tt[:, S + i:S + i + 1])
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
        _assert_cache(tc, jc)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-14b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "seamless-m4t-medium",
                                  "deepseek-moe-16b"])
def test_prefill_then_decode_matches_forward_inside_the_port(arch):
    """Prefill(prompt) + decode(1 token) logits == forward(prompt + token),
    the JAX package's property (tests/test_models.py).  The moe config
    takes a capacity factor of 8.0 here, as there: with realistic capacity
    the same token routes differently in a 9-token forward than in a
    1-token decode (capacity competition), which is the moe family's
    semantics and not a fault."""
    tmod = registry.load_arch(arch)
    family, cfg = tmod.FAMILY, tmod.smoke_config()
    if family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    fam = get_family(family)
    params = fam.init(cfg, 0, CPU)
    toks, extra = _inputs(family, cfg, S + 1, seed=1)
    tt, te = torch.from_numpy(toks), None if extra is None else torch.from_numpy(extra)
    full = _call(fam, family, "forward", cfg, params, tt, te)
    full = full[0] if family == "moe" else full
    max_len = S + 4 + (cfg.n_patches if family == "vlm" else 0)
    _, cache = _call(fam, family, "prefill", cfg, params, tt[:, :S], te, max_len=max_len)
    step, _ = fam.decode_step(cfg, params, cache, tt[:, S:])
    torch.testing.assert_close(step[:, 0], full[:, -1], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# blocked attention and explicit positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,seq", [(None, 64), (16, 64), (16, 40)])
def test_blocked_causal_attention_matches_the_reference(window, seq):
    """block_q 16; S = 40 is not a multiple of it (the masked fallback)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, seq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, seq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, seq, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    want = JL.blocked_causal_attention(q, k, v, pos, window=window, block_q=16)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, pos)]
    got = L.blocked_causal_attention(*t, window=window, block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL5)
    dense = L.gqa_attention(*t[:3], L.attention_mask(t[3], t[3], True, window))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **ATOL5)


def _packed_positions(seq: int) -> np.ndarray:
    """Two packed sequences a row (0..h-1, 0..seq-h-1), the second row offset."""
    h = seq // 2
    row = np.concatenate([np.arange(h), np.arange(seq - h)])
    return np.stack([row, np.arange(seq) + 3]).astype(np.int32)


@pytest.mark.parametrize("block_q", [4, 3])
def test_prefill_at_explicit_positions_matches_the_reference(block_q):
    """``prefill_from_embeddings`` at packed positions takes the blocked
    attention (block_q 3 leaves a ragged block: the masked fallback); its
    cache fills slots 0..S-1 as the JAX package's.  At positions 0..S-1
    the blocked path equals the flash path (``positions=None``)."""
    _, jcfg, tcfg = _arch("qwen3-14b")
    jcfg = dataclasses.replace(jcfg, prefill_block_q=block_q)
    tcfg = dataclasses.replace(tcfg, prefill_block_q=block_q)
    jp = JT.init(jcfg, jax.random.PRNGKey(4))
    tp = bridge.to_torch(jp, device=CPU)
    toks, _ = _inputs("dense", tcfg, 12, seed=5)
    jx = JL.embed(toks, jp["embed"]["table"])
    tx = L.embed(torch.from_numpy(toks), tp["embed"]["table"])
    pos = _packed_positions(12)
    jl, jc = jax.jit(functools.partial(JT.prefill_from_embeddings, jcfg, max_len=16))(
        jp, jx, pos)
    tl, tc = TT.prefill_from_embeddings(tcfg, tp, tx, torch.from_numpy(pos), 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **ATOL5)
    _assert_cache(tc, jc)
    std = torch.from_numpy(np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12)).copy())
    bl, bc = TT.prefill_from_embeddings(tcfg, tp, tx, std, 16)
    fl, fc = TT.prefill_from_embeddings(tcfg, tp, tx, None, 16)
    torch.testing.assert_close(bl, fl, **ATOL5)
    for key in ("k", "v"):
        torch.testing.assert_close(bc[key], fc[key], **ATOL5)


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-9b"])
def test_explicit_positions_match_the_reference(arch):
    family, jcfg, tcfg = _arch(arch)
    jmod, tmod = (JT, TT) if family == "dense" else (JG, TG)
    jp = jmod.init(jcfg, jax.random.PRNGKey(1))
    tp = bridge.to_torch(jp, device=CPU)
    toks, _ = _inputs(family, tcfg, 20, seed=2)
    pos = _packed_positions(20)
    want = jax.jit(functools.partial(jmod.forward, jcfg))(jp, toks, positions=pos)
    got = tmod.forward(tcfg, tp, torch.from_numpy(toks), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATOL5)
