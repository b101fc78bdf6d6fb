"""The port's models against the JAX package, on shared parameters.

JAX params cross through ``repro_torch.bridge``; inputs come from numpy.
Configs: stablelm-1.6b's smoke config (per-layer blocks) in float32 and
bf16, a GQA variant of it, the dense family's other options (qkv bias,
qk-norm, non-parametric LN with tied embeddings, softcap, window), and the
small_cnn adapter default in both tasks.

Tolerance across packages in float32: 1e-4 — XLA and PyTorch reduce the
same float32 GEMMs, norms and softmaxes in different orders, and the
differences compound through the layers (bf16 tolerances are stated on
their test).  Inside the port on the CPU the
serving contracts hold bitwise: ``suffix(prefix(x)) == forward(x)`` and
bank == per-member head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stablelm_1_6b as jax_stablelm
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import vision as JV
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs import stablelm_1_6b
from repro_torch.core.store import ParamStore
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models import vision as TV
from repro_torch.models.registry import get_adapter

XTOL = dict(rtol=1e-4, atol=1e-4)
TIGHT_F32_SUMS = dict(rtol=1e-5, atol=1e-5)  # one contraction, f32 sums in another order
CPU = torch.device("cpu")


def _port_cfg(cls, jcfg):
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    return cls(**{n: getattr(jcfg, n) for n in names},
               dtype=np.dtype(jcfg.dtype).name)


# config variants of the dense family beyond stablelm's: the options the
# JAX transformer has (qwen2 qkv bias, qwen3 qk-norm, olmo's
# non-parametric LN with tied embeddings, softcap and a sliding window)
VARIANTS = {
    "qkv_bias+qk_norm": dict(qkv_bias=True, qk_norm=True, norm="rmsnorm", rotary_pct=1.0),
    "olmo_tied": dict(norm="nonparam_ln", tie_embeddings=True),
    "softcap+window": dict(logit_softcap=30.0, window=5, norm="rmsnorm", act="gelu"),
}


def _lm_cfgs(gqa: bool, variant: str = None):
    jcfg = dataclasses.replace(jax_stablelm.smoke_config(), scan_layers=False)
    if gqa:
        jcfg = dataclasses.replace(jcfg, name=jcfg.name + "-gqa", n_kv_heads=2)
    if variant:
        jcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-{variant}", **VARIANTS[variant])
    return jcfg, _port_cfg(TT.DenseLMConfig, jcfg)


def _jitter(tree, scale=0.1):
    """Deterministic non-zero offsets on every leaf (zero-init biases and
    norm scales would hide their paths)."""
    return jax.tree_util.tree_map(
        lambda l: l + scale * jnp.cos(jnp.arange(l.size).reshape(l.shape)).astype(l.dtype),
        tree)


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def test_port_configs_match_reference_widths():
    for name in ("full_config", "smoke_config"):
        jcfg, tcfg = getattr(jax_stablelm, name)(), getattr(stablelm_1_6b, name)()
        assert _port_cfg(TT.DenseLMConfig, jcfg) == tcfg
        assert tcfg.padded_vocab == jcfg.padded_vocab
    assert stablelm_1_6b.full_config().dtype == "bfloat16"
    jsmall = jax_get_adapter("small_cnn").default_config()
    assert _port_cfg(TV.SmallCNNConfig, jsmall) == get_adapter("small_cnn").default_config()


@pytest.mark.parametrize("gqa", [False, True])
def test_dense_trunk_head_forward_bank_match_reference(gqa):
    jcfg, tcfg = _lm_cfgs(gqa)
    mids = ("A", "B", "C")
    jparams = {m: JT.init(jcfg, jax.random.PRNGKey(i)) for i, m in enumerate(mids)}
    tparams = {m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()}
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks.astype(np.int64))

    jx = JT.trunk(jcfg, jparams["A"], jt)
    tx = TT.trunk(tcfg, tparams["A"], tt)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), **XTOL)
    # the head on the SAME hidden states isolates the suffix
    th = TT.head(tcfg, tparams["B"], bridge.array_to_tensor(jx, CPU))
    np.testing.assert_allclose(_np(th), np.asarray(JT.head(jcfg, jparams["B"], jx)), **XTOL)
    np.testing.assert_allclose(_np(TT.forward(tcfg, tparams["C"], tt)),
                               np.asarray(JT.forward(jcfg, jparams["C"], jt)), **XTOL)

    paths = TT.head_paths(tparams["A"])
    tbank = ParamStore.from_models(tparams).materialize_bank(mids, paths)
    jbank = jax.tree_util.tree_map(lambda *l: jnp.stack(l),
                                   *[{k: p[k] for k in ("final_norm", "lm_head")}
                                     for p in jparams.values()])
    got = TT.bank_head(tcfg, tbank, bridge.array_to_tensor(jx, CPU))
    assert got.shape == (3, 2, 16, jcfg.padded_vocab) and got.dtype == torch.float32
    for mode in ("ref", "interpret"):
        want = JT.bank_head(jcfg, jbank, jx, mode=mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), **XTOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_config_variants_match_reference(variant):
    jcfg, tcfg = _lm_cfgs(True, variant)
    jp = _jitter(JT.init(jcfg, jax.random.PRNGKey(3)))
    tp = bridge.to_torch(jp, device=CPU)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks.astype(np.int64))
    np.testing.assert_allclose(_np(TT.forward(tcfg, tp, tt)),
                               np.asarray(JT.forward(jcfg, jp, jt)), **XTOL)
    adapter = get_adapter("dense")
    sp = adapter.split(tcfg)
    assert (sp.bank_suffix is None) == tcfg.tie_embeddings
    assert torch.equal(sp.suffix(tp, sp.prefix(tp, tt)), adapter.forward(tcfg, tp, tt))


def test_unembed_keeps_float32_sums_of_bf16_products():
    """``layers.unembed`` is the reference's preferred_element_type=f32
    contraction: exact bf16 products summed in f32, never rounded back."""
    rng = np.random.default_rng(6)
    jx = jnp.asarray(rng.standard_normal((8, 64)), jnp.bfloat16)
    jw = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
    tx, tw = bridge.array_to_tensor(jx, CPU), bridge.array_to_tensor(jw, CPU)
    got = TL.unembed(tx, tw, transpose=False)
    assert got.dtype == torch.float32
    assert torch.equal(got, tx.float() @ tw.float())
    assert not torch.equal(got, got.to(torch.bfloat16).float())
    np.testing.assert_allclose(_np(got), np.asarray(JL.unembed(jx, jw, transpose=False)),
                               **TIGHT_F32_SUMS)
    assert torch.equal(TL.unembed(tx, tw.t().contiguous(), transpose=True), got)


def test_dense_bf16_matches_reference():
    """bf16 weights and activations (the full config's dtype).  Logits stay
    float32 sums of bf16 products in both packages; a bf16 logits path
    would round them.  Tolerances: the trunk rounds to bf16 after every op,
    and the two frameworks may round an elementwise result (SiLU, the
    residual adds) to neighbouring values — one bf16 step is 2^-5 at
    |x| in [4, 8) — so trunk and logits get 2 such steps (6.25e-2) plus
    the repo's bf16 rtol; the head alone on identical hidden states gets
    the repo's bf16 TOL."""
    jcfg = dataclasses.replace(jax_stablelm.smoke_config(), scan_layers=False,
                               dtype=jnp.bfloat16)
    tcfg = _port_cfg(TT.DenseLMConfig, jcfg)
    assert tcfg.dtype == "bfloat16"
    mids = ("A", "B")
    jparams = {m: JT.init(jcfg, jax.random.PRNGKey(i)) for i, m in enumerate(mids)}
    tparams = {m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()}
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks.astype(np.int64))
    loose = dict(rtol=2e-2, atol=6.25e-2)
    jx = JT.trunk(jcfg, jparams["A"], jt)
    tx = TT.trunk(tcfg, tparams["A"], tt)
    assert tx.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tx), np.asarray(jx, np.float32), **loose)
    tl = TT.forward(tcfg, tparams["A"], tt)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(JT.forward(jcfg, jparams["A"], jt)), **loose)
    bf16 = dict(rtol=2e-2, atol=2e-2)
    txj = bridge.array_to_tensor(jx, CPU)
    np.testing.assert_allclose(_np(TT.head(tcfg, tparams["B"], txj)),
                               np.asarray(JT.head(jcfg, jparams["B"], jx)), **bf16)
    tbank = ParamStore.from_models(tparams).materialize_bank(mids, TT.head_paths(tparams["A"]))
    jbank = jax.tree_util.tree_map(lambda *l: jnp.stack(l),
                                   *[{k: p[k] for k in ("final_norm", "lm_head")}
                                     for p in jparams.values()])
    np.testing.assert_allclose(_np(TT.bank_head(tcfg, tbank, txj)),
                               np.asarray(JT.bank_head(jcfg, jbank, jx, mode="interpret")),
                               **bf16)


@pytest.mark.parametrize("gqa", [False, True])
def test_dense_split_and_bank_are_bitwise_inside_the_port(gqa):
    _, tcfg = _lm_cfgs(gqa)
    adapter = get_adapter("dense")
    mids = ("A", "B", "C")
    params = {m: adapter.init(tcfg, seed=i, device=CPU) for i, m in enumerate(mids)}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (4, 8)))
    sp = adapter.split(tcfg)
    feats = sp.prefix(params["A"], toks)
    assert torch.equal(sp.suffix(params["A"], feats), adapter.forward(tcfg, params["A"], toks))
    bank = ParamStore.from_models(params).materialize_bank(mids, sp.suffix_paths)
    out = sp.bank_suffix(bank, feats)
    for i, m in enumerate(mids):
        assert torch.equal(out[i], sp.suffix(params[m], feats))


def _small_cnn():
    jadapter, tadapter = jax_get_adapter("small_cnn"), get_adapter("small_cnn")
    return jadapter.default_config(), tadapter.default_config(), jadapter, tadapter


@pytest.mark.parametrize("task", ["classification", "detection"])
def test_small_cnn_features_head_forward_bank_match_reference(task):
    jcfg, tcfg, jadapter, _ = _small_cnn()
    jcfg, tcfg = (dataclasses.replace(c, task=task) for c in (jcfg, tcfg))
    mids = ("A", "B")
    jparams = {m: jadapter.init(jcfg, jax.random.PRNGKey(i)) for i, m in enumerate(mids)}
    # non-zero biases so the bias paths are exercised
    jparams = {m: _jitter(p, 0.1 * (i + 1)) for i, (m, p) in enumerate(jparams.items())}
    tparams = {m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()}
    imgs = np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ji, ti = jnp.asarray(imgs), torch.from_numpy(imgs)

    jf = JV.small_cnn_features(jcfg, jparams["A"], ji)
    tf = TV.small_cnn_features(tcfg, tparams["A"], ti)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), **XTOL)
    np.testing.assert_allclose(
        _np(TV.small_cnn_head(tcfg, tparams["B"], bridge.array_to_tensor(jf, CPU))),
        np.asarray(JV.small_cnn_head(jcfg, jparams["B"], jf)), **XTOL)
    np.testing.assert_allclose(_np(TV.small_cnn_forward(tcfg, tparams["B"], ti)),
                               np.asarray(JV.small_cnn_forward(jcfg, jparams["B"], ji)), **XTOL)

    paths = TV.small_cnn_suffix_paths(tcfg, tparams["A"])
    tbank = ParamStore.from_models(tparams).materialize_bank(mids, paths)
    jbank = jax.tree_util.tree_map(lambda *l: jnp.stack(l),
                                   *[{"head": p["head"]} for p in jparams.values()])
    got = TV.small_cnn_bank_head(tcfg, tbank, bridge.array_to_tensor(jf, CPU))
    for mode in ("ref", "interpret"):
        want = JV.small_cnn_bank_head(jcfg, jbank, jf, mode=mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), **XTOL)


@pytest.mark.parametrize("task", ["classification", "detection"])
def test_small_cnn_split_and_bank_are_bitwise_inside_the_port(task):
    _, tcfg, _, adapter = _small_cnn()
    tcfg = dataclasses.replace(tcfg, task=task)
    mids = ("A", "B", "C")
    params = {m: adapter.init(tcfg, seed=i, device=CPU) for i, m in enumerate(mids)}
    imgs = torch.from_numpy(
        np.random.default_rng(3).standard_normal((4, 32, 32, 3)).astype(np.float32))
    sp = adapter.split(tcfg)
    feats = sp.prefix(params["A"], imgs)
    assert torch.equal(sp.suffix(params["A"], feats), adapter.forward(tcfg, params["A"], imgs))
    bank = ParamStore.from_models(params).materialize_bank(mids, sp.suffix_paths)
    out = sp.bank_suffix(bank, feats)
    for i, m in enumerate(mids):
        assert torch.equal(out[i], sp.suffix(params[m], feats))


def test_small_cnn_same_padding_matches_reference_at_stride_two():
    """XLA's SAME pads the odd row/column at the END; symmetric padding
    would shift every stride-2 window by one pixel."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 9, 10, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 5)).astype(np.float32)
    want = JV._conv(jnp.asarray(x), {"w": jnp.asarray(w)}, stride=2)
    got = TV._conv(torch.from_numpy(x), {"w": torch.from_numpy(w)}, stride=2)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **XTOL)
