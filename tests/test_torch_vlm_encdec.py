"""The port's vlm and encdec families (``repro_torch.models.vlm``,
``repro_torch.models.encdec`` and their records-only ``FamilyAdapter``s)
against the JAX package's, at the internvl2-2b and seamless-m4t-medium
smoke configs in float32.

JAX params (``scan_layers=False``) cross through ``repro_torch.bridge``;
tokens, patch and frame embeddings come from numpy.  Tolerances: records,
adapter names and capability errors exactly equal; activations, logits,
losses, caches and accuracies 1e-4 (XLA and PyTorch reduce the same float32
GEMMs, norms and softmaxes in different orders).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import internvl2_2b as jax_internvl2
from repro.configs import seamless_m4t_medium as jax_seamless
from repro.models import encdec as JE
from repro.models import vlm as JV
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs import internvl2_2b, seamless_m4t_medium
from repro_torch.models import encdec as TE
from repro_torch.models import vlm as TV
from repro_torch.models.registry import ADAPTERS, FamilyAdapter, get_adapter
from repro_torch.utils.tree import flatten_paths

XTOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
B, S = 2, 8


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(family: str, seed: int = 0):
    jmod, tmod, jm = ((jax_internvl2, internvl2_2b, JV) if family == "vlm"
                      else (jax_seamless, seamless_m4t_medium, JE))
    jcfg = dataclasses.replace(jmod.smoke_config(), scan_layers=False)
    jp = jax.jit(jm.init, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tmod.smoke_config(), jp, bridge.to_torch(jp, device=CPU)


def _batch(family: str, cfg, seed: int = 0) -> dict:
    """A numpy batch in the family's layout: tokens, labels and vlm's patch
    or encdec's frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    else:
        batch["src_embeds"] = rng.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: _t(v) for k, v in batch.items()}


def test_vlm_forward_loss_and_prefill_match_the_reference():
    jcfg, tcfg, jp, tp = _setup("vlm")
    batch = _batch("vlm", tcfg)
    tb = _torch_batch(batch)
    want = jax.jit(functools.partial(JV.forward, jcfg))(jp, batch["tokens"], batch["patch_embeds"])
    got = TV.forward(tcfg, tp, tb["tokens"], tb["patch_embeds"])
    assert got.shape == (B, tcfg.n_patches + S, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **XTOL)
    np.testing.assert_allclose(float(TV.loss_fn(tcfg, tp, tb)),
                               float(jax.jit(functools.partial(JV.loss_fn, jcfg))(jp, batch)),
                               **XTOL)
    max_len = tcfg.n_patches + S + 3
    jl, jc = jax.jit(functools.partial(JV.prefill, jcfg, max_len=max_len))(
        jp, batch["tokens"], batch["patch_embeds"])
    tl, tc = TV.prefill(tcfg, tp, tb["tokens"], tb["patch_embeds"], max_len)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **XTOL)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **XTOL)
    assert int(tc["length"]) == int(jc["length"]) == tcfg.n_patches + S
    # the prefilled cache decodes as the dense LM's (vlm.decode_step is its)
    nxt = batch["labels"][:, -1:]
    jl, _ = jax.jit(functools.partial(JV.decode_step, jcfg))(jp, jc, nxt)
    tl, _ = TV.decode_step(tcfg, tp, tc, _t(nxt))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)


def test_encdec_encode_forward_cache_and_decode_match_the_reference():
    jcfg, tcfg, jp, tp = _setup("encdec")
    batch = _batch("encdec", tcfg)
    tb = _torch_batch(batch)
    jenc = jax.jit(functools.partial(JE.encode, jcfg))(jp, batch["src_embeds"])
    tenc = TE.encode(tcfg, tp, tb["src_embeds"])
    np.testing.assert_allclose(_np(tenc), np.asarray(jenc), **XTOL)
    want = jax.jit(functools.partial(JE.forward, jcfg))(jp, batch["src_embeds"], batch["tokens"])
    np.testing.assert_allclose(_np(TE.forward(tcfg, tp, tb["src_embeds"], tb["tokens"])),
                               np.asarray(want), **XTOL)
    np.testing.assert_allclose(float(TE.loss_fn(tcfg, tp, tb)),
                               float(jax.jit(functools.partial(JE.loss_fn, jcfg))(jp, batch)),
                               **XTOL)
    # the cache from the JAX encoder output in both packages, so its cross
    # K/V isolate init_cache
    max_len = S + 2
    jc = JE.init_cache(jcfg, jp, jenc, B, max_len)
    tc = TE.init_cache(tcfg, tp, _t(np.asarray(jenc)), B, max_len)
    for p, j in flatten_paths(jc).items():
        np.testing.assert_allclose(_np(flatten_paths(tc)[p]), np.asarray(j, np.float32),
                                   **XTOL, err_msg=p)
    jdecode = jax.jit(functools.partial(JE.decode_step, jcfg))
    toks = batch["tokens"]
    # a 3-token chunk, then two single tokens
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        jl, jc = jdecode(jp, jc, toks[:, lo:hi])
        tl, tc = TE.decode_step(tcfg, tp, tc, _t(toks[:, lo:hi]))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
        np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **XTOL)
        np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **XTOL)
        assert int(tc["length"]) == int(jc["length"]) == hi


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_family_adapters_records_and_accuracy_match_the_reference(family):
    jadapter, adapter = jax_get_adapter(family), get_adapter(family)
    assert isinstance(adapter, FamilyAdapter) and ADAPTERS[family] is adapter
    assert (adapter.name, adapter.family) == (jadapter.name, jadapter.family)
    assert (adapter.can_calibrate, adapter.can_split, adapter.can_decode) == \
        (jadapter.can_calibrate, jadapter.can_split, jadapter.can_decode)
    jcfg, tcfg, jp, tp = _setup(family, seed=3)

    def recs(rs):
        return [(r.model_id, r.path, r.signature, r.bytes, r.position) for r in rs]

    assert recs(adapter.records(tcfg, tp, "m")) == recs(jadapter.records(jcfg, jp, "m"))
    assert recs(adapter.records(tcfg, adapter.eval_params(tcfg), "m")) == \
        recs(jadapter.records(jcfg, jadapter.eval_params(jcfg), "m"))
    batch = _batch(family, tcfg, seed=4)
    np.testing.assert_allclose(float(adapter.accuracy(tcfg, tp, _torch_batch(batch))),
                               float(jadapter.accuracy(jcfg, jp, batch)), **XTOL)
    assert type(adapter.default_config()).__name__ == type(jadapter.default_config()).__name__


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_records_only_adapters_raise_named_capability_errors(family):
    """The JAX package's messages (tests/test_adapters.py)."""
    adapter = get_adapter(family)
    cfg = adapter.default_config()
    with pytest.raises(NotImplementedError, match=f"{family}: no calibration"):
        adapter.calibration_batch(cfg, 0, 2)
    with pytest.raises(NotImplementedError, match=f"{family}: no calibration"):
        adapter.layer_activations(cfg, {}, {})
    with pytest.raises(NotImplementedError, match=f"{family}: no prefix/suffix"):
        adapter.split(cfg)
    with pytest.raises(NotImplementedError, match=f"{family}: no streaming decode"):
        adapter.decode_split(cfg)
