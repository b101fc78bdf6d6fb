"""The model zoo's two registries (the port of ``repro.models.registry``).

* **ModelFamily** — the call surface of each of the seven families
  (init / loss / forward / prefill / decode_step):

      fam = get_family("moe")
      params = fam.init(cfg, seed, device)
      loss   = fam.loss(cfg, params, batch)
      logits, cache = fam.prefill(cfg, params, ...)
      logits, cache = fam.decode_step(cfg, params, cache, tokens)

* **MergeableAdapter** — the merge pipeline's model-facing contract: the
  merge, calibration, split-serve and decode tiers of small_cnn and the
  four token-LM families (dense, ssm, hybrid, moe), and the records-only
  :class:`FamilyAdapter` of vlm and encdec.

Everything the planner, the store and the serving engine need from a model
family is behind one interface:

    a = get_adapter("small_cnn")
    recs  = a.records(cfg, params, model_id)        # signature extraction
    acts  = a.layer_activations(cfg, params, batch) # CKA calibration taps
    reg   = a.registered(cfg, model_id, seed)       # planner retraining
    split = a.split(cfg)                            # prefix/suffix serving
    ds = a.decode_split(cfg)                        # paged streaming decode

Where the JAX package takes a PRNG key, ``init`` takes a seed (and a
device), the calibration tier a seed or a ``torch.Generator`` (whose
device the batches are drawn on).

``batch`` layouts per family (all include "labels" and optional "mask"):
    dense/moe/ssm/hybrid:   {"tokens": (B,S) int}
    vlm:                    + {"patch_embeds": (B,P,d) float}
    encdec:                 {"src_embeds": (B,Ssrc,d) float, "tokens": (B,Stgt)}
    small_cnn:              {"images": (B,32,32,3) float}
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.core.signatures import records_from_params
from repro_torch.models import encdec, griffin, moe, ssm, transformer, vision, vlm
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import dtype_name, flatten_paths, torch_dtype


def _generator(key: Union[int, torch.Generator], device=None) -> torch.Generator:
    """A seed becomes a generator on ``device``; a generator passes through."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=resolve_device(device)).manual_seed(int(key))


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """One family's functions; ``init(cfg, seed, device)``."""

    name: str
    config_cls: type
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    prefill: Optional[Callable] = None
    has_decode: bool = True


FAMILIES: dict = {
    "dense": ModelFamily(
        "dense", transformer.DenseLMConfig, transformer.init, transformer.loss_fn,
        transformer.forward, transformer.init_cache, transformer.decode_step,
        transformer.prefill),
    "moe": ModelFamily(
        "moe", moe.MoELMConfig, moe.init, moe.loss_fn, moe.forward,
        moe.init_cache, moe.decode_step, moe.prefill),
    "ssm": ModelFamily(
        "ssm", ssm.MambaConfig, ssm.init, ssm.loss_fn, ssm.forward,
        ssm.init_cache, ssm.decode_step, ssm.prefill),
    "hybrid": ModelFamily(
        "hybrid", griffin.GriffinConfig, griffin.init, griffin.loss_fn,
        griffin.forward, griffin.init_cache, griffin.decode_step, griffin.prefill),
    "vlm": ModelFamily(
        "vlm", vlm.VLMConfig, vlm.init, vlm.loss_fn, vlm.forward,
        vlm.init_cache, vlm.decode_step, vlm.prefill),
    # encdec's cache needs the encoder output: encdec.init_cache(cfg, params,
    # enc_out, batch, max_len), or its prefill
    "encdec": ModelFamily(
        "encdec", encdec.EncDecConfig, encdec.init, encdec.loss_fn,
        encdec.forward, None, encdec.decode_step, encdec.prefill),
    "small_cnn": ModelFamily(
        "small_cnn", vision.SmallCNNConfig, vision.init_small_cnn,
        vision.small_cnn_loss, vision.small_cnn_forward, has_decode=False),
}


def get_family(name: str) -> ModelFamily:
    return FAMILIES[name]


@dataclasses.dataclass(frozen=True)
class PrefixSplit:
    """A cfg-bound split of one model into a mergeable trunk and a private
    head.  ``suffix(prefix(x))`` equals the adapter's ``forward`` bitwise.
    The callables are cached per (adapter, cfg), so every group member hands
    the engine the same function objects.

    The suffix-bank tier: ``suffix_paths`` are the flat param paths the
    suffix reads, ``suffix_signature`` a hashable congruence fingerprint
    (equal fingerprints => the members' suffix leaves stack into one bank),
    and ``bank_suffix(bank_params, feats) -> (N, ...)`` the fused fan-out."""

    prefix: Callable  # (params, x) -> feats
    suffix: Callable  # (params, feats) -> out
    prefix_paths: frozenset
    suffix_paths: Optional[frozenset] = None
    suffix_signature: Optional[tuple] = None
    bank_suffix: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class DecodeSplit:
    """Streaming-decode serving surface of a splittable adapter — the
    token-by-token twin of :class:`PrefixSplit`.

    ``trunk_step(params, pool, tables, lengths, tokens) -> (hidden, pool)``
    advances every row of a paged batch by ONE token through the mergeable
    trunk; ``head(params, hidden) -> logits`` is the private fan-out, so
    trunk_step + head is the composed ``step``.  ``step`` is the full paged
    per-model path (singleton groups); ``step_unpaged`` /
    ``init_cache(batch, max_len, device=...)`` are the family's
    contiguous-cache decode, the replay oracle.  ``init_pool(num_pages,
    page_size, device=...)`` allocates the device-side pool.
    ``bank_head(bank_params, hidden) -> (N, B, 1, V)``, when set, fans every
    congruent private head out in one dispatch.  ``trunk_paths`` /
    ``head_paths`` / ``head_signature`` are the PrefixSplit tiers, so decode
    grouping reuses the engine's shared-prefix congruence unchanged."""

    trunk_step: Callable  # (params, pool, tables, lengths, tokens)
    head: Callable  # (params, hidden) -> logits
    step: Callable  # (params, pool, tables, lengths, tokens) paged full step
    step_unpaged: Callable  # (params, cache, tokens) -> (logits, cache)
    init_pool: Callable  # (num_pages, page_size, device=None) -> pool
    init_cache: Callable  # (batch, max_len, device=None) -> contiguous cache
    trunk_paths: frozenset
    head_paths: Optional[frozenset] = None
    head_signature: Optional[tuple] = None
    bank_head: Optional[Callable] = None  # (bank_params, hidden) -> (N, ...)
    # chunked prompt admission: (params, pool, tables, lengths, tokens (B, C))
    # -> (hidden (B, C, d), pool), C sequential trunk steps in one dispatch
    prefill_chunk: Optional[Callable] = None


class MergeableAdapter:
    """One model family's view of the merge pipeline.

    Capability tiers: **merge** (every adapter: ``records``), **calibrate**
    (``can_calibrate``: ``calibration_batch`` + ``layer_activations`` for
    the CKA scorer, ``loss``/``accuracy`` for retraining through
    ``registered``), **split-serve** (``can_split``) and **decode-serve**
    (``can_decode``)."""

    name: str = "adapter"
    family: Optional[str] = None  # mixed-zoo trunk eligibility (core.policy)
    can_calibrate: bool = False
    can_split: bool = False
    can_decode: bool = False

    def __init__(self):
        self._bound: dict = {}  # (kind, cfg) -> cached cfg-bound artifact

    def default_config(self):
        raise NotImplementedError(f"{self.name}: no default config bound")

    def init(self, cfg, seed: int = 0, device=None):
        raise NotImplementedError(f"{self.name}: no init bound")

    def forward(self, cfg, params, x):
        raise NotImplementedError(f"{self.name}: no forward bound")

    def loss(self, cfg, params, batch):
        raise NotImplementedError(f"{self.name}: no loss bound")

    def forward_batch(self, cfg, params, batch: dict):
        """Logits for a calibration batch in the family's batch layout."""
        return self.forward(cfg, params, batch["tokens"])

    def accuracy(self, cfg, params, batch):
        """Argmax-vs-labels accuracy over the real vocab (masked rows out)."""
        logits = self.forward_batch(cfg, params, batch)
        vocab = getattr(cfg, "vocab_size", None)
        if vocab:
            logits = logits[..., :vocab]
        correct = (logits.argmax(-1) == batch["labels"]).float()
        mask = batch.get("mask")
        if mask is not None:
            return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return torch.mean(correct)

    def records(self, cfg, params, model_id: str) -> list:
        """LayerRecords for grouping (kind-from-path, shape, dtype)."""
        return records_from_params(params, model_id)

    # -- calibrate ------------------------------------------------------------

    def calibration_batch(self, cfg, key, n: int) -> dict:
        """A synthetic batch usable by ``loss``/``accuracy``/
        ``layer_activations`` — run the SAME batch through every candidate
        model so CKA compares responses to identical inputs."""
        raise NotImplementedError(f"{self.name}: no calibration support")

    def layer_activations(self, cfg, params, batch: dict) -> dict:
        """{layer_key: (N, ...) float32 numpy} where ``layer_key`` is the
        param-path prefix ``core.policy.default_layer_key`` maps record
        paths onto."""
        raise NotImplementedError(f"{self.name}: no calibration support")

    def registered(self, cfg, model_id: str, key, n_batches: int = 2,
                   batch_size: int = 8, accuracy_target: float = 0.9,
                   original_accuracy: Optional[float] = None, device=None):
        """A ``RegisteredModel`` whose loss/accuracy/data all come from this
        adapter — what makes ``StagedPlanner`` + ``MergeTrainer`` retraining
        family-agnostic.  ``key`` is a seed (drawn on ``device``) or a
        generator."""
        from repro_torch.core.validation import RegisteredModel

        gen = _generator(key, device)
        train = [self.calibration_batch(cfg, gen, batch_size) for _ in range(n_batches)]
        val = self.calibration_batch(cfg, gen, batch_size)
        return RegisteredModel(
            model_id,
            lambda p, b: self.loss(cfg, p, b),
            lambda p, b: self.accuracy(cfg, p, b),
            lambda epoch: train, val, accuracy_target, original_accuracy,
        )

    def eval_params(self, cfg):
        """Parameter tree of ``meta`` tensors — paths, shapes and dtypes
        without allocating weights."""
        return self.init(cfg, 0, device="meta")

    def split(self, cfg) -> PrefixSplit:
        """Prefix/suffix serving split, cached per cfg.  Splits that declare
        ``suffix_paths`` get a ``suffix_signature`` filled in, so every
        splittable adapter is bank-eligible."""
        key = ("split", cfg)
        sp = self._bound.get(key)
        if sp is None:
            sp = self._build_split(cfg)
            if sp.suffix_paths is not None and sp.suffix_signature is None:
                sp = dataclasses.replace(sp, suffix_signature=self.suffix_signature(cfg, sp))
            self._bound[key] = sp
        return sp

    def suffix_signature(self, cfg, sp: Optional[PrefixSplit] = None):
        """Adapter name, the cfg identity and (path, shape, dtype) of every
        suffix leaf.  The cfg term matters: the bank runs every member
        through the LEAD member's suffix closure, so heads that are merely
        shape-congruent but differ under their cfg must never compare equal."""
        sp = self.split(cfg) if sp is None else sp
        if sp.suffix_paths is None:
            return None
        flat = flatten_paths(self.eval_params(cfg))
        return (self.name, cfg, tuple(sorted(
            (p, tuple(flat[p].shape), dtype_name(flat[p].dtype))
            for p in sp.suffix_paths)))

    def _build_split(self, cfg) -> PrefixSplit:
        raise NotImplementedError(f"{self.name}: no prefix/suffix split")

    def decode_split(self, cfg) -> DecodeSplit:
        """Streaming-decode split, cached per cfg like :meth:`split`, so all
        members of a group hand the decoder the same function objects."""
        key = ("decode_split", cfg)
        ds = self._bound.get(key)
        if ds is None:
            ds = self._build_decode_split(cfg)
            self._bound[key] = ds
        return ds

    def _build_decode_split(self, cfg) -> DecodeSplit:
        raise NotImplementedError(f"{self.name}: no streaming decode split")

    def bound_forward(self, cfg) -> Callable:
        """(params, x) forward closure, cached per cfg."""
        key = ("forward", cfg)
        fn = self._bound.get(key)
        if fn is None:
            def fn(params, x, _self=self, _cfg=cfg):
                return _self.forward(_cfg, params, x)

            self._bound[key] = fn
        return fn


class SmallCNNAdapter(MergeableAdapter):
    """The paper's reduced-scale vision models."""

    name = "small_cnn"
    family = "small_cnn"
    can_calibrate = True
    can_split = True

    def default_config(self):
        return vision.SmallCNNConfig(task="classification", n_classes=4,
                                     depth=1, width=8, n_stages=2)

    def init(self, cfg, seed: int = 0, device=None):
        return vision.init_small_cnn(cfg, seed, device)

    def forward(self, cfg, params, x):
        return vision.small_cnn_forward(cfg, params, x)

    def loss(self, cfg, params, batch):
        return vision.small_cnn_loss(cfg, params, batch)

    def accuracy(self, cfg, params, batch):
        return vision.small_cnn_accuracy(cfg, params, batch)

    def calibration_batch(self, cfg, key, n: int) -> dict:
        gen = _generator(key)
        dev = gen.device
        batch = {"images": torch.randn((n, 32, 32, 3), generator=gen, device=dev
                                       ).to(torch_dtype(cfg.dtype))}
        if cfg.task == "classification":
            batch["labels"] = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev)
        else:
            g, A = 32 // (2 ** (cfg.n_stages - 1)), cfg.n_anchors
            batch["cls_targets"] = torch.randint(0, cfg.n_classes, (n, g, g, A),
                                                 generator=gen, device=dev)
            batch["loc_targets"] = torch.randn((n, g, g, A * 4), generator=gen, device=dev)
        return batch

    def layer_activations(self, cfg, params, batch: dict) -> dict:
        return vision.small_cnn_layer_activations(cfg, params, batch["images"])

    def _build_split(self, cfg) -> PrefixSplit:
        ep = self.eval_params(cfg)

        def prefix(params, x, _cfg=cfg):
            return vision.small_cnn_features(_cfg, params, x)

        def suffix(params, feats, _cfg=cfg):
            return vision.small_cnn_head(_cfg, params, feats)

        def bank_suffix(bank_params, feats, _cfg=cfg):
            return vision.small_cnn_bank_head(_cfg, bank_params, feats)

        return PrefixSplit(prefix, suffix, vision.small_cnn_prefix_paths(cfg, ep),
                           suffix_paths=vision.small_cnn_suffix_paths(cfg, ep),
                           bank_suffix=bank_suffix)


class _TokenLMAdapter(MergeableAdapter):
    """Token LMs split at the final norm: the trunk (embedding + blocks) is
    the mergeable prefix, the head (final norm + unembedding) the private
    suffix.  ``module`` is the family's model module, ``init_pool_fn`` its
    paged-pool constructor.  One calibration-batch layout for every family,
    so CKA compares every candidate's response to identical inputs."""

    can_calibrate = True
    can_split = True
    can_decode = True
    module = None
    init_pool_fn = None

    def init(self, cfg, seed: int = 0, device=None):
        return self.module.init(cfg, seed, device)

    def forward(self, cfg, params, x):
        """tokens (B, S) -> logits (B, S, V), composed as ``head(trunk(x))``
        (bitwise the serving split's composition)."""
        return self.module.head(cfg, params, self.module.trunk(cfg, params, x))

    def loss(self, cfg, params, batch):
        return self.module.loss_fn(cfg, params, batch)

    def layer_activations(self, cfg, params, batch: dict) -> dict:
        return self.module.layer_activations(cfg, params, batch["tokens"])

    def decode_config(self, cfg):
        """The config the decode split binds (the moe family's differs)."""
        return cfg

    def calibration_batch(self, cfg, key, n: int, seq: int = 8) -> dict:
        """One layout for every token LM, so CKA compares every candidate's
        response to identical inputs."""
        gen = _generator(key)
        toks = torch.randint(0, cfg.vocab_size, (n, seq + 1), generator=gen,
                             device=gen.device, dtype=torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _build_split(self, cfg) -> PrefixSplit:
        mod = self.module
        ep = self.eval_params(cfg)
        paths = mod.trunk_paths(ep)

        def prefix(params, x, _cfg=cfg):
            return mod.trunk(_cfg, params, x)

        def suffix(params, feats, _cfg=cfg):
            return mod.head(_cfg, params, feats)

        if cfg.tie_embeddings:
            # tied heads read the shared embed table: banking would stack
            # the model's largest tensor N times — stay per-member
            return PrefixSplit(prefix, suffix, paths)

        def bank_suffix(bank_params, feats, _cfg=cfg):
            return mod.bank_head(_cfg, bank_params, feats)

        return PrefixSplit(prefix, suffix, paths,
                           suffix_paths=mod.head_paths(ep),
                           bank_suffix=bank_suffix)

    def _build_decode_split(self, cfg) -> DecodeSplit:
        mod, pool_fn = self.module, self.init_pool_fn
        sp = self.split(cfg)  # the same trunk/head congruence tiers
        cfg = self.decode_config(cfg)

        def trunk_step(params, pool, tables, lengths, tokens, _cfg=cfg):
            return mod.paged_trunk_step(_cfg, params, pool, tables, lengths, tokens)

        def head_fn(params, hidden, _cfg=cfg):
            return mod.head(_cfg, params, hidden)

        def step(params, pool, tables, lengths, tokens, _cfg=cfg):
            return mod.paged_decode_step(_cfg, params, pool, tables, lengths, tokens)

        def step_unpaged(params, cache, tokens, _cfg=cfg):
            return mod.decode_step(_cfg, params, cache, tokens)

        def init_pool(num_pages, page_size, device=None, _cfg=cfg):
            return pool_fn(_cfg, num_pages, page_size, device=device)

        def init_cache(batch, max_len, device=None, _cfg=cfg):
            return mod.init_cache(_cfg, batch, max_len, device=device)

        bank = None
        if sp.bank_suffix is not None:
            def bank(bank_params, hidden, _cfg=cfg):
                return mod.bank_head(_cfg, bank_params, hidden)

        def prefill_chunk(params, pool, tables, lengths, tokens, _cfg=cfg):
            return mod.paged_prefill_chunk(_cfg, params, pool, tables, lengths, tokens)

        return DecodeSplit(trunk_step, head_fn, step, step_unpaged, init_pool, init_cache,
                           sp.prefix_paths, head_paths=sp.suffix_paths,
                           head_signature=sp.suffix_signature, bank_head=bank,
                           prefill_chunk=prefill_chunk)


class DenseLMAdapter(_TokenLMAdapter):
    """Dense decoder-only transformers with per-layer blocks."""

    name = "dense"
    family = "dense"
    module = transformer
    init_pool_fn = staticmethod(transformer.init_kv_pool)

    def default_config(self):
        return transformer.DenseLMConfig(
            name="tiny-lm", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=64, vocab_multiple=32,
            tie_embeddings=False,
        )


class SSMAdapter(_TokenLMAdapter):
    """Mamba selective-state-space LMs: the recurrence runs through
    ``ops.mamba_scan``.  The decode state is per-layer ``(h (di, n), conv
    (d_conv-1, di))`` instead of a KV cache, and lives wholly in each
    request's FIRST page slot of the state pool."""

    name = "ssm"
    family = "ssm"
    module = ssm
    init_pool_fn = staticmethod(ssm.init_state_pool)

    def default_config(self):
        return ssm.MambaConfig(
            name="tiny-mamba", n_layers=2, d_model=32, d_inner=64, d_state=8,
            d_conv=4, dt_rank=8, vocab_size=64, vocab_multiple=32,
            tie_embeddings=False,
        )


class GriffinAdapter(_TokenLMAdapter):
    """Griffin recurrent/local-attention hybrids: the RG-LRU runs through
    ``ops.rg_lru_scan`` and the local attention through
    ``ops.flash_attention(window=...)``.  Streaming decode carries the
    recurrent ``(h, conv)`` state plus a ring-buffer KV of ``window`` slots
    per attention layer, all in each request's FIRST page slot of the state
    pool; decode attends over the ring in plain torch."""

    name = "hybrid"
    family = "hybrid"
    module = griffin
    init_pool_fn = staticmethod(griffin.init_state_pool)

    def default_config(self):
        return griffin.GriffinConfig(
            name="tiny-griffin", n_layers=3, pattern=("rec", "rec", "attn"),
            d_model=32, d_rnn=32, n_heads=2, n_kv_heads=1, head_dim=16,
            d_ff=64, vocab_size=64, vocab_multiple=32, window=8,
            tie_embeddings=False,
        )

    def _build_decode_split(self, cfg) -> DecodeSplit:
        def init_cache(batch, max_len, device=None, _cfg=cfg):
            # the paged pool rings exactly `window` KV slots per request, the
            # unpaged cache min(window, max_len): paged == unpaged replay
            # (serving.decode.verify_bitwise) therefore needs the full ring
            if _cfg.window > max_len:
                raise ValueError(
                    f"hybrid: streaming decode needs window <= max_len "
                    f"(window={_cfg.window}, max_len={max_len})")
            return griffin.init_cache(_cfg, batch, max_len, device=device)

        return dataclasses.replace(super()._build_decode_split(cfg), init_cache=init_cache)


class MoEAdapter(_TokenLMAdapter):
    """Mixture-of-experts LMs.  The serving surfaces discard the router aux
    loss (``forward`` gives logits only; ``loss`` adds the aux term through
    ``moe.loss_fn``).  Streaming decode binds ``group_size=1``, so routing is
    per token: each token is its own capacity group and is never dropped,
    which makes paged and unpaged decode agree."""

    name = "moe"
    family = "moe"
    module = moe
    init_pool_fn = staticmethod(moe.init_kv_pool)

    def default_config(self):
        return moe.MoELMConfig(
            name="tiny-moe", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            head_dim=16, vocab_size=64, vocab_multiple=32, n_experts=4,
            top_k=2, n_shared_experts=1, d_ff_expert=16, d_ff_dense=64,
            first_dense_layers=0, group_size=1, tie_embeddings=False,
        )

    def decode_config(self, cfg):
        return dataclasses.replace(cfg, group_size=1)


class FamilyAdapter(MergeableAdapter):
    """Records-only adapter over a :class:`ModelFamily`: the family merges
    through the shared records path (over params or ``meta`` trees), and
    ``accuracy`` works from its batch layout; calibration and the serving
    splits need a family-specific adapter."""

    def __init__(self, fam: ModelFamily):
        super().__init__()
        self.fam = fam
        self.name = fam.name
        self.family = fam.name

    def default_config(self):
        return self.fam.config_cls()

    def init(self, cfg, seed: int = 0, device=None):
        return self.fam.init(cfg, seed, device)

    def forward(self, cfg, params, x):
        return self.fam.forward(cfg, params, x)

    def loss(self, cfg, params, batch):
        return self.fam.loss(cfg, params, batch)

    def forward_batch(self, cfg, params, batch: dict):
        """The text logits of the family's batch layout (module docstring)."""
        if self.name == "vlm":
            logits = self.fam.forward(cfg, params, batch["tokens"], batch["patch_embeds"])
            return logits[:, batch["patch_embeds"].shape[1]:, :]
        if self.name == "encdec":
            return self.fam.forward(cfg, params, batch["src_embeds"], batch["tokens"])
        out = self.fam.forward(cfg, params, batch["tokens"])
        return out[0] if isinstance(out, tuple) else out


ADAPTERS: dict = {}


def register_adapter(adapter: MergeableAdapter) -> MergeableAdapter:
    ADAPTERS[adapter.name] = adapter
    return adapter


def get_adapter(name: str) -> MergeableAdapter:
    return ADAPTERS[name]


register_adapter(SmallCNNAdapter())
register_adapter(DenseLMAdapter())
register_adapter(SSMAdapter())
register_adapter(GriffinAdapter())
register_adapter(MoEAdapter())
for _name in ("vlm", "encdec"):
    register_adapter(FamilyAdapter(FAMILIES[_name]))
