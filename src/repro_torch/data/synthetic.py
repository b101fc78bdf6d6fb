"""Deterministic synthetic data (the port of ``repro.data.synthetic``; the
sharded iterator waits for the sharded-training slice).

``batch_at(step)`` is a pure function of (seed, step), so a restart
reproduces the exact stream.  Batches are tensors on the stream's
``device`` (default ``cuda``, as every entry point of the port).

``LMStream`` draws from numpy's ``default_rng`` exactly as the JAX package
does, so both packages yield the same tokens.  The JAX package's
``VisionStream`` draws its image pool from ``jax.random``, which torch
cannot reproduce: this one builds the same kind of pool (Gaussian images,
labels from a random projection of 8x8 block means) from numpy's
``default_rng``, so its images differ from the JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LMStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    order: int = 2  # Markov order
    device: Optional[str] = None

    def _chain(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish transition over a hashed context
        return rng.integers(0, self.vocab_size, size=(4096,), dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        """(tokens, labels) with labels = next-token targets."""
        table = self._chain()
        rng = np.random.default_rng((self.seed, step))
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=B)
        ctx = toks[:, 0].copy()
        for t in range(1, S + 1):
            nxt = table[(ctx * 1103515245 + t) % len(table)] % self.vocab_size
            noise = rng.random(B) < 0.1
            nxt = np.where(noise, rng.integers(0, self.vocab_size, size=B), nxt)
            toks[:, t] = nxt
            ctx = (ctx * 31 + nxt) % (1 << 31)
        dev = resolve_device(self.device)
        return {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class VisionStream:
    """Finite synthetic vision dataset: a fixed pool of images with
    linearly separable labels; batches cycle the pool deterministically, so
    the stream is stateless-resumable AND learnable at small-CNN scale."""

    n_classes: int
    batch: int
    img: int = 32
    seed: int = 0
    task: str = "classification"
    grid: int = 8
    n_anchors: int = 4
    pool_size: int = 256
    device: Optional[str] = None

    @functools.cached_property
    def _pool(self) -> dict:
        rng = np.random.default_rng(self.seed)
        P = self.pool_size
        imgs = rng.standard_normal((P, self.img, self.img, 3)).astype(np.float32)
        # labels derive from block-averaged features (8x8 means), which
        # convolutions + pooling can represent
        g = self.img // 8
        feats = imgs.reshape(P, g, 8, g, 8, 3).mean((2, 4))
        proj = np.random.default_rng(self.seed + 10_000).standard_normal(
            (g * g * 3, self.n_classes)).astype(np.float32)
        labels = np.argmax(feats.reshape(P, -1) @ proj, -1)
        if self.task == "classification":
            pool = {"images": imgs, "labels": labels}
        else:
            G, A = self.grid, self.n_anchors
            pool = {"images": imgs,
                    "cls_targets": np.broadcast_to(labels[:, None, None, None], (P, G, G, A)),
                    "loc_targets": (rng.standard_normal((P, G, G, A * 4)) * 0.1
                                    ).astype(np.float32)}
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in pool.items()}

    def batch_at(self, step: int) -> dict:
        pool = self._pool
        idx = (step * self.batch + torch.arange(self.batch)) % self.pool_size
        return {k: v[idx.to(v.device)] for k, v in pool.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def epoch(self, epoch_idx: int, n_batches: int = 4) -> list:
        return [self.batch_at(epoch_idx * n_batches + i) for i in range(n_batches)]
