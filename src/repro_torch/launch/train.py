"""Training launcher (the port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--device cuda|cpu] [...]

Runs a real reduced-scale training loop (the arch's smoke config) on one
device.  The batch is the arch's train ``input_specs`` filled from
``LMStream`` tokens; inputs that are not tokens (frame or patch
embeddings) are drawn from a generator seeded by the step.  On ``cuda`` a
family whose loss calls a Hopper kernel (every token LM: attention, scans,
the suffix bank) raises before its first step: the kernels have no
backward, and nothing falls back to the plain versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ShapeSpec, input_specs
from repro_torch.configs.registry import load_arch
from repro_torch.data.synthetic import LMStream
from repro_torch.models.registry import get_family
from repro_torch.runtime.monitors import HeartbeatMonitor, StragglerMonitor
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer
from repro_torch.utils.device import resolve_device


def batches(cfg, family: str, batch: int, seq: int, device: torch.device):
    """The arch's train batches, step after step."""
    specs = input_specs(cfg, family, ShapeSpec("cli", seq, batch, "train"))
    stream = LMStream(cfg.vocab_size, batch, seq, device=device)
    step = 0
    while True:
        base = stream.batch_at(step)
        out = {}
        for k, s in specs.items():
            if k in base:
                out[k] = base[k][:, : s.shape[1]]
            elif s.dtype == torch.int32:
                out[k] = base["tokens"][:, : s.shape[1]]
            else:
                gen = torch.Generator(device=device).manual_seed(step)
                out[k] = torch.randn(s.shape, generator=gen, device=device)
        yield out
        step += 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = load_arch(args.arch)
    cfg = mod.smoke_config()
    fam = get_family(mod.FAMILY)
    params = fam.init(cfg, seed=0, device=device)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(
        loss_fn=lambda p, b: fam.loss(cfg, p, b),
        optimizer=AdamW(lr=args.lr),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        ckpt_manager=ckpt,
        ckpt_every=args.ckpt_every,
        monitors=(HeartbeatMonitor(1), StragglerMonitor()),
    )
    out = trainer.fit(params, batches(cfg, mod.FAMILY, args.batch, args.seq, device), args.steps)
    for h in out["history"]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} gnorm {h['grad_norm']:.3f}")
    return out


if __name__ == "__main__":
    main()
