"""Distributed-training driver with fault tolerance (the port of
``examples/train_multipod.py``):

    PYTHONPATH=src python -m repro_torch.examples.train_multipod [--arch olmo-1b] [--device cpu]

Trains a reduced config (a dense arch scaled up to 4 layers of width 256)
with the same code path a multi-pod deployment takes (``Trainer``:
microbatched step, optional int8 gradient compression), demonstrating
checkpoint and restart (kill-resume) and the straggler and heartbeat
monitors.  On ``cuda`` a family whose loss calls a Hopper kernel (every
token LM) raises before its first step, since the kernels have no backward:
pass ``--arch seamless-m4t-medium`` there.
"""
import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.registry import load_arch
from repro_torch.data.synthetic import LMStream
from repro_torch.models.registry import get_family
from repro_torch.runtime.monitors import HeartbeatMonitor, StragglerMonitor
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.trainer import Trainer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths

CKPT_EVERY = 50


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = load_arch(args.arch)
    cfg = dataclasses.replace(
        mod.smoke_config(), n_layers=4, d_model=256, d_ff=1024, vocab_size=8192,
    ) if mod.FAMILY in ("dense",) else mod.smoke_config()
    fam = get_family(mod.FAMILY)
    params = fam.init(cfg, seed=0, device=device)
    n = sum(x.numel() for x in flatten_paths(params).values())
    print(f"arch={args.arch} family={mod.FAMILY} params={n/1e6:.1f}M")

    ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
    stream = LMStream(cfg.vocab_size, batch=8, seq_len=64, device=device)

    def batches():
        step = 0
        while True:
            yield stream.batch_at(step)
            step += 1

    def make_trainer():
        return Trainer(
            loss_fn=lambda p, b: fam.loss(cfg, p, b),
            optimizer=AdamW(lr=warmup_cosine(3e-4, 20, args.steps)),
            compress_grads=args.compress_grads,
            ckpt_manager=CheckpointManager(ckpt_dir),
            ckpt_every=CKPT_EVERY,
            monitors=(HeartbeatMonitor(1), StragglerMonitor()),
        )

    try:
        print(f"phase 1: train to step {args.steps // 2} then 'crash'")
        out = make_trainer().fit(params, batches(), args.steps // 2)
        for h in out["history"][-3:]:
            print(f"   step {h['step']:4d} loss {h['loss']:.4f}")

        resumed = CheckpointManager(ckpt_dir).latest_step()
        print(f"phase 2: restart from the step {resumed} checkpoint, resume to the end")
        # a fresh init; the trainer restores the latest checkpoint and resumes
        # from its step (the data iterator restarts at batch 0, as the JAX
        # package's example does)
        out = make_trainer().fit(fam.init(cfg, seed=0, device=device), batches(), args.steps)
        for h in out["history"][-3:]:
            print(f"   step {h['step']:4d} loss {h['loss']:.4f}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
