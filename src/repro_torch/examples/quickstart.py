"""Quickstart: register two models, merge them, measure the savings (the
port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Pretrains two small same-architecture vision models on different
synthetic feeds, runs GEMEL's incremental merging with real joint
retraining, and prints the memory savings and the accuracy audit.  The
small CNN's forward and loss call no Hopper kernel, so on ``cuda`` the
pretraining and ``MergeTrainer`` train on the card.
"""
import argparse

import torch

from repro_torch.bench.fig7_sharing_accuracy import pretrain
from repro_torch.core import IncrementalMerger, ParamStore, RegisteredModel, records_from_params
from repro_torch.core.merging import MergeTrainer
from repro_torch.core.validation import meets_targets, validate
from repro_torch.data.synthetic import VisionStream
from repro_torch.models import vision as VI
from repro_torch.train.optimizer import AdamW
from repro_torch.utils.device import resolve_device
from repro_torch.utils.ids import stable_seed

CFG = VI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)


def run(cfg, inits: dict, streams: dict, pretrain_steps: int = 280,
        max_epochs: int = 20) -> dict:
    """Pretrain each member from ``inits[mid]`` on ``streams[mid]``, merge
    with joint retraining, audit; returns what it printed."""
    print("== 1. register two queries (same arch, different feeds) ==")
    params, orig_acc = {}, {}
    for mid, stream in streams.items():
        params[mid] = pretrain(cfg, inits[mid], stream, steps=pretrain_steps)
        with torch.no_grad():
            orig_acc[mid] = float(VI.small_cnn_accuracy(cfg, params[mid], stream.batch_at(0)))
        print(f"   {mid}: pretrained accuracy {orig_acc[mid]:.3f}")

    print("\n== 2. incremental merging (memory-forward, AIMD) ==")
    store = ParamStore.from_models(params)
    before = store.resident_bytes()
    regs = [
        RegisteredModel(
            mid, lambda p, b: VI.small_cnn_loss(cfg, p, b),
            lambda p, b: VI.small_cnn_accuracy(cfg, p, b),
            lambda e, s=streams[mid]: s.epoch(e, n_batches=4),
            streams[mid].batch_at(0),
            accuracy_target=0.9, original_accuracy=orig_acc[mid],
        )
        for mid in params
    ]
    recs = sum((records_from_params(params[m], m) for m in params), [])
    merger = IncrementalMerger(
        store, regs, recs, MergeTrainer(max_epochs=max_epochs, optimizer=AdamW(lr=2e-3)),
        min_group_bytes=4096,
    )
    result = merger.run()
    events = []
    for ev in result.events:
        accs = {k: f"{v:.2f}" for k, v in ev.accuracies.items()}
        print(f"   +{ev.time:5.1f}s shared {ev.group_signature[0]:22s} "
              f"saved {ev.saved_bytes/1024:.0f} KiB  acc {accs}")
        events.append(dict(group=ev.group_signature[0], saved_bytes=ev.saved_bytes,
                           accuracies=dict(ev.accuracies)))

    print("\n== 3. audit ==")
    accs = validate(store, regs)
    after = store.resident_bytes()
    met = meets_targets(accs, regs)
    print(f"   resident bytes: {before} -> {after} "
          f"({result.fraction_saved:.1%} saved)")
    print(f"   committed {result.committed}, discarded {result.discarded}")
    print(f"   accuracies {accs} — targets met: {met}")
    return dict(original_accuracy=orig_acc, events=events, resident_bytes_before=before,
                resident_bytes_after=after, fraction_saved=result.fraction_saved,
                committed=result.committed, discarded=result.discarded, accuracies=accs,
                targets_met=met)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    streams = {"cam-A": VisionStream(4, 32, seed=7, device=device),
               "cam-B": VisionStream(4, 32, seed=8, device=device)}
    inits = {mid: VI.init_small_cnn(CFG, seed=stable_seed(mid), device=device)
             for mid in streams}
    return run(CFG, inits, streams)


if __name__ == "__main__":
    main()
