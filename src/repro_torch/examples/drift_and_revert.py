"""Drift detection and revert, paper §5.1 steps 4-5 (the port of
``examples/drift_and_revert.py``).

    PYTHONPATH=src python -m repro_torch.examples.drift_and_revert [--device cpu]

Deploys a merged pair, simulates content drift on one feed (the label
function changes), and shows the DriftMonitor catching the breach and
reverting that query to its original weights while the other keeps its
merged (cheap) configuration.  No Hopper kernel is called.
"""
import argparse

from repro_torch.core import ParamStore, RegisteredModel, enumerate_groups, records_from_params
from repro_torch.core.drift import DriftMonitor
from repro_torch.data.synthetic import VisionStream
from repro_torch.models import vision as VI
from repro_torch.utils.device import resolve_device

CFG = VI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)


def run(cfg, pa: dict, pb: dict, frames: dict) -> dict:
    """Merge the first three layer groups of A and B, check ``frames``
    ({"A": batch, "B": batch}), revert a breach; returns what it printed."""
    originals = {"A": pa, "B": pb}
    store = ParamStore.from_models(dict(originals))
    recs = records_from_params(pa, "A") + records_from_params(pb, "B")
    for g in enumerate_groups(recs)[:3]:
        store.merge_group(g)
    shared_before = len(store.shared_keys())
    print(f"deployed merged config: {shared_before} shared buffers")

    regs = [
        RegisteredModel(
            m, lambda p, b: VI.small_cnn_loss(cfg, p, b),
            lambda p, b: VI.small_cnn_accuracy(cfg, p, b),
            lambda e: [], None, accuracy_target=0.4,
            original_accuracy=0.5,
        )
        for m in ("A", "B")
    ]
    mon = DriftMonitor(store, originals, regs)
    report = mon.check(frames)
    print(f"sampled-frame accuracies: { {k: round(v, 3) for k, v in report.checked.items()} }")
    print(f"breached: {report.breached or 'none'}")
    out = dict(shared_before=shared_before, checked=dict(report.checked),
               breached=set(report.breached), reverted=set(), shared_after=shared_before)
    if report.breached:
        mon.revert(report)
        out.update(reverted=set(report.reverted), shared_after=len(store.shared_keys()))
        print(f"reverted to original weights: {report.reverted}")
        print(f"shared buffers remaining: {out['shared_after']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pa = VI.init_small_cnn(CFG, seed=0, device=device)
    pb = VI.init_small_cnn(CFG, seed=1, device=device)
    # periodic sampled frames from the edge: B's content drifted (new seed)
    frames = {"A": VisionStream(4, 64, seed=0, device=device).batch_at(0),
              "B": VisionStream(4, 64, seed=999, device=device).batch_at(0)}
    return run(CFG, pa, pb, frames)


if __name__ == "__main__":
    main()
