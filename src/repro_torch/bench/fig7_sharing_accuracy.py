"""Paper Fig 7 (the port of ``benchmarks/fig7_sharing_accuracy.py``): the
sharing-vs-accuracy tension — REAL joint retraining at reduced scale.  Two
pretrained small CNNs share an increasing number of layers (start->end, as
in the paper); accuracy after a fixed retraining budget degrades as the
share count grows.

    PYTHONPATH=src python -m repro_torch.bench.fig7_sharing_accuracy [--device cuda|cpu]

:func:`sharing_curve` takes one :class:`Fig7Inputs`: the two members'
pretrained params and their streams.  :func:`numpy_inputs` makes the port's own
(``VisionStream`` pools from numpy, each member pretrained by
:func:`pretrain`); the CPU parity tests inject the JAX bench's pretrained
params and its streams' batches.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.bench.common import emit
from repro_torch.core import LayerGroup, ParamStore, RegisteredModel, enumerate_groups
from repro_torch.core import records_from_params, validate
from repro_torch.core.merging import MergeTrainer, joint_grads
from repro_torch.data.synthetic import VisionStream
from repro_torch.models import vision as VI
from repro_torch.train.optimizer import AdamW
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, unflatten_paths

CFG = VI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)
MIDS = ("A", "B")


@dataclasses.dataclass
class Fig7Inputs:
    """``params`` ({"A", "B"}: pretrained small_cnn params) and ``streams``
    (the same keys: objects with ``batch_at(step)`` and ``epoch(e,
    n_batches)`` giving batches on the params' device)."""

    params: dict
    streams: dict


def pretrain(cfg, params: dict, stream, steps: int = 280, lr: float = 3e-3) -> dict:
    """``steps`` AdamW steps of ``small_cnn_loss`` on the stream's batches in
    order (the reference's ``_pretrain``)."""
    opt = AdamW(lr=lr)
    flat = flatten_paths(params)
    st = opt.init(flat)
    bindings = {"m": {p: p for p in flat}}  # one model, each path its own key
    loss_fns = {"m": lambda q, b: VI.small_cnn_loss(cfg, q, b)}
    for step in range(steps):
        _, grads = joint_grads(bindings, loss_fns, flat, {"m": stream.batch_at(step)})
        with torch.no_grad():
            flat, st = opt.update(grads, st, flat)
    return unflatten_paths(flat)


def numpy_inputs(device=None) -> Fig7Inputs:
    """The reference's streams (4 classes, batch 32, seeds 7 and 8) and
    inits (seed ``ord(member)``), pretrained on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    streams = {m: VisionStream(4, 32, seed=7 + i, device=dev) for i, m in enumerate(MIDS)}
    params = {m: pretrain(CFG, VI.init_small_cnn(CFG, seed=ord(m), device=dev), s)
              for m, s in streams.items()}
    return Fig7Inputs(params, streams)


def sharing_curve(inp: Fig7Inputs, budget_epochs: int = 8,
                  n_shared: Optional[Sequence[int]] = None) -> list:
    """One row a share count (default 0, 2, 4, 6, 8 and every layer):
    the first ``n`` layers (start->end) merged across the two members,
    then jointly retrained for ``budget_epochs`` at an unreachable target
    (the whole budget runs); each member's accuracy relative to its
    pretrained one on its validation batch."""
    params, streams = inp.params, inp.streams
    val = {m: s.batch_at(0) for m, s in streams.items()}
    with torch.no_grad():
        orig = {m: float(VI.small_cnn_accuracy(CFG, params[m], val[m])) for m in params}

    recs = {m: records_from_params(params[m], m) for m in params}
    # order layers start -> end (paper shares from the model origin outward)
    paths_in_order = [r.path for r in sorted(recs["A"], key=lambda r: r.position)]

    rows = []
    for n in (0, 2, 4, 6, 8, len(paths_in_order)) if n_shared is None else n_shared:
        n = min(n, len(paths_in_order))
        store = ParamStore.from_models(dict(params))
        share_paths = set(paths_in_order[:n])
        groups = [g for g in enumerate_groups(recs["A"] + recs["B"])
                  if any(r.path in share_paths for r in g.records)]
        for g in groups:
            sub = LayerGroup(g.signature, [r for r in g.records if r.path in share_paths])
            if len(sub.records) >= 2:
                store.merge_group(sub)
        regs = [
            RegisteredModel(
                m, lambda p, b: VI.small_cnn_loss(CFG, p, b),
                lambda p, b: VI.small_cnn_accuracy(CFG, p, b),
                lambda e, s=streams[m]: s.epoch(e, n_batches=4),
                val[m], accuracy_target=2.0,  # unreachable: run full budget
                original_accuracy=orig[m],
            )
            for m in params
        ]
        trainer = MergeTrainer(max_epochs=budget_epochs, optimizer=AdamW(lr=2e-3),
                               ef_epochs=10**9)
        trainer.train(store, regs)
        accs = validate(store, regs)
        rows.append({
            "n_shared_layers": n,
            "acc_A_rel": accs["A"] / orig["A"],
            "acc_B_rel": accs["B"] / orig["B"],
            "min_rel_acc": min(accs[m] / orig[m] for m in accs),
        })
    return rows


def run(device=None) -> dict:
    return emit("fig7_sharing_accuracy", sharing_curve(numpy_inputs(device)), {
        "paper": "accuracy degrades as shared-layer count grows; breaking "
                 "point varies per pair (5-25 layers at 95%)",
    })


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
