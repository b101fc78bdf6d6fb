"""Pieces of ``benchmarks/lm_merging.py`` the drift benchmark needs: the
fine-tune emulation ``_perturb`` and the post-swap serving check
``verify_bitwise`` (the rest of the LM merging bench is still to port)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.workload import deadline_microbatches, pad_stack
from repro_torch.utils.tree import flatten_paths, unflatten_paths

BUCKETS = (1, 2, 4)


def _perturb(params, seed, scale, select=None):
    """Gaussian-perturb leaves (optionally only paths accepted by
    ``select``) — emulates fine-tuning divergence without a training run.
    The noise is drawn with numpy (``default_rng(seed)``, leaves in sorted
    path order) and added in each leaf's dtype on its device; unselected
    leaves pass through as the same tensors."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in sorted(flatten_paths(params).items()):
        if select is None or select(path):
            noise = torch.from_numpy(rng.standard_normal(tuple(leaf.shape), dtype=np.float32))
            leaf = leaf + scale * noise.to(device=leaf.device, dtype=leaf.dtype)
        out[path] = leaf
    return unflatten_paths(out)


@torch.no_grad()
def verify_bitwise(eng, store, adapter, cfg, buckets=BUCKETS, since=0, gaps=None) -> tuple:
    """Served rows against a replay of the engine's own dispatch on the same
    bindings: each group's micro-batches are rebuilt exactly
    (``deadline_microbatches`` is deterministic and a group drains in one
    visit), then shared groups run the prefix once on the same padded batch
    and the same suffix dispatch as the engine — the suffix bank for a
    micro-batch with rows of several members of a bankable group, otherwise
    each member's head on its rows gathered and padded onto the bucket
    ladder — and singletons the composed forward.  ``since`` restricts the
    check to completions appended after that index.  Returns ``(bitwise,
    bank_gap)``: ``bitwise`` is True iff every row equals its replay
    bitwise (``gaps``, when a list, receives ``(instance_id, meta,
    max_abs_gap)`` for each row that does not); ``bank_gap`` is the largest
    absolute gap of a banked row to the member's own ``suffix`` run over
    the whole batch, the JAX package's check, which holds the bank against
    a second path (0.0 when no micro-batch was banked).

    The JAX package's replay runs each member's suffix over the WHOLE batch
    and takes the member's row; that is bitwise there because XLA's CPU
    GEMMs give a row the same bits at any batch size.  torch's CPU GEMMs do
    not, and on the card the bank is its own kernel, so this replay repeats
    the dispatch the engine made."""
    sp = adapter.split(cfg)
    completions = eng.completions[since:]
    res = {id(c.request): c.result for c in completions}
    by_iid: dict = {}
    for c in completions:
        by_iid.setdefault(c.request.instance_id, []).append(c.request)
    bad = [] if gaps is None else gaps
    n_bad = len(bad)
    bank_gap = 0.0

    def check(r, want):
        got = res[id(r)]
        if not torch.equal(got, want):
            bad.append((r.instance_id, r.meta, (got.float() - want.float()).abs().max().item()))

    for group in eng.prefix_groups():
        greqs = [r for iid in group for r in by_iid.get(iid, [])]
        bankable = len(group) > 1 and eng._group_bankable(tuple(group))
        for mb in deadline_microbatches(greqs, buckets):
            batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
            if len(group) == 1:
                out = adapter.forward(cfg, store.materialize(group[0]), batch)
                for j, r in enumerate(mb.requests):
                    check(r, out[j])
                continue
            feats = sp.prefix(store.materialize(group[0]), batch)
            if bankable and len({r.instance_id for r in mb.requests}) > 1:
                bank = store.materialize_bank(tuple(group), sp.suffix_paths)
                out = sp.bank_suffix(bank, feats)
                slot = {iid: i for i, iid in enumerate(group)}
                own = {iid: sp.suffix(store.materialize(iid), feats)
                       for iid in {r.instance_id for r in mb.requests}}
                for j, r in enumerate(mb.requests):
                    check(r, out[slot[r.instance_id], j])
                    bank_gap = max(bank_gap, (out[slot[r.instance_id], j].float()
                                              - own[r.instance_id][j].float()).abs().max().item())
                continue
            rows: dict = {}
            for j, r in enumerate(mb.requests):
                rows.setdefault(r.instance_id, []).append(j)
            for iid, idx in rows.items():
                if len(idx) == mb.bucket:
                    sub = feats
                else:
                    sb = next(b for b in buckets if len(idx) <= b)
                    take = idx + [idx[-1]] * (sb - len(idx))
                    sub = feats[torch.tensor(take, device=feats.device)]
                out = sp.suffix(store.materialize(iid), sub)
                for k, j in enumerate(idx):
                    check(mb.requests[j], out[k])
    return len(bad) == n_bad, bank_gap
