"""The plain references agree with the port at small sizes on the CPU: the
layout each builds from its configuration is the port's parameter tree,
and its logits are the port's forward over the merged store (the trunk of
member 0, each member's own head)."""
import numpy as np
import pytest
import torch

from perfbench import common, harness, reference, weights
from perfbench.small import OVERRIDES, TINY_DENSE, TINY_SSM

common.put_src_on_path()


def _cfg(config: str, small: dict = None):
    c = common.load_json("configs", config)
    return c["family"], {**c["model"], **(small or {})}


@pytest.mark.parametrize("config, small", [
    ("stablelm-1.6b", None), ("stablelm-1.6b", TINY_DENSE),
    ("falcon-mamba-7b", None), ("falcon-mamba-7b", TINY_SSM)])
def test_reference_layout_is_the_ports_parameter_tree(config, small):
    from repro_torch.models.registry import get_adapter
    from repro_torch.utils.tree import flatten_paths

    family, model = _cfg(config, small)
    adapter = get_adapter(family)
    cfg = harness.model_config(adapter, model)
    want = weights.layout_of(flatten_paths(adapter.eval_params(cfg)))
    assert reference.FAMILIES[family].layout(model) == want


@pytest.mark.parametrize("name", ["stablelm-1.6b.serve-bursty", "falcon-mamba-7b.serve-mixed"])
def test_reference_logits_are_the_merged_engines(name):
    ctx = harness.make_context(name, 77, 1.0, False, "cpu", OVERRIDES[name])
    model = ctx.cfg
    harness.build(ctx)
    eng = ctx.engine
    toks = np.random.default_rng(0).integers(0, model["vocab_size"], (3, 12))
    reqs = [(m, toks[m % 3], np.arange(12)) for m in range(len(ctx.members))]
    want = reference.logits(ctx.family, model, 77, 0, reqs, torch.device("cpu"))
    for (m, t, _), ref in zip(reqs, want):
        prog = eng.programs[ctx.members[m]]
        params = eng.store.materialize(ctx.members[m])
        with torch.no_grad():
            got = prog.suffix(params, prog.prefix(params, torch.as_tensor(t)[None]))[0]
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    # the store merged every trunk leaf onto member 0's draw
    assert eng.store.resident_bytes() < eng.store.resident_bytes([ctx.members[0]]) * 2
