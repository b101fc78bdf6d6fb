"""The frozen cost arithmetic equals the port's ``ops.<op>_cost`` on sample
shapes (it was copied from there), and the model-flop counts add up."""
import pytest
import torch

from perfbench import common, costs

common.put_src_on_path()


def _t(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


CASES = [
    ("flash_attention", (_t(2, 64, 8, 64), _t(2, 64, 8, 64), _t(2, 64, 8, 64)), {}),
    ("flash_attention", (_t(1, 40, 4, 16), _t(1, 40, 2, 16), _t(1, 40, 2, 16)),
     {"window": 7}),
    ("page_gather", (_t(10, 256), torch.zeros(12, dtype=torch.int32)), {}),
    ("bank_matmul", (_t(3, 16, 64), _t(3, 64, 96)), {}),
    ("bank_matmul", (_t(16, 64), _t(2, 64, 96), _t(2, 96)), {}),
    ("rg_lru_scan", (_t(2, 9, 32, dtype=torch.float32), _t(2, 9, 32, dtype=torch.float32),
                     _t(2, 32, dtype=torch.float32)), {}),
    ("mamba_scan", tuple(_t(*s, dtype=torch.float32) for s in
                         ((2, 9, 32), (2, 9, 32), (2, 9, 8), (2, 9, 8), (32, 8), (2, 32, 8))),
     {}),
]


@pytest.mark.parametrize("op, args, kwargs", CASES)
def test_costs_equal_the_ports_cost_functions(op, args, kwargs):
    from repro_torch.kernels import ops

    want = getattr(ops, f"{op}_cost")(*args, **kwargs)
    got = costs.COSTS[op](*args, **kwargs)
    assert tuple(got) == tuple(want)
    specs = tuple(costs.Spec.of(a) for a in args)
    assert tuple(costs.COSTS[op](*specs, **kwargs)) == tuple(want)


def test_decode_attention_cost_with_counted_keys():
    from repro_torch.kernels import ops

    q, k = _t(3, 8, 64), _t(3, 100, 2, 64)
    lengths = torch.tensor([5, 100, 130], dtype=torch.int32)
    want = ops.decode_attention_cost(q, k, k, lengths)
    keys = ops.decode_keys(lengths, 100)
    assert tuple(costs.decode_attention_cost(q, k, k, keys)) == tuple(want)


def test_bound_takes_the_slowest_resource():
    c = costs.Cost(flops=989e12, bytes=3.35e12 * 2)
    assert costs.bound_s("bank_matmul", c) == pytest.approx(2.0)
    c = costs.Cost(flops=0.0, bytes=1.0, exps=costs.EXP_PER_S * 3)
    assert costs.bound_s("mamba_scan", c) == pytest.approx(3.0)
    assert costs.above_l2(costs.Cost(0, 51e6)) and not costs.above_l2(costs.Cost(0, 49e6))


def test_trunk_flops_add_up_token_by_token():
    dense = common.load_json("configs", "stablelm-1.6b")["model"]
    ssm = common.load_json("configs", "falcon-mamba-7b")["model"]
    for fam, cfg in (("dense", dense), ("ssm", ssm)):
        whole = costs.trunk_flops(fam, cfg, 0, 300)
        parts = sum(costs.trunk_flops(fam, cfg, c, c + 1) for c in range(300))
        assert whole == pytest.approx(parts, rel=1e-12)
        assert costs.trunk_flops(fam, cfg, 5, 5) == 0.0
    # stablelm-1.6b: ~1.41e9 weights in the blocks, 2 flops each per token
    assert costs.trunk_flops("dense", dense, 0, 1) == pytest.approx(
        2 * 24 * (4 * 2048 * 2048 + 3 * 2048 * 5632) + 4 * 64 * 32 * 24, rel=1e-12)
    assert costs.head_flops(dense) == 2 * 2048 * 100352
    assert costs.sequence_flops("ssm", ssm, 10) == pytest.approx(
        costs.trunk_flops("ssm", ssm, 0, 10) + 10 * costs.head_flops(ssm))
