"""Production meshes + logical-axis rules (the port of
``repro.launch.mesh``).

Single pod: (16, 16) over ("data", "model").  Multi-pod: (2, 16, 16) over
("pod", "data", "model"); the ``pod`` axis extends data parallelism across
pods.  The port's :class:`~repro_torch.distributed.sharding.Mesh` may
repeat a device, so on one card the single-pod mesh is 256 entries of
``cuda:0``: the rules resolve exactly as on the JAX package's mesh, and
placement puts every leaf on the one card.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import LogicalRules, Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh over ``device`` (default ``cuda``) repeated."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


# logical axis -> mesh axis rules (see distributed/sharding.py docstring)
def production_rules(mesh: Mesh, *, seq_shard: bool = False,
                     kv_seq_shard: bool = False,
                     seq_act_shard: bool = False,
                     tensor_parallel: bool = True) -> LogicalRules:
    multi = "pod" in mesh.shape
    batch = ("pod", "data") if multi else ("data",)
    # tensor_parallel=False: small-d_model archs run pure FSDP + DP, the
    # 'model' axis folded into data parallelism (a TP of 16 makes them
    # collective-bound).  MoE expert parallelism stays on 'model'.
    tp = "model" if tensor_parallel else None
    if not tensor_parallel:
        batch = tuple(batch) + ("model",)  # fold TP axis into DP
    rules = {
        # activations
        "batch": batch,
        "seq": "model" if seq_shard else None,  # context parallelism knob
        "seq_act": "model" if seq_act_shard else None,  # sequence parallelism knob
        "heads": tp,
        "kv_heads": tp,
        # kv_seq_shard: when the stored KV heads cannot fill the TP axis
        # (qwen3-14b: 8 heads against 16), shard the cache's sequence dim
        # over "model" instead
        "kv_heads_stored": None if kv_seq_shard else tp,
        "kv_seq": "model" if kv_seq_shard else None,
        "embed": None,
        "vocab": tp,
        "inner": tp,
        "moe_group": batch,
        "expert": "model",
        # parameters (partitioning.py)
        "embed_fsdp": ("data", "model") if not tensor_parallel else "data",
        "tensor": tp,
        "layers": None,
    }
    return LogicalRules(mesh, rules)


def smoke_rules() -> Optional[LogicalRules]:
    """Single device: no rules."""
    return None
