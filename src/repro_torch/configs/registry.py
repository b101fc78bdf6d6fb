"""Arch-config registry (the port of ``repro.configs.registry``): an arch
id -> its config module under ``repro_torch.configs``."""
from __future__ import annotations

import importlib

ARCHS = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-72b": "qwen2_72b",
    "olmo-1b": "olmo_1b",
    "qwen3-14b": "qwen3_14b",
    "stablelm-1.6b": "stablelm_1_6b",
    "internvl2-2b": "internvl2_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def load_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; choices: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")


def all_arch_ids() -> list:
    return list(ARCHS.keys())
