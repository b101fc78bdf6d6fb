"""The port's scaffold against the JAX package: the numpy bridge round trip,
layer records and group ids, stable ids, the import boundary, and the
no-CPU-fallback rule for entry points."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stablelm_1_6b as jax_stablelm
from repro.core.groups import enumerate_groups as jax_enumerate_groups
from repro.core.groups import stable_group_id as jax_gid
from repro.core.signatures import records_from_params as jax_records
from repro.models.registry import get_adapter as jax_get_adapter
from repro.utils import ids as jax_ids
from repro.utils.tree import cast_tree, flatten_paths
from repro_torch import bridge
from repro_torch.core.groups import enumerate_groups, stable_group_id
from repro_torch.core.signatures import records_from_params
from repro_torch.utils import ids as port_ids

REPO = Path(__file__).resolve().parents[1]


def _jax_tree(family: str, seed: int = 0):
    if family == "small_cnn":
        a = jax_get_adapter("small_cnn")
        return a.init(a.default_config(), jax.random.PRNGKey(seed))
    cfg = jax_stablelm.smoke_config()
    cfg = dataclasses.replace(cfg, scan_layers=False)
    return jax_get_adapter("dense").init(cfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("family", ["small_cnn", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_round_trip_is_bitwise(family, dtype):
    tree = _jax_tree(family)
    if dtype == "bfloat16":
        tree = cast_tree(tree, jnp.bfloat16)
    port = bridge.to_torch(tree, device="cpu")
    back = flatten_paths(bridge.to_numpy(port))
    flat = flatten_paths(tree)
    assert sorted(back) == sorted(flat)
    for path, leaf in flat.items():
        ref = np.asarray(leaf)
        assert back[path].dtype == ref.dtype and back[path].shape == ref.shape
        np.testing.assert_array_equal(back[path].view(np.uint8), ref.view(np.uint8))
    t = flatten_paths(port)["embed/table" if family == "dense" else "stem/w"]
    assert t.dtype == getattr(torch, dtype) and t.device.type == "cpu"


@pytest.mark.parametrize("family", ["small_cnn", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_records_and_group_ids_match_reference(family, dtype):
    trees = {m: _jax_tree(family, i) for i, m in enumerate(("A", "B", "C"))}
    if dtype == "bfloat16":
        trees = {m: cast_tree(t, jnp.bfloat16) for m, t in trees.items()}
    ref = [r for m, t in trees.items() for r in jax_records(t, m)]
    got = [r for m, t in trees.items()
           for r in records_from_params(bridge.to_torch(t, device="cpu"), m)]
    assert [(r.model_id, r.path, r.signature, r.bytes, r.position) for r in got] == \
        [(r.model_id, r.path, r.signature, r.bytes, r.position) for r in ref]
    assert all(r.signature[2] == dtype for r in got)
    ref_groups = jax_enumerate_groups(ref)
    got_groups = enumerate_groups(got)
    assert [g.signature for g in got_groups] == [g.signature for g in ref_groups]
    assert [stable_group_id(g.signature) for g in got_groups] == \
        [jax_gid(g.signature) for g in ref_groups]
    assert [[[r.key for r in c] for c in g.columns()] for g in got_groups] == \
        [[[r.key for r in c] for c in g.columns()] for g in ref_groups]


@pytest.mark.parametrize("value", ["lm-A:blocks/0/attn/wq", ("dense", (64, 64), "bfloat16"), 7])
def test_stable_ids_match_reference(value):
    assert port_ids.stable_hash(value) == jax_ids.stable_hash(value)
    assert port_ids.stable_seed(value) == jax_ids.stable_seed(value)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # chip_smoke.py (the port's driver on the card) imports no JAX either
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "repro")}


def test_entry_points_without_a_device_raise_on_a_cardless_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.models.registry import get_adapter

    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_adapter("dense").init(stablelm_1_6b.smoke_config(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_adapter("small_cnn").init(get_adapter("small_cnn").default_config(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.to_torch({"w": np.zeros(3, np.float32)})
