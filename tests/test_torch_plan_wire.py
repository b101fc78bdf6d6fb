"""fig14's plan-wire lane (``repro_torch.bench.fig14_bandwidth``) against
the JAX bench's, and the wire codec's rule for bf16.

The lane runs on the dense adapter's tiny float32 config on the JAX bench's
own draws (its zoo bridged, its calibration and check batches handed over
as numpy): rows, ratios, key counts and agreement are equal exactly.
Neither package writes an artifact here (both ``ARTIFACTS`` in
``tmp_path``).
"""
import base64
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.signatures as JSG
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.bench import common as TCOMMON
from repro_torch.bench import fig14_bandwidth as TF14
from repro_torch.core import signatures as TSG
from repro_torch.utils.tree import flatten_paths

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import common as JCOMMON  # noqa: E402
from benchmarks import fig14_bandwidth as F14  # noqa: E402
from test_torch_lm_bench import _lm_scenario  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(JCOMMON, "ARTIFACTS", str(tmp_path / "jax"))
    monkeypatch.setattr(TCOMMON, "ARTIFACTS", str(tmp_path / "torch"))




def test_plan_wire_equals_the_reference():
    want = F14.run_plan_wire()
    jadapter = jax_get_adapter("dense")
    check = jadapter.calibration_batch(jadapter.default_config(), jax.random.PRNGKey(33), 8)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in check.items()}
    scn = _lm_scenario()
    zoo = {m: {p: t.clone() for p, t in flatten_paths(z).items()} for m, z in scn.zoo.items()}
    rows, derived, seconds = TF14.plan_wire(scn, batch)
    assert rows == want["rows"]
    assert derived == want["derived"]
    assert [r["json_bytes"] for r in rows] == [132_824, 121_704, 40_012]
    assert (derived["changed_keys"], derived["unchanged_keys"]) == (17, 2)
    assert all(TF14.gates(derived).values())
    assert set(seconds["to_json"]) == set(seconds["from_json"]) == {"full", "delta", "delta_q8"}
    assert set(seconds["apply_plan"]) == {"v1", "delta_q8"}
    # the lane never wrote the zoo's tensors: a store rebinds
    assert all(torch.equal(zoo[m][p], t)
               for m, z in scn.zoo.items() for p, t in flatten_paths(z).items())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_changed_buffer_wire_kind_under_quantize(dtype):
    """A changed bf16 buffer ships ``full`` under ``quantize=True`` in both
    packages (numpy's bfloat16 is not of kind "f"); a float32 one ships
    ``delta_q8``.  The entries are equal."""
    rng = np.random.default_rng(0)
    base32 = rng.standard_normal((16, 8)).astype(np.float32)
    base = np.asarray(jnp.asarray(base32, dtype=dtype))
    value = np.asarray(jnp.asarray(base32 + 0.25, dtype=dtype))
    want = JSG.encode_weight_entry(value, base=base, quantize=True)
    tval, tbase = bridge.array_to_tensor(value, CPU), bridge.array_to_tensor(base, CPU)
    got = TSG.encode_weight_entry(tval, base=tbase, quantize=True)
    assert got == want
    assert got["kind"] == ("full" if dtype == "bfloat16" else "delta_q8")
    decoded = TSG.decode_weight_entry(got, base=tbase)
    if dtype == "bfloat16":
        assert decoded.dtype == torch.bfloat16 and torch.equal(decoded, tval)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8])
def test_entry_wire_bytes_equal_the_reference(n):
    """The port counts payload bytes from the base64 text's length; the
    reference decodes it.  Every padding (n mod 3) and each kind."""
    rng = np.random.default_rng(n)
    value = rng.standard_normal(n).astype(np.float32)
    for base in (None, value, value + 1):
        for quantize in (False, True):
            entry = JSG.encode_weight_entry(value, base=base, quantize=quantize)
            assert TSG.entry_wire_bytes(entry) == JSG.entry_wire_bytes(entry), entry
    raw = {"dtype": "uint8", "shape": [n], "data": base64.b64encode(bytes(range(n))).decode()}
    assert TSG.entry_wire_bytes(raw) == JSG.entry_wire_bytes(raw) == n


def _reference_ramp(buf: np.ndarray, i: int) -> np.ndarray:
    """``benchmarks/fig14_bandwidth.py``'s retraining of one changed buffer."""
    ramp = np.cos(np.arange(buf.size, dtype=np.float32) + i).reshape(buf.shape)
    return buf + np.float32(1e-3) * ramp


def test_retrained_ramp_keeps_the_dtype_and_the_reference_bits():
    """float32: the reference's bits.  bf16: the reference keeps the sum in
    float32 (numpy promotes bfloat16 + float32); the port's is that sum
    rounded to bf16, and differs from it."""
    rng = np.random.default_rng(1)
    v32 = rng.standard_normal((6, 5)).astype(np.float32)
    got = TF14.retrained(torch.from_numpy(v32), 3)
    assert np.array_equal(got.numpy(), _reference_ramp(v32, 3))
    vb = np.asarray(jnp.asarray(v32, dtype=jnp.bfloat16))
    want = _reference_ramp(vb, 3)
    assert want.dtype == np.float32
    gb = TF14.retrained(bridge.array_to_tensor(vb, CPU), 3)
    assert gb.dtype == torch.bfloat16
    assert np.array_equal(bridge.tensor_to_array(gb), want.astype(vb.dtype))
    assert not np.array_equal(gb.float().numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (16, 8), (7, 5)])
def test_f32_sum_excess_equals_the_reference_entries(shape):
    """chip_smoke's count of the bytes the reference's float32 sum adds to a
    changed bf16 buffer's JSON entry, against both packages' encoders."""
    import json

    import chip_smoke

    rng = np.random.default_rng(2)
    base = np.asarray(jnp.asarray(rng.standard_normal(shape), dtype=jnp.bfloat16))
    ref_entry = JSG.encode_weight_entry(_reference_ramp(base, 0), base=base, quantize=True)
    port = TF14.retrained(bridge.array_to_tensor(base, CPU), 0)
    port_entry = TSG.encode_weight_entry(port, base=bridge.array_to_tensor(base, CPU),
                                         quantize=True)
    assert (ref_entry["kind"], ref_entry["dtype"]) == ("full", "float32")
    assert (port_entry["kind"], port_entry["dtype"]) == ("full", "bfloat16")
    excess = len(json.dumps(ref_entry)) - len(json.dumps(port_entry))
    assert excess == chip_smoke.f32_sum_excess_json_bytes(base.size)
