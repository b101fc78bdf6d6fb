"""The control at a size a test run holds: the reference computed in fp8,
put in the program's place, reads at least three times what the bf16
program reads on one of the cell's numbers (on the card, at the cells' own
sizes, ``readings.py`` reads both against the cells' limits)."""
import pytest

from perfbench import common
from perfbench.harness import run_cell
from perfbench.small import CONTROL_MODEL, OVERRIDES, SECONDS

common.put_src_on_path()


@pytest.mark.parametrize("name", list(CONTROL_MODEL))
def test_the_fp8_control_reads_three_times_the_program(name):
    over = dict(OVERRIDES[name], model=CONTROL_MODEL[name])
    out = run_cell(name, 2 ** 31 + 7, SECONDS[name], False, device="cpu", overrides=over,
                   control=True)
    prog = {k: v["value"] for k, v in out["compared"].items()}
    low = out["control"]["numbers"]
    assert set(low) == set(prog) and all(v is not None for v in prog.values())
    assert max(low[k] / max(prog[k], 1e-9) for k in prog) >= 3.0, (prog, low)
