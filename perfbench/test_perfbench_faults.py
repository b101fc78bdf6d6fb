"""Whole runs on the CPU at small sizes, the look for a chip skipped: a
sound run is correct, and with the timed path broken underneath ``correct``
comes out false, once for each fault the cell can have (a step that leaves
its state unchanged, half of the batch left out with the mean of the rest
in its place, an answer altered where it is produced; no cell exchanges
anything between chips)."""
import pytest
import torch

from perfbench import common
from perfbench.harness import run_cell
from perfbench.small import OVERRIDES, SECONDS

common.put_src_on_path()

CELLS = list(OVERRIDES)
SEED = 2 ** 31 + 101


def run(name, seed=SEED):
    return run_cell(name, seed, SECONDS[name], False, device="cpu", overrides=OVERRIDES[name])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"


def _module(name):
    from repro_torch.models import ssm, transformer

    return ssm if name.startswith("falcon") else transformer


def half_batch(fn):
    """The rows of the second half replaced by the mean of the first."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        hidden = out[0] if isinstance(out, tuple) else out
        h = hidden.shape[0] // 2
        if h:
            hidden[h:] = hidden[:h].mean(0, keepdim=True)
        return out
    return broken


def altered(fn):
    """Every answer's first position: its least logit raised above the
    best, so another token comes first."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[..., 0, :]
        first.scatter_(-1, first.argmin(-1, keepdim=True),
                       first.max(-1, keepdim=True).values + 10.0)
        return out
    return broken


FAULTS = [(n, "half_batch") for n in CELLS] + [(n, "altered") for n in CELLS] + [
    ("stablelm-1.6b.decode-chat", "state_unchanged")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    mod = _module(name)
    decode = name.endswith("decode-chat")
    if fault == "state_unchanged":
        monkeypatch.setattr(mod, "_paged_write", lambda pk, pv, *a, **k: (pk, pv))
    elif fault == "half_batch":
        target = "paged_trunk_step" if decode else "trunk"
        monkeypatch.setattr(mod, target, half_batch(getattr(mod, target)))
    else:
        for target in ("bank_head", "head"):
            monkeypatch.setattr(mod, target, altered(getattr(mod, target)))
    with torch.no_grad():
        out = run(name)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name, layers", [
    ("falcon-mamba-7b.serve-mixed", {"gen_lag_p99_ms.serve", "mb_ms.serve", "bank_share.serve"}),
    ("stablelm-1.6b.serve-bursty", {"mb_ms.bursty", "bank_share.bursty"})])
def test_a_traced_run_reports_its_layers(name, layers):
    # the slice opens at the first unit of work after its start: starting it
    # a quarter into the window lets a loaded host stall for over two seconds
    over = dict(OVERRIDES[name], cell=dict(OVERRIDES[name]["cell"], trace_s=1.5))
    out = run_cell(name, SEED, 3.0, True, device="cpu", overrides=over)
    assert out["correct"], out["compared"]
    assert layers | {"resident_gib"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert list(out)[-1] == "compared"
