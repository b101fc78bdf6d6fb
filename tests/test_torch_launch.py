"""The port's launchers and its ``train_multipod`` example: the serve
launcher's JSON equal to the JAX package's, the production mesh rules
resolving every logical axis as the JAX package's do on a mesh of the
same shape, and the train launcher and the example running a few steps on
the CPU with a checkpoint directory."""
import json
import tempfile

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.examples import train_multipod
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain


@pytest.mark.parametrize("merged", ["none", "optimal"])
def test_serve_json_equals_the_jax_launcher(merged, capsys):
    argv = ["--workload", "MP2", "--merged", merged, "--json"]
    jserve.main(argv)
    want = capsys.readouterr().out
    tserve.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["merged"] == merged
    tserve.main(argv[:-1])  # the text report
    assert "accuracy" in capsys.readouterr().out


KNOBS = [{}, {"seq_shard": True}, {"kv_seq_shard": True}, {"seq_act_shard": True},
         {"tensor_parallel": False}]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: next(iter(k), "default"))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_rules_resolve_as_the_jax_rules(multi_pod, knobs):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert mesh.size == (512 if multi_pod else 256)
    assert mesh.distinct_devices == (torch.device("cpu"),)
    amesh = AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names))
    rules = tmesh.production_rules(mesh, **knobs)
    jrules = jmesh.production_rules(amesh, **knobs)
    assert sorted(rules.rules) == sorted(jrules.rules)
    names = sorted(rules.rules)
    for ax in names:
        assert tuple(rules.resolve((ax,))) == tuple(jrules.resolve((ax,))), ax
    # axes used together: a mesh axis is used once per spec
    for combo in [("batch", "seq", "heads"), ("embed_fsdp", "tensor"),
                  ("batch", "kv_seq", "kv_heads_stored"), ("vocab", "embed_fsdp"),
                  ("moe_group", "expert", "inner"), tuple(names)]:
        assert tuple(rules.resolve(combo)) == tuple(jrules.resolve(combo)), combo
    assert tmesh.smoke_rules() is None


@pytest.mark.parametrize("arch,extra", [
    ("seamless-m4t-medium", ["--microbatches", "2", "--compress-grads"]),
    ("olmo-1b", []),
])
def test_train_launcher_runs_and_resumes_on_the_cpu(tmp_path, capsys, arch, extra):
    argv = ["--arch", arch, "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", *extra]
    out = ttrain.main(argv)
    assert out["state"]["step"] == 4
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "3"]
    # a second launch to step 6 resumes at the step-4 checkpoint: two steps
    again = ttrain.main(argv[:5] + ["6"] + argv[6:])
    assert [h["step"] for h in again["history"]] == [5] and again["state"]["step"] == 6
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]
    if "--compress-grads" in extra:
        assert "err" in out["state"]


def test_train_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "olmo-1b", "--steps", "1"])


def test_train_multipod_example_kills_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(train_multipod, "CKPT_EVERY", 3)
    out = train_multipod.main(["--device", "cpu", "--steps", "6", "--compress-grads"])
    text = capsys.readouterr().out
    assert "phase 2: restart from the step 3 checkpoint" in text
    assert out["state"]["step"] == 6 and "err" in out["state"]
    assert list(tmp_path.iterdir()) == []  # the example removes its checkpoints
