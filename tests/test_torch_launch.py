"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, mirroring the JAX package's surfaces: the tiny preset's loss falls
(``tests/test_system.py``: 60 steps, by more than 0.3), a simulated node
failure then ``--resume`` reaches bit-identical parameters
(``tests/test_ft.py``), and ``--rebalance-every`` runs the GLB expert
rebalancer on a tiny MoE. The presets equal the reference's configs."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.launch.train import preset_config as j_preset_config
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.launch.train import preset_config, train
from repro_torch.models.glb_moe import glb_expert_rebalance
from repro_torch.train.optimizer import tree_leaves
from test_torch_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("preset", ["tiny", "100m", "full"])
def test_presets_match_jax(preset):
    for name in ARCHS:
        assert dataclasses.asdict(preset_config(T_ARCHS[name], preset)) == \
            dataclasses.asdict(j_preset_config(ARCHS[name], preset)), name
    with pytest.raises(ValueError):
        preset_config(T_ARCHS["tinyllama-1.1b"], "huge")


def test_train_loop_reduces_loss(tmp_path):
    out = str(tmp_path / "m.json")
    _, _, history = train([
        "--arch", "tinyllama-1.1b", "--preset", "tiny", "--steps", "60",
        "--batch", "8", "--seq", "64", "--lr", "3e-3", "--log-every", "20",
        "--device", "cpu", "--metrics-out", out])
    assert [h["step"] for h in history] == [20, 40, 60]
    assert history[-1]["loss"] < history[0]["loss"] - 0.3
    m = json.load(open(out))
    assert m["history"] == history and m["fingerprint"] > 0


def test_failure_resume_bit_determinism(tmp_path):
    """A: 30 uninterrupted steps. B: fails at step 25, restarted with
    --resume from the step-20 checkpoint. Parameters, moments and the
    fingerprint must be identical, bit for bit."""
    common = ["--arch", "tinyllama-1.1b", "--preset", "tiny",
              "--steps", "30", "--batch", "4", "--seq", "64",
              "--ckpt-every", "10", "--log-every", "30", "--device", "cpu"]
    mA, mB = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    pA, oA, _ = train(common + ["--ckpt-dir", str(tmp_path / "ckA"),
                                "--metrics-out", mA])
    ckB = str(tmp_path / "ckB")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train(common + ["--ckpt-dir", ckB, "--fail-at-step", "25",
                        "--ckpt-async"])
    pB, oB, _ = train(common + ["--ckpt-dir", ckB, "--resume",
                                "--metrics-out", mB])
    for a, b in zip(tree_leaves([pA, oA]), tree_leaves([pB, oB]),
                    strict=True):
        assert torch.equal(a, b)
    a, b = json.load(open(mA)), json.load(open(mB))
    assert a["fingerprint"] == b["fingerprint"]
    assert a["history"][-1] == b["history"][-1]


def test_cli_failure_exits_nonzero(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--preset", "tiny", "--steps", "4", "--batch",
         "2", "--seq", "16", "--device", "cpu", "--fail-at-step", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "simulated node failure at step 2" in r.stderr


def test_rebalance_every_runs_the_expert_rebalancer(capsys):
    counts = {}

    def keep_counts(step, metrics):
        counts[step] = metrics["expert_counts"].numpy().copy()

    train(["--arch", "moonshot-v1-16b-a3b", "--preset", "tiny", "--steps",
           "10", "--batch", "4", "--seq", "32", "--rebalance-every", "5",
           "--log-every", "10", "--device", "cpu"], on_step=keep_counts)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "GLB-MoE rebalance" in ln]
    assert len(lines) == 2
    perm = np.arange(4)
    for line, step in zip(lines, (5, 10)):
        assert counts[step].sum() > 0
        res = glb_expert_rebalance(counts[step], perm, n_ranks=4)
        assert line == (f"[train] GLB-MoE rebalance: load std "
                        f"{res.loads_before.std():.1f} -> "
                        f"{res.loads_after.std():.1f} ({len(res.swaps)} "
                        "swaps)")
        perm = res.perm
