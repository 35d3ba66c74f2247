"""A run end to end on the CPU at a tiny size (the harness's look for a
chip skipped): the result's keys, the comparison, its control, the
faults it must catch, and what the command does without a chip, without
the program, or with JAX loaded."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchtiny import tiny_cell
from harness import runner

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977


def _run(kind="backlog", seconds=1.5, seed=SEED, **kw):
    return runner.run(tiny_cell(kind, **kw), seed, seconds, False, "cpu",
                      0.0, log=lambda s: None)


@pytest.mark.parametrize("kind", ["backlog", "poisson"])
def test_sound_run_is_correct_and_has_the_keys(kind):
    out = _run(kind)
    assert {"correct", "attempted", "failed", "metrics", "device",
            "checks"} <= set(out)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"backlog": {"tokens_per_s", "setup_s"},
            "poisson": {"ttft_p90_ms", "tpot_p90_ms", "setup_s"}}[kind]
    assert set(out["metrics"]) == want
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["checks"]["logit_gap"]["value"] <= 1e-3


def test_control_fails_the_limit_that_sound_runs_pass():
    """The control (the reference in float8) at a tiny size, through the
    run's own checks: its widest gap is over the limit that a sound run
    (float32 here) passes by far, so it comes out not correct."""
    out = runner.run(tiny_cell("backlog", limit=0.05), SEED, 1.5, False,
                     "cpu", 0.0, log=lambda s: None, control=True)
    sound = out["checks"]["logit_gap"]["value"]
    assert out["correct"] is True and out["control"]["correct"] is False
    ctl = out["control"]["checks"]["logit_gap"]
    assert ctl["value"] > ctl["limit"] == 0.05 > 100 * sound


def _altered(real):
    """A sampler that hands out a wrong token one time in three."""
    calls = {"n": 0}

    def fake(logits, generator=None, temperature=0.0):
        tok = real(logits, generator, temperature)
        calls["n"] += 1
        return (tok + 1) % logits.shape[-1] if calls["n"] % 3 == 0 else tok
    return fake


@pytest.mark.parametrize("kind", ["backlog", "poisson"])
def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch,
                                                             kind):
    import repro_torch.serve.engine as eng
    monkeypatch.setattr(eng, "sample_tokens", _altered(eng.sample_tokens))
    out = _run(kind)
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > 0.05


@pytest.mark.parametrize("kind", ["backlog", "poisson"])
def test_a_decode_step_that_leaves_the_cache_unchanged_is_not_correct(
        monkeypatch, kind):
    import repro_torch.models.attention as attn
    monkeypatch.setattr(attn, "_paged_write", lambda pool, phys, off, new:
                        None)
    out = _run(kind)
    assert out["correct"] is False


def _command(cwd, *args, env=None):
    e = dict(os.environ, **(env or {}))
    e.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, env=e,
                          timeout=300)


ARGS = ("--workload", "nemo-docqa-batch", "--seed", "3", "--seconds", "1",
        "--trace", "0")


def test_without_a_chip_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _command(ROOT, *ARGS)
    assert p.returncode == 3 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path, *ARGS)
    assert p.returncode != 0 and p.stdout == ""


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "bench"))
    import importlib
    run = importlib.import_module("run")
    assert "repro" not in run.banned_modules() or "repro" in sys.modules
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert not {"repro_torch_extra", "jaxlibrary"} & set(
        run.banned_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.banned_modules()


ISOLATION = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/bench/tests", sys.argv[1] + "/bench",
                sys.argv[1] + "/src"]
mode = sys.argv[2]
if mode == "reference":
    from reference import dense  # noqa: F401
else:
    from benchtiny import tiny_cell
    from harness import runner
    runner.run(tiny_cell(), 3, 0.5, False, "cpu", 0.0, log=lambda s: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("mode", ["reference", "harness"])
def test_nothing_loads_jax_and_the_reference_loads_no_program(mode):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", ISOLATION, str(ROOT), mode],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if mode == "reference":
        assert "repro_torch" not in tops and "harness" in tops
    else:
        assert "repro_torch" in tops


def test_weights_are_the_same_on_regeneration():
    from harness import weights as W
    from benchtiny import TINY
    a = W.layer(TINY, 2**33 + 1, 1, "cpu")
    b = W.layer(TINY, 2**33 + 1, 1, "cpu")
    c = W.layer(TINY, 2**33 + 2, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q"], c["q"])
    assert a["bq"].abs().max() > 0 and (a["ln1"] != 1).all()


@pytest.mark.cuda
def test_weights_regenerate_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from harness import weights as W
    from benchtiny import TINY
    a = W.layer(TINY, 7, 0, "cuda")
    b = W.layer(TINY, 7, 0, "cuda")
    assert all(torch.equal(a[k], b[k]) for k in a)
