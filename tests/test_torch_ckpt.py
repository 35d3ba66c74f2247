"""The port's checkpoint against the JAX package's: the same directory
layout (``step_%09d/``, ``manifest.json``, ``arrays/<key with / as
__>.npy``), a roundtrip, ``_gc`` and the async save, and each package
resuming the other's training run.

The cross runs: the JAX CLI trains tinyllama-1.1b's tiny preset for 6
steps with a checkpoint at step 4, and the port's CLI resumes that
checkpoint to step 6; the port's final parameters must equal the JAX
run's. Then the same the other way round. Tolerance: 1e-6 absolute on
the parameters (float32; two steps from the same state, the measured
difference is below 1e-7) and rtol 1e-5 on the last loss.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as j_ckpt
from repro.launch.train import train as j_train
from repro_torch.ft import checkpoint as ckpt
from repro_torch.launch.train import train
from repro_torch.weights import params_to_jax
from test_torch_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _tree():
    return {"params": {"blocks": {"w": torch.arange(6.0).reshape(2, 3)},
                       "bf": torch.tensor([1.5, -2.0],
                                          dtype=torch.bfloat16)},
            "opt": {"step": np.asarray(3, np.int32),
                    "m": [torch.ones(2), np.zeros((1, 2), np.float32)]}}


def test_roundtrip_and_layout(tmp_path):
    assert ckpt.save(str(tmp_path), 7, _tree(), extra={"data": {"seed": 1,
                                                                 "step": 7}},
                     ) is None
    d = tmp_path / "step_000000007"
    assert sorted(os.listdir(d)) == ["arrays", "manifest.json"]
    assert sorted(os.listdir(d / "arrays")) == [
        "opt__m__0.npy", "opt__m__1.npy", "opt__step.npy",
        "params__bf.npy", "params__blocks__w.npy"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 7
    assert manifest["keys"] == sorted(manifest["keys"])
    tree, extra, step = ckpt.restore(str(tmp_path))
    assert step == 7 and extra == {"data": {"seed": 1, "step": 7}}
    np.testing.assert_array_equal(tree["params"]["blocks"]["w"],
                                  np.arange(6.0).reshape(2, 3))
    assert tree["params"]["bf"].dtype == np.float32       # bf16 widened
    np.testing.assert_array_equal(tree["params"]["bf"], [1.5, -2.0])
    assert tree["opt"]["step"].dtype == np.int32
    assert int(tree["opt"]["step"]) == 3
    np.testing.assert_array_equal(tree["opt"]["m"]["0"], [1.0, 1.0])
    # the JAX package reads it the same way
    jtree, jextra, jstep = j_ckpt.restore(str(tmp_path))
    assert jstep == 7 and jextra == extra
    for k, v in ckpt._flatten(tree).items():
        np.testing.assert_array_equal(j_ckpt._flatten(jtree)[k], v)


def test_reads_what_jax_wrote(tmp_path):
    j_ckpt.save(str(tmp_path), 2, {"a": {"b": jnp.arange(4.0)},
                                   "s": jnp.int32(5)}, extra={"x": 1})
    tree, extra, step = ckpt.restore(str(tmp_path), step=2)
    assert (step, extra) == (2, {"x": 1})
    np.testing.assert_array_equal(tree["a"]["b"], np.arange(4.0))
    assert int(tree["s"]) == 5


def test_gc_keeps_the_newest_and_latest_step_skips_tmp(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"w": torch.full((2,), float(s))},
                  keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "missing"))
    tree, _, _ = ckpt.restore(str(tmp_path), step=3)
    np.testing.assert_array_equal(tree["w"], [3.0, 3.0])


def test_async_save_snapshots_before_returning(tmp_path):
    w = torch.ones(64, 64)
    t = ckpt.save(str(tmp_path), 1, {"w": w}, async_=True)
    w.add_(1.0)                          # after the snapshot: not saved
    t.join(timeout=30)
    assert not t.is_alive()
    tree, _, _ = ckpt.restore(str(tmp_path))
    np.testing.assert_array_equal(tree["w"], np.ones((64, 64)))


COMMON = ["--arch", "tinyllama-1.1b", "--preset", "tiny", "--steps", "6",
          "--batch", "4", "--seq", "32", "--ckpt-every", "4",
          "--log-every", "1"]


def _same_params(port_params, jax_params):
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_params))
    got = jax.tree.leaves(params_to_jax(port_params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_port_resumes_a_jax_run(tmp_path):
    d = str(tmp_path / "ck")
    jparams, _, jhist = j_train(COMMON + ["--ckpt-dir", d])
    assert j_ckpt.latest_step(d) == 4
    params, opt, hist = train(COMMON + ["--ckpt-dir", d, "--resume",
                                        "--device", "cpu"])
    assert [h["step"] for h in hist] == [5, 6]
    assert int(opt["step"]) == 6
    np.testing.assert_allclose(hist[-1]["loss"], jhist[-1]["loss"],
                               rtol=1e-5)
    _same_params(params, jparams)


def test_jax_resumes_a_port_run(tmp_path):
    d = str(tmp_path / "ck")
    params, _, hist = train(COMMON + ["--ckpt-dir", d, "--device", "cpu"])
    assert ckpt.latest_step(d) == 4
    jparams, jopt, jhist = j_train(COMMON + ["--ckpt-dir", d, "--resume"])
    assert [h["step"] for h in jhist] == [5, 6]
    assert int(jopt["step"]) == 6
    np.testing.assert_allclose(jhist[-1]["loss"], hist[-1]["loss"],
                               rtol=1e-5)
    _same_params(params, jparams)
