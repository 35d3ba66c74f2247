"""The port's models on DTensors: every family's float32 smoke config on
DTensor parameters laid out by ``dist.sharding.tree_shardings`` on a (2,
2) ``("data", "model")`` mesh of four gloo ranks of the CPU (one spawned
world, ``tests/_torch_spmd_ranks.py``), against the same steps unsharded
and against the JAX package.

For dense, vlm (M-RoPE), audio, moe (the global dispatch, at its own
capacity 1.25 with drops), ssm and hybrid, with the reference's
``init_lm`` weights (norm scales, biases and Mamba2's scalars randomised)
carried over by ``weights.params_from_jax`` and a batch of 4 x 16 from
the reference's ``SyntheticTokens``:
  * the sharded port against the unsharded port: ``train_loss`` to rtol
    1e-5 and every gradient to 1e-5 + 1e-4 x its max |grad| (the
    tolerances of ``test_torch_train.py``), each gradient with its
    parameter's placements; the prefill logits, then three greedy decode
    steps' logits, within 1e-5 of max |logit| with identical greedy
    tokens, and the caches written;
  * the sharded port against JAX's unsharded ``jax.value_and_grad`` of
    ``train_loss`` (the same training tolerances) and JAX's ``prefill``
    logits (``test_torch_models.py``'s 1e-4 absolute / 1e-4 relative).
Also on the ranks: ``moe_impl="auto"`` takes expert parallelism on the
mesh, equal to the plain explicit-mesh EP (``_moe_fwd_ep``); one AdamW
step of 2 microbatches on DTensors equal to the plain step; and the
prefill with every all-gather staged through host memory (as gloo's CUDA
all-gathers are) equal to the direct one.

In a JAX subprocess on 4 host devices, tinyllama-1.1b's smoke cells in
bf16 (train 4 x 32, prefill 4 x 32, decode 4 against 32) are compiled on a
(2, 2) mesh as the JAX dry run lowers them, with the serving weights in
the port's dtypes. The port's per-device ``argument_size_in_bytes`` on a
``fake`` world of 4 equals JAX's ``memory_analysis()`` exactly. For the
training cell, the fault this slice closes: JAX's HLO moves all-gather
bytes (FSDP's weight gathers) where ``reckon_lm`` counts none; the traced
bytes (``traced_lm``) hold all-gathers too, their total is at least the
reckoned floor, and they equal what each gloo rank handed to c10d in the
same step. JAX's HLO bytes are printed beside the port's, not gated: GSPMD
and DTensor choose their own redistributions.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

import _torch_spmd_ranks as R
from _torch_dist_ranks import spawn
from repro.configs import ARCHS
from repro.data.pipeline import SyntheticTokens
from repro.models import init_lm, prefill, train_loss
from repro_torch.analysis.comm import reckon_lm
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.launch import dryrun as DR
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_lm as t_init_lm
from repro_torch.models import prefill as t_prefill
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import F32_LEAVES
from repro_torch.train.optimizer import OptConfig, adamw_init, tree_leaves
from repro_torch.train.trainer import loss_and_grads, make_train_step
from repro_torch.weights import params_from_jax, params_to_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
FAMILIES = {"dense": "tinyllama-1.1b", "moe": "moonshot-v1-16b-a3b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
            "vlm": "qwen2-vl-2b", "audio": "musicgen-medium"}
NOISY = ("ln1", "ln2", "ln", "final_ln", "gate_norm", "bq", "bk", "bv",
         "A_log", "D", "dt_bias")
B, S, STEPS = 4, 16, 3
CELLS = {"train": (4, 32), "prefill": (4, 32), "decode": (4, 32)}
TOL = dict(atol=1e-4, rtol=1e-4)


def jax_tree(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        name = jax.tree_util.keystr(path[-1:]).strip("[]'\"")
        if name in NOISY:
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return np.array(a)

    return jax.tree_util.tree_map_with_path(
        noisy, init_lm(jax.random.key(seed), cfg))


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_np(v) for v in tree]
    return tree.detach().numpy()


def smoke(arch):
    cfg, tcfg = ARCHS[arch].smoke(), T_ARCHS[arch].smoke()
    if tcfg.family == "moe":          # the global dispatch, as JAX's
        cfg = dataclasses.replace(cfg, moe_impl="global")
        tcfg = dataclasses.replace(tcfg, moe_impl="global")
    return cfg, tcfg


def cell_cfg():
    base = dataclasses.replace(T_ARCHS["tinyllama-1.1b"].smoke(),
                               dtype="bfloat16")
    return {kind: DR._cell_cfg(base, ShapeConfig(kind, s, b, kind))
            for kind, (b, s) in CELLS.items()}


JAX_CELLS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
import jax, jax.numpy as jnp
from repro.analysis.hlo import collective_bytes
from repro.configs import ARCHS, input_specs
from repro.dist.sharding import (batch_axes, cache_axes, opt_axes,
                                 param_axes, tree_shardings)
from repro.models import init_lm, make_cache
from repro.models.config import ShapeConfig
from repro.train.optimizer import OptConfig, adamw_init
from repro.train.trainer import (make_decode_step, make_prefill_step,
                                 make_train_step)

cells, f32 = json.loads(sys.argv[1]), set(json.loads(sys.argv[2]))
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
base = dataclasses.replace(ARCHS["tinyllama-1.1b"].smoke(), dtype="bfloat16")
out = {}
for kind, (B, S) in cells.items():
    shape = ShapeConfig(kind, S, B, kind)
    cfg = dataclasses.replace(
        base, attn_impl="chunked" if kind != "decode" else "ref")
    pshapes = jax.eval_shape(lambda: init_lm(jax.random.key(0), cfg))
    if kind != "train":      # the port's serving weights' dtypes
        pshapes = jax.tree_util.tree_map_with_path(
            lambda p, s: s if jax.tree_util.keystr(p[-1:]).strip("[]'\"")
            in f32 else jax.ShapeDtypeStruct(s.shape, jnp.bfloat16),
            pshapes)
    paxes = param_axes(cfg, pshapes=pshapes)
    pshard = tree_shardings(paxes, pshapes, mesh)
    batch = input_specs(cfg, shape)
    bshard = tree_shardings(batch_axes(cfg, kind), batch, mesh)
    with jax.sharding.set_mesh(mesh):
        if kind == "train":
            oshapes = jax.eval_shape(lambda: adamw_init(pshapes))
            oshard = tree_shardings(opt_axes(paxes), oshapes, mesh)
            low = jax.jit(make_train_step(cfg, OptConfig()),
                          in_shardings=(pshard, oshard, bshard),
                          out_shardings=(pshard, oshard, None),
                          donate_argnums=(0, 1)).lower(pshapes, oshapes,
                                                       batch)
        elif kind == "prefill":
            cshapes = jax.eval_shape(lambda: make_cache(cfg, B, S))
            cshard = tree_shardings(cache_axes(cfg), cshapes, mesh)
            low = jax.jit(make_prefill_step(cfg, max_seq=S),
                          in_shardings=(pshard, bshard),
                          out_shardings=(None, cshard)).lower(pshapes, batch)
        else:
            low = jax.jit(make_decode_step(cfg),
                          in_shardings=(pshard, bshard["tokens"],
                                        bshard["cache"], bshard["cache_len"]),
                          out_shardings=(None, bshard["cache"]),
                          donate_argnums=(2,)).lower(
                pshapes, batch["tokens"], batch["cache"], batch["cache_len"])
    comp = low.compile()
    out[kind] = {"args": int(comp.memory_analysis().argument_size_in_bytes),
                 "coll": collective_bytes(comp.as_text())}
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def run():
    """Everything once: the JAX cells in a subprocess and the ranks in a
    thread while this process computes the unsharded port and JAX."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CELLS, json.dumps(CELLS),
         json.dumps(list(F32_LEAVES))], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    fams, want = {}, {}
    for fam, arch in FAMILIES.items():
        cfg, tcfg = smoke(arch)
        tree = jax_tree(cfg)
        batch = SyntheticTokens(cfg, B, S, seed=3).next_batch()
        params = params_from_jax(tree, tcfg, device="cpu",
                                 dtype=torch.float32)
        fams[fam] = dict(cfg=tcfg, params=to_np(params), batch=batch)
        want[fam] = dict(jax_cfg=cfg, tree=tree)
    mcfg = dataclasses.replace(T_ARCHS["moonshot-v1-16b-a3b"].smoke())
    mp = t_init_lm(mcfg, torch.Generator().manual_seed(2), "cpu",
                   dtype=torch.float32)["blocks"][0]["moe"]
    rng = np.random.default_rng(5)
    ccfg = cell_cfg()["train"]
    cb, cs = CELLS["train"]
    cparams = t_init_lm(ccfg, torch.Generator().manual_seed(4), "cpu",
                        dtype=torch.float32)
    inp = dict(families=fams, decode_steps=STEPS,
               moe_layer=dict(cfg=mcfg, p=to_np(mp), x=rng.normal(
                   size=(4, 8, mcfg.d_model)).astype(np.float32)),
               cell=dict(cfg=ccfg, params=to_np(cparams), batch={
                   "tokens": rng.integers(0, ccfg.vocab, (cb, cs)).astype(
                       np.int32)}))
    got = {}
    ranks = threading.Thread(
        target=lambda: got.update(ranks=spawn(R.spmd_cases, 4, inp)))
    ranks.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for fam in FAMILIES:
            want[fam].update(_unsharded(fams[fam]))
            want[fam].update(_jax(want[fam]["jax_cfg"], want[fam]["tree"],
                                  fams[fam]["batch"]))
        want["adamw"] = _adamw(fams["dense"])
    finally:
        torch.set_num_threads(n)
    stdout, stderr = jax_proc.communicate(timeout=600)
    ranks.join()
    assert jax_proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT")][-1]
    want["jax_cells"] = json.loads(line[len("RESULT"):])
    assert "ranks" in got, "the ranks failed"
    return got["ranks"], want


def _unsharded(fam):
    cfg = fam["cfg"]
    params, batch = R._torch(fam["params"]), R._torch(fam["batch"])
    loss, metrics, grads = loss_and_grads(params, cfg, batch)
    out = dict(loss=loss, metrics=metrics, grads=grads)
    pb = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, cache = t_prefill(params, cfg, pb, max_seq=S + STEPS)
        out["prefill_logits"] = logits.clone()
        out["prefill_cache"] = {k: v.clone() for k, v in cache.items()}
        tok = R.greedy(logits, cfg.vocab)
        out["decode"] = []
        for i in range(STEPS):
            logits, cache = t_decode_step(params, cfg, tok, cache, S + i)
            out["decode"].append(dict(logits=logits.clone(), tokens=tok))
            tok = R.greedy(logits, cfg.vocab)
        out["decode_cache"] = cache
    return out


def _jax(cfg, tree, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(lambda p: train_loss(p, cfg, jb), has_aux=True)
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, tree))
    pb = {k: v for k, v in jb.items() if k != "labels"}
    logits, _ = prefill(jax.tree.map(jnp.asarray, tree), cfg, pb, S)
    return dict(jax_loss=float(loss), jax_metrics=metrics,
                jax_grads=jax.tree.map(np.asarray, grads),
                jax_logits=np.asarray(logits))


def _adamw(fam):
    cfg = fam["cfg"]
    params, batch = R._torch(fam["params"]), R._torch(fam["batch"])
    opt = adamw_init(params)
    params, opt, metrics = make_train_step(cfg, OptConfig(),
                                           microbatches=2)(params, opt,
                                                           batch)
    return dict(params=params, m=opt["m"], v=opt["v"], metrics=metrics)


def _close_grads(got, want):
    """Each leaf within 1e-5 + 1e-4 x its max |grad| (``want``'s)."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        tol = 1e-5 + 1e-4 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (i, np.abs(g - w).max(), tol)


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_train_matches_unsharded(run, family):
    ranks, want = run
    got, w = ranks[0]["families"][family], want[family]
    np.testing.assert_allclose(float(got["loss"]), float(w["loss"]),
                               rtol=1e-5)
    for k, v in w["metrics"].items():
        np.testing.assert_allclose(np.asarray(got["metrics"][k]),
                                   v.numpy(), rtol=1e-5, err_msg=k)
    _close_grads(got["grads"], w["grads"])
    assert got["placements_kept"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_train_matches_jax(run, family):
    ranks, want = run
    got, w = ranks[0]["families"][family], want[family]
    np.testing.assert_allclose(float(got["loss"]), w["jax_loss"], rtol=1e-5)
    for k, v in w["jax_metrics"].items():
        if k == "expert_counts":
            np.testing.assert_array_equal(got["metrics"][k], np.asarray(v))
        else:
            np.testing.assert_allclose(float(got["metrics"][k]), float(v),
                                       rtol=1e-5, err_msg=k)
    _close_grads(jax.tree.leaves(params_to_jax(R._torch(got["grads"]))),
                 jax.tree.leaves(w["jax_grads"]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_prefill_and_decode_match_unsharded(run, family):
    ranks, want = run
    got, w = ranks[0]["families"][family], want[family]
    _close_logits(got["prefill_logits"], w["prefill_logits"])
    for g, x in zip(got["decode"], w["decode"], strict=True):
        np.testing.assert_array_equal(g["tokens"], x["tokens"].numpy())
        _close_logits(g["logits"], x["logits"])
    for which in ("prefill_cache", "decode_cache"):
        assert sorted(got[which]) == sorted(w[which])
        for k, v in w[which].items():
            np.testing.assert_allclose(got[which][k], v.float().numpy(),
                                       atol=1e-5 * max(1.0, float(
                                           v.abs().max())), rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_prefill_matches_jax(run, family):
    ranks, want = run
    got = ranks[0]["families"][family]["prefill_logits"]
    np.testing.assert_allclose(got, want[family]["jax_logits"], **TOL)


def test_moe_auto_takes_expert_parallelism_on_the_mesh(run):
    m = run[0][0]["moe_layer"]
    d = m["data_rank"]
    half = m["y"].shape[0] // 2
    np.testing.assert_array_equal(m["y"][d * half:(d + 1) * half],
                                  m["y_plain_shard"])
    for k, v in m["aux_plain"].items():
        np.testing.assert_array_equal(np.asarray(m["aux"][k]),
                                      np.asarray(v), err_msg=k)


def test_sharded_adamw_step_of_two_microbatches(run):
    ranks, want = run
    got, w = ranks[0]["adamw"], want["adamw"]
    for part in ("params", "m", "v"):
        for g, x in zip(tree_leaves(got[part]), tree_leaves(w[part]),
                        strict=True):
            x = x.detach().numpy()
            np.testing.assert_allclose(g, x, rtol=1e-5,
                                       atol=1e-6 * max(1.0,
                                                       np.abs(x).max()))
    for k, v in w["metrics"].items():
        np.testing.assert_allclose(np.asarray(got["metrics"][k]), v.numpy(),
                                   rtol=1e-5, err_msg=k)


def test_staged_all_gathers_give_the_same_prefill(run):
    st = run[0][0]["staged"]
    np.testing.assert_array_equal(st["staged"], st["direct"])
    assert st["bytes_staged"] == st["bytes_direct"]
    assert st["bytes_direct"].get("all-gather", 0) > 0


@pytest.fixture
def fake4():
    DR.fake_world(4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    DR.close_world()


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_argument_bytes_equal_jax(run, fake4, kind):
    cfg = cell_cfg()[kind]
    b, s = CELLS[kind]
    shape = ShapeConfig(kind, s, b, kind)
    tr = DR.trace_lm(cfg, shape, fake4)
    mem = DR.lm_memory(tr, fake4)
    assert mem["argument_size_in_bytes"] == run[1]["jax_cells"][kind]["args"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["temp_basis"] == "per-device trace"


def test_train_cell_collectives_traced_not_reckoned(run, fake4):
    """The fault: JAX's per-device program all-gathers (FSDP) where the
    reckoned floor counts no all-gather; the traced bytes do, hold the
    floor, and are what the gloo ranks handed to c10d."""
    cfg = cell_cfg()["train"]
    b, s = CELLS["train"]
    shape = ShapeConfig("train", s, b, "train")
    jax_coll = run[1]["jax_cells"]["train"]["coll"]
    floor = reckon_lm(cfg, "train", b, s, fake4)
    traced = DR.trace_lm(cfg, shape, fake4).coll
    print("JAX HLO", jax_coll, "traced", traced, "reckoned", floor)
    assert jax_coll.get("all-gather", 0) > 0
    assert floor.get("all-gather", 0) == 0
    assert traced["all-gather"] > 0
    assert traced["total"] >= floor["total"]
    for r in run[0]:
        wire = r["cell"]
        assert wire["bytes"] == {k: v for k, v in traced.items()
                                 if k not in ("total", "count")}
        assert sum(wire["count"].values()) == traced["count"]
