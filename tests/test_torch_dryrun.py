"""The port's dry run (``repro_torch.launch.dryrun``) end to end, on the
CPU, on ``fake`` worlds of 8, 256 and 512 ranks in this process.

  * tinyllama-1.1b/train_4k and mamba2-130m/long_500k at full width on the
    16x16 mesh: every record key, ``argument_size_in_bytes`` equal to the
    sum of the local shard bytes that ``dist.sharding.spec_for`` gives
    each parameter, optimizer, batch and cache leaf, the aliases, and the
    whole step's bytes and the fewest 80 GB cards that hold them;
  * the CLI: the GLB cell on both meshes, a cell ``cell_applicable``
    skips, a cell that fails (status ``error``, exit as usual), and
    ``analysis.report`` over the records;
  * ``core.lower_shardmap`` for UTS at P 8, dense and lifeline: one
    superstep's collective bytes equal to the executor's wire formula
    (``test_torch_dist_glb.py``'s), and op by op against
    ``repro.analysis.hlo.collective_bytes`` of JAX's ``lower_shardmap``
    on 8 host devices (a subprocess), each difference asserted:
      - JAX's module holds the ``psum`` of the int32 result after its
        ``while_loop`` (an all-reduce of 4 bytes); one superstep of the
        port's loop holds none;
      - JAX's UTS item is five scalar fields, each its own all-to-all
        (and its own collective-permute per lifeline dimension); the
        port's is one (5,) int32 field, so the op counts differ while the
        bytes agree.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.analysis import comm, report
from repro_torch.configs import ARCHS, SHAPES, cell_applicable
from repro_torch.core import GLBParams, lower_shardmap
from repro_torch.dist.sharding import (batch_axes, opt_axes, param_axes,
                                       spec_for)
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_glb_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.problems import uts
from repro_torch.train.optimizer import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
KEYS = {"arch", "shape", "multi_pod", "status", "chips", "mesh", "trace_s",
        "memory_analysis", "collective_bytes", "collective_basis", "cost",
        "model_flops", "roofline", "device", "peaks"}
MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
          "alias_size_in_bytes", "temp_size_in_bytes", "temp_basis"}


@pytest.fixture
def world():
    yield DR.fake_world
    DR.close_world()


def _spec_bytes(axes, tree, sizes):
    """Local bytes of every leaf, straight from ``spec_for``."""
    if isinstance(axes, dict):
        return sum(_spec_bytes(axes[k], tree[k], sizes) for k in axes)
    if isinstance(axes, list):
        return sum(_spec_bytes(a, t, sizes) for a, t in zip(axes, tree))
    n = tree.element_size()
    for d, e in zip(tree.shape, spec_for(tuple(tree.shape), axes, sizes)):
        for a in () if e is None else (e,) if isinstance(e, str) else e:
            d //= sizes.shape[a]
        n *= d
    return n


class _Sizes:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "train_4k"),
                                        ("mamba2-130m", "long_500k")])
def test_lm_cell_16x16(world, tmp_path, arch, shape):
    traces = {}
    rec = DR.run_cell(arch, shape, False, str(tmp_path), traces)
    assert rec["status"] == "ok", rec.get("trace")
    assert set(rec) == KEYS | {"global_bytes", "min_cards",
                               "collective_floor"}
    assert set(rec["memory_analysis"]) == MEMORY
    assert rec["chips"] == 256 and rec["mesh"] == {"data": 16, "model": 16}
    assert rec["device"] == "meta"
    # the bytes come from the per-device trace, the reckoned floor beside
    assert rec["collective_basis"] == "traced"
    assert 0 < rec["collective_floor"] <= rec["collective_bytes"]["total"]
    tr = traces[(arch, shape, False)]
    assert rec["collective_bytes"] == tr.coll
    sizes = _Sizes(rec["mesh"])
    paxes = param_axes(tr.cfg, tr.params)
    kind = SHAPES[shape].kind
    p = _spec_bytes(paxes, tr.params, sizes)
    o = _spec_bytes(opt_axes(paxes), tr.opt, sizes) if tr.opt else 0
    b = _spec_bytes(batch_axes(tr.cfg, kind), tr.batch, sizes)
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == p + o + b
    if kind == "train":
        assert ma["alias_size_in_bytes"] == p + o
        full = sum(t.numel() * 4 for t in tree_leaves(tr.params))
        assert p < full / 16           # FSDP x TP: sharded, not replicated
    else:                               # decode: the cache is donated
        cache = _spec_bytes(batch_axes(tr.cfg, kind)["cache"],
                            tr.batch["cache"], sizes)
        assert ma["alias_size_in_bytes"] == cache > 0
    # temp: the per-device trace's peak (no longer the global / chips)
    assert ma["temp_size_in_bytes"] == int(tr.cost["peak_bytes"]) > 0
    assert ma["temp_basis"] == "per-device trace"
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(
        [tr.params, tr.opt or {}, tr.batch]))
    temp = int(tr.cost["peak_bytes"]) * 256
    assert rec["global_bytes"] == {"arguments": whole, "temp": temp}
    assert rec["min_cards"] == -(-(whole + temp) // 80e9)
    assert rec["cost"]["flops_per_dev"] == tr.cost["flops"]
    assert rec["model_flops"] > 0 and rec["roofline"]["bottleneck"]
    saved = json.load(open(tmp_path / f"{arch}__{shape}__pod.json"))
    assert saved["status"] == "ok"


def test_train_cell_16x16_traces_fsdp_and_tp_collectives(world, tmp_path):
    """tinyllama-1.1b/train_4k on 16x16: the traced per-device step
    all-gathers (FSDP's weights) and reduces (gradients, row-parallel
    outputs), beyond the reckoned floor; its FLOPs, bytes and collectives
    grow linearly in depth (the traces at 1, 2 and 3 layers). Its peak
    need not: on a world of one at 8 x 512 (the card's training cell)
    the peak of 1 and 2 layers sits at the loss's logits, at full depth
    among the gradients, so a line through the first two falls short;
    which is why every cell is traced at full depth."""
    traces = {}
    rec = DR.run_cell("tinyllama-1.1b", "train_4k", False, str(tmp_path),
                      traces)
    cb = rec["collective_bytes"]
    assert cb["all-gather"] > 0
    assert cb.get("reduce-scatter", 0) + cb.get("all-reduce", 0) > 0
    assert cb["total"] >= rec["collective_floor"]
    tr = traces[("tinyllama-1.1b", "train_4k", False)]
    mesh = tr_mesh(rec)
    runs = [comm.traced_lm(dataclasses.replace(tr.cfg, n_layers=n),
                           SHAPES["train_4k"], mesh) for n in (1, 2, 3)]
    for k in ("flops", "bytes"):
        a, b, c = (r["cost"][k] for r in runs)
        assert c - b == pytest.approx(b - a, rel=1e-9)
    a, b, c = (r["coll"]["total"] for r in runs)
    assert c - b == b - a
    assert cb["total"] == a + (tr.cfg.n_layers - 1) * (b - a)
    # per device: the step's model FLOPs spread over the 256 chips, not
    # all of them on one (remat and attention add to the model's 6N)
    assert rec["model_flops"] / 256 < tr.cost["flops"] \
        < 4 * rec["model_flops"] / 256
    world(1)
    one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    shape = ShapeConfig("train_8x512", 512, 8, "train")
    cfg = DR._cell_cfg(ARCHS["tinyllama-1.1b"], shape)
    peaks = [comm.traced_lm(dataclasses.replace(cfg, n_layers=n), shape,
                            one)["cost"]["peak_bytes"]
             for n in (1, 2, cfg.n_layers)]
    linear = peaks[0] + (cfg.n_layers - 1) * (peaks[1] - peaks[0])
    assert peaks[2] > 1.2 * linear


def tr_mesh(rec):
    from repro_torch.launch.mesh import make_production_mesh

    assert rec["mesh"] == {"data": 16, "model": 16}
    return make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("arch,shape", [("moonshot-v1-16b-a3b", "decode_32k"),
                                        ("zamba2-7b", "decode_32k")])
def test_lm_cells_traced_basis(world, tmp_path, arch, shape):
    """A MoE and a hybrid decode cell (expert-parallel on the mesh; the
    sequence-sharded cache; the hybrid's shared block) trace on 16x16
    with the traced basis above the floor."""
    rec = DR.run_cell(arch, shape, False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["collective_basis"] == "traced"
    assert rec["collective_bytes"]["total"] >= rec["collective_floor"]
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0


def test_cli_cells_and_report(world, tmp_path, capsys):
    out = str(tmp_path)
    DR.main(["--arch", "uts_glb", "--shape", "glb", "--both-meshes",
             "--out", out])
    DR.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--out",
             out])
    DR.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--out",
             out])
    recs = {(r["arch"], r["multi_pod"]): r for r in report.load(out)}
    for mp, chips in ((False, 256), (True, 512)):
        r = recs[("uts_glb", mp)]
        assert r["status"] == "ok" and r["chips"] == chips
        assert set(r) == KEYS | {"routing"}
        assert r["collective_basis"] == "traced" and r["device"] == "cpu"
        assert r["mesh"] == {"place": chips}
    skipped = recs[("tinyllama-1.1b", False)]
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == cell_applicable(
        ARCHS["tinyllama-1.1b"], SHAPES["long_500k"])[1]
    assert recs[("no-such-arch", False)]["status"] == "error"
    capsys.readouterr()
    report.main([out])
    text = capsys.readouterr().out
    assert "2 ok, 1 skipped (per spec), 1 errors, 4 cells" in text
    assert "| uts_glb | glb | 512 | ok |" in text
    assert "| tinyllama-1.1b | long_500k | 16x16 | SKIP" in text
    assert "NVIDIA H100" in text and "| uts_glb | glb | **" in text
    assert "| whole step (args+tmp) | cards >= |" in text


JAX_HLO = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from repro.analysis.hlo import collective_bytes
from repro.core import GLBParams, lower_shardmap
from repro.problems.uts import uts_problem

mesh = jax.make_mesh((8,), ("place",))
out = {}
for routing in ("dense", "lifeline"):
    low = lower_shardmap(uts_problem(depth=6), mesh,
                         GLBParams(n=64, w=2, steal_k=32), routing=routing)
    out[routing] = collective_bytes(low.compile().as_text())
print("RESULT" + json.dumps(out))
"""


def _jax_hlo():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", JAX_HLO], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


def test_lower_shardmap_uts_p8(world):
    world(8)
    mesh = make_glb_mesh(n=8, device_type="cpu")
    params = GLBParams(n=64, w=2, steal_k=32)
    P, K, z = 8, params.steal_k, params.resolve_z(8)
    item = sum(int(np.prod(s, dtype=np.int64)) * dt.itemsize
               for s, dt in uts.ITEM_SPEC.values())
    n_fields = len(uts.ITEM_SPEC)
    dense = P * K * item + P * 4
    jax_hlo = _jax_hlo()
    for routing in ("dense", "lifeline"):
        low = lower_shardmap(uts.uts_problem(depth=6), mesh, params,
                             routing=routing, device="cpu")
        cb = low.collective_bytes
        want = 8 + (dense if routing == "dense"
                    else z * (K * item + 4) + dense)
        assert cb["total"] == want, (routing, cb)
        assert cb["all-gather"] == 8 and cb["all-to-all"] == dense
        assert cb.get("collective-permute", 0) == (
            0 if routing == "dense" else z * (K * item + 4))
        # calls: the gather, one all-to-all a field and the counts, and
        # per lifeline dimension one permute a field and the counts
        assert cb["count"] == 1 + (n_fields + 1) + (
            0 if routing == "dense" else z * (n_fields + 1))
        assert low.state_bytes > 0 and low.cost["bytes"] > 0

        j = dict(jax_hlo[routing])
        assert j.pop("all-reduce") == 4          # the result's psum
        j["total"] -= 4
        j_fields = 5                             # d0, d1, depth, lo, hi
        assert j.pop("count") == 1 + 1 + (j_fields + 1) + (
            0 if routing == "dense" else z * (j_fields + 1))
        got = {k: v for k, v in cb.items() if k != "count"}
        assert got == j, (routing, got, j)


def test_lower_shardmap_glb_cells_both_worlds(world):
    """The dry run's two GLB cells build on 256 and 512 ranks: their
    superstep's all-to-all grows with P (one row a place), the rest does
    not."""
    got = {}
    for n in (256, 512):
        world(n)
        got[n] = DR.glb_record("uts_glb", make_glb_mesh(
            n=n, device_type="cpu"))["collective_bytes"]
    K, item = 64, 20
    for n in (256, 512):
        assert got[n]["all-to-all"] == n * K * item + n * 4
        assert got[n]["all-gather"] == 8
    assert torch.distributed.get_world_size() == 512
