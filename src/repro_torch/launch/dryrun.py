"""Multi-pod dry run: is the distribution config coherent, and what would
each step cost, without a card. The counterpart of
``repro.launch.dryrun``.

For every (architecture x input shape) cell, plus the paper's own GLB
workloads (``uts_glb``, ``bc_glb``), on the single-pod 16x16 mesh and the
2x16x16 multi-pod mesh, this writes one JSON record: memory per device,
cost, collective bytes and the roofline terms against the H100's data
sheet (``analysis.roofline``).

Nothing compiles and no card is used. The meshes are
``torch.distributed`` device meshes over a ``fake`` world of 256 or 512
ranks in this one process (a backend that moves no data), torn down
between the two sizes. A language-model cell builds its parameters,
optimizer state, batch and cache on the ``meta`` device, lays each leaf
out on the mesh as DTensors (``dist.sharding.distribute_tree``) and runs
the step once, per device: rank 0's program, as XLA's per-device module
is. ``analysis.cost.trace`` counts its local ops (FLOPs, unfused bytes,
peak) and ``dist.collectives.CollectiveLog`` the collectives DTensor
issues (``analysis.comm.traced_lm``); ``analysis.comm.reckon_lm``'s
formula is kept beside them as their floor. The trace runs every layer
(an eager trace unrolls what XLA's scan sees once), at full depth: the
FLOPs, bytes and collectives of a homogeneous stack are linear in depth,
as JAX's ``analyze_cost`` extrapolates them, but the peak is not (at one
or two layers it sits at the loss, at full depth at the end of the
backward pass among the gradients). A GLB cell runs one superstep of
rank 0's place on the CPU (``core.lower_shardmap``) and its bytes are
traced.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch uts_glb --shape glb
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

Cells catch their own exceptions and the CLI exits 0: a cell's
``status`` (``ok``, ``skipped`` or ``error``) says how it went. The
``REPRO_*`` environment variables are those of the JAX dry run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.comm import local_numel, reckon_lm, traced_lm
from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_config,
                                 input_specs)
from repro_torch.dist.sharding import (batch_axes, cache_axes, mesh_shape,
                                       opt_axes, param_axes, tree_specs)
from repro_torch.launch.mesh import make_glb_mesh, make_production_mesh
from repro_torch.models import init_lm, make_cache
from repro_torch.models.config import ShapeConfig
from repro_torch.train.optimizer import adamw_init

GLB_CELLS = ("uts_glb", "bc_glb")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

MOE_IMPL = os.environ.get("REPRO_MOE_IMPL", "auto")  # auto|global|ep
MICROBATCH = int(os.environ.get("REPRO_MICROBATCH", "1"))  # train cells
REMAT = os.environ.get("REPRO_REMAT", "")  # ''=arch default | none|dots|full

PEAKS = {"PEAK_FLOPS": rl.PEAK_FLOPS, "HBM_BW": rl.HBM_BW,
         "LINK_BW": rl.LINK_BW, "HBM_BYTES": rl.HBM_BYTES}


def _cell_cfg(cfg, shape):
    """Per-cell impl overrides, JAX's: train and prefill take the chunked
    attention (and the chunk-matmul SSD), so that the program's memory is
    bounded; decode the plain masked full-cache path. REPRO_MOE_IMPL
    chooses the MoE dispatch (``auto``: expert-parallel on the mesh, as
    JAX's reads its ambient mesh)."""
    impl = "chunked" if shape.kind in ("train", "prefill") else "ref"
    kw = dict(attn_impl=impl, moe_impl=MOE_IMPL)
    if REMAT:
        kw["remat"] = REMAT
    return dataclasses.replace(cfg, **kw)


# --------------------------------------------------------------- worlds
def fake_world(n: int) -> None:
    """A process group of ``n`` ranks, this process rank 0, on the
    ``fake`` backend (no data moves); any other group is torn down."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ layouts
def local_bytes(axes_tree, tree, mesh) -> int:
    """Bytes of one device's shards of every leaf of ``tree`` laid out by
    ``axes_tree`` on ``mesh`` (``dist.sharding``'s specs)."""
    sizes = mesh_shape(mesh)
    total = 0

    def walk(spec, leaf):
        nonlocal total
        if isinstance(spec, dict):
            for k in spec:
                walk(spec[k], leaf[k])
        elif isinstance(spec, list):
            for s, t in zip(spec, leaf, strict=True):
                walk(s, t)
        else:
            total += local_numel(leaf.shape, spec, sizes) * \
                leaf.element_size()

    walk(tree_specs(axes_tree, tree, mesh), tree)
    return total


@dataclasses.dataclass
class LMTrace:
    """A language-model cell's step on one mesh: the argument trees
    (``meta``, global shapes), and the per-device cost and collectives
    of its trace."""
    cfg: Any
    shape: ShapeConfig
    params: Any
    opt: Optional[Dict[str, Any]]
    batch: Dict[str, Any]
    metrics: Dict[str, Any]
    cost: Dict[str, float]
    coll: Dict[str, int]
    seconds: float


def _args(cfg, shape):
    """The cell's arguments on ``meta``: float32 masters and AdamW state
    for training, the serving weights otherwise, and ``input_specs``."""
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        params = init_lm(cfg, device="meta", dtype=torch.float32)
        return params, adamw_init(params), batch
    return init_lm(cfg, device="meta"), None, batch


def trace_lm(cfg, shape: ShapeConfig, mesh) -> LMTrace:
    """The cell's step on ``mesh``, per device (``traced_lm``)."""
    t0 = time.time()
    run = traced_lm(cfg, shape, mesh, microbatches=MICROBATCH)
    params, opt, batch = _args(cfg, shape)
    return LMTrace(cfg, shape, params, opt, batch, run["metrics"],
                   run["cost"], run["coll"], time.time() - t0)


def lm_memory(tr: LMTrace, mesh) -> Dict[str, int]:
    """Per-device memory of the cell on ``mesh``, XLA's fields:
    arguments (params, optimizer state, batch, decode cache), outputs
    (train: params, optimizer state and the replicated metrics; prefill
    and decode: the next tokens and the cache), aliased (the donated
    params and optimizer state in training, the cache in decode), and
    temp (the per-device trace's peak)."""
    cfg, kind = tr.cfg, tr.shape.kind
    paxes = param_axes(cfg, tr.params)
    params = local_bytes(paxes, tr.params, mesh)
    opt = local_bytes(opt_axes(paxes), tr.opt, mesh) if tr.opt else 0
    args = params + opt + local_bytes(batch_axes(cfg, kind), tr.batch, mesh)
    if kind == "train":
        metrics = sum(v.numel() * v.element_size()
                      for v in tr.metrics.values())
        out, alias = params + opt + metrics, params + opt
    else:
        B, S = tr.shape.global_batch, tr.shape.seq_len
        tok = torch.empty((B, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                    else ()), dtype=torch.int64,
                          device="meta")
        cache = make_cache(cfg, B, S, device="meta")
        tok_axes = ("batch",) + ("none",) * (tok.dim() - 1)
        cbytes = local_bytes(cache_axes(cfg), cache, mesh)
        out = local_bytes(tok_axes, tok, mesh) + cbytes
        alias = cbytes if kind == "decode" else 0
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": int(tr.cost["peak_bytes"]),
            "temp_basis": "per-device trace"}


def _full_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(list(trees))[0])


def lm_record(tr: LMTrace, mesh) -> Dict[str, Any]:
    """Everything of a language-model cell's record but its labels.
    Besides JAX's keys: ``collective_floor``, the reckoned floor of the
    collective bytes (``reckon_lm``'s total), ``global_bytes``, the whole
    step's arguments (unsharded) and the per-device peak times the chips,
    and ``min_cards``, how many cards of ``HBM_BYTES`` their sum needs at
    the least (an even split, nothing replicated)."""
    chips = mesh.size()
    gbytes = {"arguments": _full_bytes(tr.params, tr.opt or {}, tr.batch),
              "temp": int(tr.cost["peak_bytes"]) * chips}
    floor = reckon_lm(tr.cfg, tr.shape.kind, tr.shape.global_batch,
                      tr.shape.seq_len, mesh, pshapes=tr.params)["total"]
    cost = {"flops_per_dev": tr.cost["flops"],
            "bytes_per_dev": tr.cost["bytes"]}
    mflops = rl.model_flops(tr.cfg, tr.shape)
    roof = rl.build({"flops": cost["flops_per_dev"],
                     "bytes": cost["bytes_per_dev"]}, tr.coll, chips,
                    mflops)
    return dict(chips=chips, mesh=mesh_shape(mesh),
                trace_s=round(tr.seconds, 1),
                memory_analysis=lm_memory(tr, mesh),
                collective_bytes=tr.coll, collective_basis="traced",
                collective_floor=floor,
                cost=cost, model_flops=mflops, roofline=roof.row(),
                global_bytes=gbytes, min_cards=math.ceil(
                    sum(gbytes.values()) / rl.HBM_BYTES),
                device="meta", peaks=PEAKS)


def glb_record(which: str, mesh) -> Dict[str, Any]:
    """A GLB cell: one superstep of rank 0's place (``lower_shardmap``),
    JAX's problem sizes and ``REPRO_GLB_*`` settings."""
    from repro_torch.core import GLBParams, lower_shardmap
    from repro_torch.problems.bc import bc_problem
    from repro_torch.problems.rmat import rmat_graph
    from repro_torch.problems.uts import uts_problem

    t0 = time.time()
    routing = os.environ.get("REPRO_GLB_ROUTING", "dense")
    params = GLBParams(
        n=256,
        w=int(os.environ.get("REPRO_GLB_W", "2")),
        steal_k=64,
        steal_k_random=int(os.environ.get("REPRO_GLB_KRAND", "0")),
        max_supersteps=100_000,
    )
    if which == "uts_glb":
        prob = uts_problem(b0=4.0, depth=16, seed=19, capacity=8192)
    else:
        adj, _ = rmat_graph(scale=10, seed=7)   # N=1024, replicated graph
        prob = bc_problem(adj, capacity=2048)
    low = lower_shardmap(prob, mesh, params, axis="place", routing=routing,
                         device="cpu")
    chips = mesh.size()
    roof = rl.build(low.cost, low.collective_bytes, chips, 0.0)
    return dict(chips=chips, mesh=mesh_shape(mesh),
                trace_s=round(time.time() - t0, 1),
                memory_analysis={
                    "argument_size_in_bytes": low.state_bytes,
                    "output_size_in_bytes": low.state_bytes,
                    "alias_size_in_bytes": low.state_bytes,
                    "temp_size_in_bytes": int(low.cost["peak_bytes"]),
                    "temp_basis": "one place's superstep run (its set-up "
                                  "builds every place's rows)"},
                collective_bytes=low.collective_bytes,
                collective_basis="traced",
                cost={"flops_per_dev": low.cost["flops"],
                      "bytes_per_dev": low.cost["bytes"]},
                model_flops=0.0, roofline=roof.row(), routing=routing,
                device="cpu", peaks=PEAKS)


# --------------------------------------------------------------- cells
def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             traces: Optional[Dict[tuple, LMTrace]] = None):
    """One cell's record, written to ``out_dir`` and returned. ``traces``
    (when given) receives the language-model cell's trace."""
    traces = {} if traces is None else traces
    label = f"{arch}/{shape_name}/{'multipod' if multi_pod else 'pod'}"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "multi_pod": multi_pod}
    try:
        if arch in GLB_CELLS:
            fake_world(512 if multi_pod else 256)
            rec.update(status="ok", **glb_record(
                arch, make_glb_mesh(multi_pod=multi_pod, device_type="cpu")))
        else:
            cfg0, shape = get_config(arch), SHAPES[shape_name]
            ok, why = cell_applicable(cfg0, shape)
            if not ok:
                rec.update(status="skipped", reason=why)
                return _save(rec, out_dir, label)
            fake_world(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            key = (arch, shape_name, multi_pod)
            traces.clear()
            traces[key] = trace_lm(_cell_cfg(cfg0, shape), shape, mesh)
            rec.update(status="ok", **lm_record(traces[key], mesh))
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=repr(e),
                   trace=traceback.format_exc()[-4000:])
    return _save(rec, out_dir, label)


def _save(rec, out_dir, label):
    os.makedirs(out_dir, exist_ok=True)
    fname = label.replace("/", "__") + ".json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    status = rec.get("status")
    extra = ""
    if status == "ok":
        extra = (f" chips={rec['chips']} trace={rec['trace_s']}s "
                 f"bottleneck={rec['roofline']['bottleneck']}")
    elif status == "error":
        extra = " " + rec.get("error", "")[:120]
    print(f"[dryrun] {label}: {status}{extra}", flush=True)
    return rec


def all_cells():
    cells = [(arch, shape) for arch in sorted(ARCHS)
             for shape in SHAPE_NAMES]
    return cells + [(g, "glb") for g in GLB_CELLS]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    if not args.all and not args.arch:
        ap.error("--arch required without --all")
    try:
        for arch, shape in cells:
            for mp in meshes:
                run_cell(arch, shape, mp, args.out)
    finally:
        close_world()


if __name__ == "__main__":
    main()
