#!/usr/bin/env python3
"""Where a sharded training step's memory goes, on one GPU.

    python3 tools/spmd_memory.py [--batch 8] [--seq 512]

tinyllama-1.1b at full width (bf16 compute on float32 masters, AdamW,
remat full), its state laid out by ``dist.sharding`` on (data x model)
meshes of gloo ranks sharing the card, as ``chip_smoke.py`` phase 11 lays
it out: a (1 x 1) world of one rank, a (2 x 2) world of four, and the (2
x 2) world with every collective staged through host memory (gloo's CUDA
reduce-scatters, all-reduces and all-to-alls as well as its all-gathers,
which it refuses on the card). After one warm-up step, each rank's peak
allocation over ``loss_and_grads`` and over ``adamw_update`` (CUDA
allocator: ``max_memory_allocated`` and the unrounded
``requested_bytes``), less what was allocated before the step, beside
the dry run's per-device prediction of the step (arguments plus the
traced peak, ``launch.dryrun.trace_lm`` on a fake world of the same size
and this device's mesh). Needs a CUDA device; prints the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

WORLDS = (("1x1", (1, 1), False), ("2x2", (2, 2), False),
          ("2x2 stage-all", (2, 2), True))


def _mem():
    import torch

    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats().get("requested_bytes.all.current", 0))


def _peaks(base):
    import torch

    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    return (torch.cuda.max_memory_allocated() - base[0],
            stats.get("requested_bytes.all.peak", 0) - base[1])


def _reset():
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def rank(cfg, shape, stage_all, B, S):
    """One rank: the laid-out state, a warm-up step, then the peaks of the
    loss and gradients and of the optimizer update."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import (batch_axes, distribute_tree,
                                           param_axes, tree_shardings)
    from repro_torch.models import init_lm
    from repro_torch.train.optimizer import OptConfig, adamw_init, \
        adamw_update
    from repro_torch.train.trainer import loss_and_grads

    if stage_all:
        C.STAGED = tuple(C.FUNCTIONAL)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    lay = lambda tree, axes: distribute_tree(tree, tree_shardings(
        axes, tree, mesh))
    gen = torch.Generator(device="cuda").manual_seed(0)
    with C.CollectiveLog():
        full = init_lm(cfg, gen, "cuda", dtype=torch.float32)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                             device="cuda", dtype=torch.int32)
        P = lay(full, param_axes(cfg, full))
        O = adamw_init(P)
        batch = lay({"tokens": toks}, batch_axes(cfg, "train"))
        del full
        torch.cuda.empty_cache()
        oc = OptConfig()
        _, _, g = loss_and_grads(P, cfg, batch)          # warm-up
        adamw_update(P, g, O, oc)
        del g
        base = _mem()
        _reset()
        _, _, g = loss_and_grads(P, cfg, batch)
        grads_peak = _peaks(base)
        _reset()
        adamw_update(P, g, O, oc)
        opt_peak = _peaks(base)
        del g
    return dict(resident=base[0], grads=grads_peak, opt=opt_peak)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[spmd_memory] {smi}", flush=True)

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models.config import ShapeConfig

    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"], remat="full")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    for label, mshape, stage_all in WORLDS:
        n = mshape[0] * mshape[1]
        try:
            DR.fake_world(n)
            mesh = init_device_mesh("cuda", mshape,
                                    mesh_dim_names=("data", "model"))
            tr = DR.trace_lm(DR._cell_cfg(cfg, shape), shape, mesh)
            mem = DR.lm_memory(tr, mesh)
        finally:
            DR.close_world()
        ranks = run_ranks(rank, n, cfg, mshape, stage_all, args.batch,
                          args.seq, backend="gloo", timeout=900,
                          pg_timeout=300)
        pred = mem["temp_size_in_bytes"]
        for i, r in enumerate(ranks):
            (ga, gr), (oa, orq) = r["grads"], r["opt"]
            print(f"[spmd_memory] {label} rank {i}: step temp predicted "
                  f"{pred / 2**30:.3f} GiB (traced, arguments "
                  f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB); "
                  f"loss and gradients {ga / 2**30:.3f} GiB allocated, "
                  f"{gr / 2**30:.3f} requested; adamw_update "
                  f"{oa / 2**30:.3f} / {orq / 2**30:.3f} GiB over the "
                  f"{r['resident'] / 2**30:.3f} GiB resident; {smi}",
                  flush=True)


if __name__ == "__main__":
    main()
