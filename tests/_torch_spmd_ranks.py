"""Rank bodies for ``test_torch_spmd.py``: the port's models on DTensor
parameters laid out by ``dist.sharding`` on a (2, 2) ``("data",
"model")`` mesh of four gloo ranks of the CPU, run by
``repro_torch.launch.ranks.run_ranks``.

Torch and the port only, never JAX: the test file makes the weights,
batches and the JAX side's expectations in the parent and compares what
rank 0 returns (every DTensor gathered to its full tensor).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist.collectives import CollectiveLog
from repro_torch.dist.sharding import (batch_axes, distribute_tree,
                                       full_tree, opt_axes, param_axes,
                                       tree_shardings)
from repro_torch.models import decode_step, prefill
from repro_torch.models.moe import moe_fwd
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.trainer import loss_and_grads, make_train_step

MESH = ((2, 2), ("data", "model"))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree)


def lay(tree, axes, mesh):
    """``tree`` laid out by ``axes`` (logical axes) on ``mesh``."""
    return distribute_tree(tree, tree_shardings(axes, tree, mesh))


def greedy(logits, vocab):
    return torch.argmax(logits[:, -1:, ..., :vocab], dim=-1).to(torch.int32)


def family_step(cfg, params, batch, mesh, decode_steps: int):
    """The train, prefill and decode steps of one family on DTensors:
    the loss, metrics and gradients (full), the prefill logits and cache
    (full), and each greedy decode step's logits and tokens."""
    P = lay(params, param_axes(cfg, params), mesh)
    B = lay(batch, batch_axes(cfg, "train"), mesh)
    loss, metrics, grads = loss_and_grads(P, cfg, B)
    out = dict(loss=loss.full_tensor(), metrics=full_tree(metrics),
               grads=full_tree(grads),
               placements_kept=all(
                   g.placements == p.placements for g, p in zip(
                       torch.utils._pytree.tree_leaves(grads),
                       torch.utils._pytree.tree_leaves(P))))
    S = next(iter(batch.values())).shape[1]
    pb = {k: v for k, v in B.items() if k != "labels"}
    with torch.no_grad():
        logits, cache = prefill(P, cfg, pb, max_seq=S + decode_steps)
        out["prefill_logits"] = logits.full_tensor()
        out["prefill_cache"] = full_tree(cache)
        tok = greedy(out["prefill_logits"], cfg.vocab)
        steps = []
        tok_axes = batch_axes(cfg, "decode")["tokens"]
        for i in range(decode_steps):
            t = lay({"tokens": tok}, {"tokens": tok_axes}, mesh)["tokens"]
            logits, cache = decode_step(P, cfg, t, cache, S + i)
            full = logits.full_tensor()
            steps.append(dict(logits=full, tokens=tok))
            tok = greedy(full, cfg.vocab)
        out["decode"] = steps
        out["decode_cache"] = full_tree(cache)
    return out


def moe_layer_ep(cfg, p, x, mesh):
    """``moe_impl="auto"`` on DTensors (expert-parallel on this mesh)
    beside the explicit-mesh EP of plain tensors on this rank's data
    shard (``_moe_fwd_ep``, held to JAX's shard_map EP in
    ``test_torch_dist.py``): the outputs, full, and the statistics."""
    cfg = dataclasses.replace(cfg, moe_impl="auto")
    from repro_torch.dist.sharding import param_axes as pax

    axes = pax(cfg)["blocks"][0]["moe"]
    P = lay(p, axes, mesh)
    X = lay({"x": x}, {"x": ("batch", "seq", "act_embed")}, mesh)["x"]
    with torch.no_grad():
        y, aux = moe_fwd(P, X, cfg)
        d = mesh.get_local_rank("data")
        half = x.shape[0] // mesh["data"].size()
        yl, auxl = moe_fwd(p, x[d * half:(d + 1) * half], cfg, mesh=mesh)
    return dict(y=y.full_tensor(), y_plain_shard=yl, data_rank=d,
                aux={k: (v.full_tensor() if hasattr(v, "full_tensor")
                         else v) for k, v in aux.items()},
                aux_plain=auxl)


def cell_bytes(cfg, params, batch, mesh):
    """One ``make_train_step`` (AdamW) of the dry run's training cell on
    DTensors, under ``CollectiveLog``: the bytes and ops this rank handed
    to c10d, by HLO collective."""
    P = lay(params, param_axes(cfg, params), mesh)
    paxes = param_axes(cfg, params)
    opt = lay(adamw_init(params), opt_axes(paxes), mesh)
    B = lay(batch, batch_axes(cfg, "train"), mesh)
    step = make_train_step(cfg, OptConfig())
    with CollectiveLog() as log:
        step(P, opt, B)
    return dict(bytes=log.bytes, count=log.count)


def adamw_step(cfg, params, batch, mesh, microbatches: int):
    """One ``make_train_step`` on DTensors with ``microbatches`` slices:
    the parameters and moments after it (full) and its metrics."""
    paxes = param_axes(cfg, params)
    P = lay(params, paxes, mesh)
    opt = lay(adamw_init(params), opt_axes(paxes), mesh)
    B = lay(batch, batch_axes(cfg, "train"), mesh)
    P, opt, metrics = make_train_step(cfg, OptConfig(),
                                      microbatches=microbatches)(P, opt, B)
    return dict(params=full_tree(P), m=full_tree(opt["m"]),
                v=full_tree(opt["v"]), metrics=full_tree(metrics))


def staged_prefill(cfg, params, batch, mesh):
    """The prefill logits with every all-gather staged through host
    memory (as gloo's CUDA all-gathers are; forced here on the CPU), and
    without."""
    from repro_torch.dist import collectives as C

    P = lay(params, param_axes(cfg, params), mesh)
    B = lay({"tokens": batch["tokens"]}, batch_axes(cfg, "prefill"), mesh)
    S = batch["tokens"].shape[1]
    out = {}
    plain = C._needs_stage
    try:
        for staged in (False, True):
            if staged:
                C._needs_stage = lambda name, ins, group: name in C.STAGED
            with torch.no_grad(), CollectiveLog() as log:
                logits, _ = prefill(P, cfg, B, max_seq=S)
            out["staged" if staged else "direct"] = logits.full_tensor()
            out["bytes_staged" if staged else "bytes_direct"] = log.bytes
    finally:
        C._needs_stage = plain
    return out


def spmd_cases(inp):
    """Every family's steps, the MoE layer's EP, and the training cell's
    collective bytes, on one world of four ranks. Rank 0 returns the
    results; every rank returns its cell bytes."""
    torch.manual_seed(0)
    mesh = init_device_mesh("cpu", *MESH[:1], mesh_dim_names=MESH[1])
    out = {"families": {}}
    for fam, c in inp["families"].items():
        out["families"][fam] = family_step(
            c["cfg"], _torch(c["params"]), _torch(c["batch"]), mesh,
            inp["decode_steps"])
    m = inp["moe_layer"]
    out["moe_layer"] = moe_layer_ep(m["cfg"], _torch(m["p"]),
                                    torch.from_numpy(m["x"]), mesh)
    cell = inp["cell"]
    out["cell"] = cell_bytes(cell["cfg"], _torch(cell["params"]),
                             _torch(cell["batch"]), mesh)
    d = inp["families"]["dense"]
    out["adamw"] = adamw_step(d["cfg"], _torch(d["params"]),
                              _torch(d["batch"]), mesh, 2)
    out["staged"] = staged_prefill(d["cfg"], _torch(d["params"]),
                                   _torch(d["batch"]), mesh)
    if dist.get_rank():
        return {"cell": out["cell"]}
    return out
