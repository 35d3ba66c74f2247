"""Collective bytes per device, under the keys of
``repro.analysis.hlo.collective_bytes`` (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``, ``total``,
``count``). The counterpart of ``repro.analysis.hlo``, which parses them
out of XLA's optimized per-device module; the port has no such module, so
they come from one of three places:

  traced   — ``collective_bytes(wire, calls)``: what one rank handed to
             ``dist.collectives`` (the ``wire_bytes`` / ``wire_calls``
             deltas of a run), ``all_gather`` -> ``all-gather``,
             ``all_reduce`` -> ``all-reduce``, ``all_to_all`` ->
             ``all-to-all``, ``ppermute`` -> ``collective-permute``. The
             GLB cells' bytes are these (``core.executor.lower_shardmap``).
  traced   — ``traced_lm(cfg, shape, mesh)``: a language-model step run
             per device on DTensors laid out by ``dist.sharding`` (the
             counterpart of XLA's per-device module), on ``meta`` tensors
             in a ``fake`` world as the dry run runs it, or on real ones;
             every c10d functional collective that DTensor's sharding
             propagation and the models issue on this rank
             (``dist.collectives.CollectiveLog``: all-gather,
             reduce-scatter, all-reduce, all-to-all), its input's bytes.
             The language-model cells' bytes are these.
  reckoned — ``reckon_lm(cfg, kind, batch, seq, mesh)``: a language-model
             step's collectives worked out from the sharding rule
             (``dist.sharding``), without a trace: the floor that the
             traced bytes are held above:
             (a) in training, each parameter's float32 gradient is
                 all-reduced over the mesh axes its leaf is replicated on
                 (its local shard's bytes, one op a leaf);
             (b) a product whose weight is sharded on its contracted
                 dimension (attention's ``wo``, the MLP's ``wo``, Mamba2's
                 ``out_proj``) all-reduces its local (B, S, d_model)
                 output, at each application;
             (c) a MoE layer whose experts are sharded over ``model``
                 (``moe_impl`` ``auto`` or ``ep`` on a ``model`` axis that
                 divides ``n_experts``) sends what ``_moe_fwd_ep`` hands to
                 the collectives: the ``psum`` of its (T_local, d_model)
                 output over ``model`` and, over each data axis, the
                 ``psum`` of its aux loss, expert counts and drops. Like
                 JAX's, that dispatch combines with one all-reduce; it
                 sends no all-to-all.
             A collective over an axis of one rank moves nothing and is
             not counted. In training, (b) and (c) count once for the
             forward pass, once for its dual in the backward pass
             (Megatron's f / g pair), and once more for the forward
             recomputed under remat, except at a layer's last product
             (the MLP's or the MoE's, Mamba2's ``out_proj`` where no
             shared block follows): its output feeds only the residual
             sum, whose gradient needs no saved value, so the recompute
             stops before it (``torch.utils.checkpoint``'s early stop;
             XLA drops the dead recompute alike).
             Not reckoned: what a partitioner adds for FSDP (the
             all-gather of each weight sharded over ``data`` before use
             and the reduce-scatter of its gradient), the vocab-sharded
             embedding lookup and loss, and the sequence-sharded decode
             cache's attention. So the reckoned bytes are a floor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..dist.sharding import batch_axes, mesh_shape, param_axes, spec_for

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
HLO_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "all_to_all": "all-to-all", "ppermute": "collective-permute"}
# (parent, leaf) of the products whose weight's contracted dim is dim 0
ROW_PARALLEL = {("attn", "wo"), ("mlp", "wo"), ("mamba", "out_proj")}


def _finish(out: Dict[str, int], count: int) -> Dict[str, int]:
    out = {k: v for k, v in out.items() if v}
    out["total"] = sum(out.get(k, 0) for k in COLLECTIVES)
    out["count"] = count
    return out


def collective_bytes(wire: Dict[str, int],
                     calls: Optional[Dict[str, int]] = None
                     ) -> Dict[str, int]:
    """``dist.collectives``' per-op counts (the deltas of ``wire_bytes``
    and ``wire_calls`` over a run) under the HLO collectives' names."""
    out = {}
    for op, n in wire.items():
        out[HLO_NAMES[op]] = out.get(HLO_NAMES[op], 0) + int(n)
    return _finish(out, int(sum((calls or {}).values())))


def _names(entry) -> tuple:
    """The mesh axes of one spec entry."""
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def _axes_size(entry, sizes: Dict[str, int]) -> int:
    n = 1
    for a in _names(entry):
        n *= sizes[a]
    return n


def _shard(dim: int, entry, sizes: Dict[str, int]) -> int:
    return dim // _axes_size(entry, sizes)


def local_numel(shape, spec, sizes: Dict[str, int]) -> int:
    """Elements of one device's shard of a tensor laid out by ``spec``."""
    n = 1
    for d, e in zip(shape, spec):
        n *= _shard(int(d), e, sizes)
    return n


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def local_batch(cfg, kind: str, batch: int, mesh) -> int:
    """Rows of the global batch one device holds (the inputs' ``batch``
    axis through the rule)."""
    axes = next(iter(batch_axes(cfg, kind).values()))   # batch leads
    spec = spec_for((batch,) + (1,) * (len(axes) - 1), axes, mesh)
    return _shard(batch, spec[0], mesh_shape(mesh))


def ep_applies(cfg, mesh) -> bool:
    """Whether the MoE layers run expert-parallel on ``mesh`` (the port's
    ``models.moe._ep_mesh`` rule)."""
    sizes = mesh_shape(mesh)
    return (cfg.family == "moe" and cfg.moe_impl in ("auto", "ep")
            and "model" in sizes and cfg.n_experts % sizes["model"] == 0)


def _ep_axes(mesh) -> Tuple[bool, int]:
    """Whether ``_moe_fwd_ep``'s psum over ``model`` moves data, and over
    how many data axes its statistics' psums do (axes of one rank move
    nothing and are not counted)."""
    sizes = mesh_shape(mesh)
    return (sizes.get("model", 1) > 1,
            sum(sizes.get(a, 1) > 1 for a in ("pod", "data")))


def moe_ep_bytes(cfg, tokens_local: int, mesh, dtype) -> int:
    """Bytes one rank hands to the collectives in one ``_moe_fwd_ep``
    call on ``tokens_local`` tokens: the output's psum over ``model``,
    then aux loss, counts and drops (float32) over each data axis."""
    over_model, n_dp = _ep_axes(mesh)
    es = torch.empty((), dtype=dtype).element_size()
    return (over_model * tokens_local * cfg.d_model * es
            + n_dp * 4 * (1 + cfg.n_experts + 1))


def reckon_lm(cfg, kind: str, batch: int, seq: int, mesh,
              pshapes=None) -> Dict[str, int]:
    """Per-device collective bytes of one step of ``kind`` (``train``,
    ``prefill`` or ``decode``) at ``batch`` x ``seq`` tokens (decode: one
    token a row) on ``mesh``, reckoned as the module docstring says.
    ``pshapes``: the parameter tree (any device; by default made on
    ``meta``)."""
    from ..models.transformer import compute_dtype

    sizes = mesh_shape(mesh)
    if pshapes is None:
        from ..models import init_lm

        pshapes = init_lm(cfg, device="meta")
    paxes = param_axes(cfg, pshapes)
    axes_of = dict(_leaves(paxes))
    dt = compute_dtype(cfg)
    es = torch.empty((), dtype=dt).element_size()
    rows = local_batch(cfg, kind, batch, mesh) * (1 if kind == "decode"
                                                  else seq)
    fwd = 1
    remat = kind == "train" and cfg.remat != "none"
    if kind == "train":
        fwd = 2
    napps = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 1
    reduce, count = 0, 0
    for path, leaf in _leaves(pshapes):
        spec = spec_for(tuple(leaf.shape), axes_of[path], mesh)
        if kind == "train":                                    # (a)
            used = {a for e in spec for a in _names(e)}
            if any(n > 1 and a not in used for a, n in sizes.items()):
                reduce += local_numel(leaf.shape, spec, sizes) * 4
                count += 1
        if path[-2:] in ROW_PARALLEL and _axes_size(spec[0], sizes) > 1:  # (b)
            apps = napps if path[0] == "shared" else 1
            last = path[-2] == "mlp" or (path[-2] == "mamba" and not (
                cfg.family == "hybrid" and (path[1] + 1) % cfg.attn_every
                == 0))
            passes = fwd + (remat and not last)
            reduce += passes * apps * rows * cfg.d_model * es
            count += passes * apps
    if ep_applies(cfg, mesh):                                   # (c)
        reduce += fwd * cfg.n_layers * moe_ep_bytes(cfg, rows, mesh, dt)
        over_model, n_dp = _ep_axes(mesh)
        count += fwd * cfg.n_layers * (over_model + 3 * n_dp)
    return _finish({"all-reduce": reduce}, count)


def traced_lm(cfg, shape, mesh, microbatches: int = 1, device="meta"):
    """One step of the cell (``cfg``, ``shape``: train, prefill or
    decode, the dry run's steps and arguments, ``configs.input_specs``
    on ``device``) on ``mesh``, each leaf laid out by ``dist.sharding``
    and the step run on this rank's shards under ``analysis.cost.trace``
    and ``dist.collectives.CollectiveLog``. Returns {"coll": the bytes
    handed to each collective under HLO's keys, with ``total`` and
    ``count``, "cost": the trace's per-device FLOPs, bytes and peak,
    "metrics": a training step's metrics}."""
    from ..analysis.cost import trace
    from ..configs import input_specs
    from ..dist.collectives import CollectiveLog
    from ..dist.sharding import (cache_axes, distribute_tree, opt_axes,
                                 tree_shardings)
    from ..models import init_lm
    from ..train.optimizer import OptConfig, adamw_init
    from ..train.trainer import (make_decode_step, make_prefill_step,
                                 make_train_step)

    def lay(tree, axes):
        return distribute_tree(tree, tree_shardings(axes, tree, mesh))

    def build(cfg):
        """The cell's step and its arguments, laid out on ``mesh``."""
        kind = shape.kind
        batch = input_specs(cfg, shape, device=device)
        if kind == "train":
            params = init_lm(cfg, device=device, dtype=torch.float32)
            paxes = param_axes(cfg, params)
            return make_train_step(cfg, OptConfig(),
                                   microbatches=microbatches), (
                lay(params, paxes), lay(adamw_init(params),
                                        opt_axes(paxes)),
                lay(batch, batch_axes(cfg, kind)))
        params = init_lm(cfg, device=device)
        P = lay(params, param_axes(cfg, params))
        b = lay(batch, batch_axes(cfg, kind))
        if kind == "prefill":
            return make_prefill_step(cfg, max_seq=shape.seq_len), (P, b)
        return make_decode_step(cfg), (P, b["tokens"], b["cache"],
                                       b["cache_len"])

    kind = shape.kind
    step, args = build(cfg)
    with torch.set_grad_enabled(kind == "train"):
        if device == "meta":
            # DTensor's sharding propagation makes its example tensors as
            # plain ops on its first sight of each op: run the step once
            # on the first layers alone (every layer's ops are the same;
            # the hybrid's first period reaches its shared block), so that
            # the trace sees only the step's own ops
            first = (cfg.attn_every if cfg.family == "hybrid" else 1)
            warm, wargs = build(dataclasses.replace(
                cfg, n_layers=min(first, cfg.n_layers)))
            warm(*wargs)
            del warm, wargs
        with CollectiveLog() as log:
            out, cost = trace(step, *args)
    coll = _finish(dict(log.bytes), sum(log.count.values()))
    metrics = out[2] if kind == "train" else {}
    return {"coll": coll, "cost": cost, "metrics": metrics}


__all__ = ["COLLECTIVES", "HLO_NAMES", "collective_bytes", "ep_applies",
           "local_batch", "local_numel", "moe_ep_bytes", "reckon_lm",
           "traced_lm"]
