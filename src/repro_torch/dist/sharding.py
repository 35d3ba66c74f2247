"""Logical-axis sharding rule engine. The counterpart of
``repro.dist.sharding``.

Every tensor — parameter leaves, optimizer state, inputs, KV / SSM caches,
activations — is described by a tuple of *logical* axis names ("embed",
"qkv", "batch", "cache_seq", ...). One table maps logical names to mesh
axes, and ``spec_for`` resolves any (shape, logical axes, mesh) triple
into a spec, with JAX's three rules:

  * divisibility fallback — a mesh axis that does not divide the dimension
    is dropped (replicate rather than split unevenly);
  * multi-axis batch — "batch" maps to ``("pod", "data")``, taking every
    dividing axis in rule order (a non-dividing one is skipped, later
    candidates are still tried);
  * per-tensor conflict resolution — a mesh axis is used at most once per
    spec: the first (leftmost) logical axis wins, later claimants
    replicate.

A spec is a tuple with one entry per tensor dim: None, a mesh-axis name,
or a tuple of names, the entries of JAX's ``PartitionSpec``.
``tree_shardings`` turns specs into ``torch.distributed`` placements on a
``DeviceMesh``: per mesh dim ``Shard(d)`` if the spec gives it to tensor
dim d, else ``Replicate()``; a dim split over two mesh axes gets
``Shard(d)`` on both, the outer one first (as the mesh lists them, which
is the rule order for every mesh this repo builds).

The layout this encodes is FSDP("data") x TP/EP("model") x DP("pod",
"data"): weight embed dims over ``data``, head / ffn / expert / vocab dims
over ``model``, batch dims over (``pod``, ``data``), and decode KV caches
their sequence dim over ``model``.

``spec_for`` reads only ``mesh.shape`` as a name -> size mapping (tests
pass fakes) or, for a ``DeviceMesh``, its ``mesh_dim_names`` and
``shape``. The port's parameter tree keeps one dict per layer in
``blocks`` (``models.transformer``), so its layer leaves have no leading
``layer`` axis: their axes are JAX's stacked leaves' without it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)

Axes = Tuple[str, ...]

# Logical axis -> ordered mesh-axis candidates. An empty tuple means
# "always replicated".
LOGICAL_AXIS_RULES: Dict[str, Tuple[str, ...]] = {
    # data-ish dims
    "batch": ("pod", "data"),
    "seq": (),
    "act_embed": (),
    # weight dims
    "embed": ("data",),          # FSDP / ZeRO-3: weight embed dim over data
    "vocab": ("model",),
    "qkv": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "expert": ("model",),        # expert parallelism
    "d_inner": ("model",),       # mamba inner channels (TP)
    # cache dims
    "cache_seq": ("model",),     # decode KV cache: sequence over model
    # structural / replicated
    "layer": (),
    "conv": (),
    "state": (),
    "none": (),
}


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of anything with a
    ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_for(shape: Tuple[int, ...], axes: Axes, mesh) -> tuple:
    """Resolve logical ``axes`` for a tensor of ``shape`` on ``mesh``."""
    if len(shape) != len(axes):
        raise ValueError(
            f"rank mismatch: shape {tuple(shape)} vs logical axes {axes}")
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        try:
            rule = LOGICAL_AXIS_RULES[name]
        except KeyError:
            raise KeyError(
                f"unknown logical axis {name!r}; known: "
                f"{sorted(LOGICAL_AXIS_RULES)}") from None
        picked = []
        rem = int(dim)
        for ax in rule:
            n = sizes.get(ax)
            if n is None or ax in used:
                continue
            if rem % n == 0:
                picked.append(ax)
                used.add(ax)
                rem //= n
        if not picked:
            entries.append(None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    return tuple(entries)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) for e in x)


def _map(fn, axes_tree, shapes_tree):
    """``fn(axes, leaf)`` over an axes tree and the tree of tensors (or
    anything with ``.shape``) it describes; dicts and lists."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map(fn, v, shapes_tree[k]) for k, v in axes_tree.items()}
    return [_map(fn, a, s) for a, s in zip(axes_tree, shapes_tree,
                                           strict=True)]


def tree_specs(axes_tree, shapes_tree, mesh):
    """A logical-axes tree and the matching tree of tensors -> spec tree."""
    return _map(lambda ax, s: spec_for(tuple(s.shape), ax, mesh),
                axes_tree, shapes_tree)


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """Where a leaf lives: a ``DeviceMesh`` and one placement per mesh dim
    (``distribute_tensor(t, sh.mesh, sh.placements)``)."""
    mesh: Any
    placements: tuple


def placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh``, one per mesh dim."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def tree_shardings(axes_tree, shapes_tree, mesh):
    """Like ``tree_specs``, but each leaf's ``LeafSharding`` on the
    ``DeviceMesh`` ``mesh``."""
    return _map(lambda ax, s: LeafSharding(
        mesh, placements(spec_for(tuple(s.shape), ax, mesh), mesh)),
        axes_tree, shapes_tree)


# --------------------------------------------------------------- params
_ATTN_AXES = {
    "wq": ("embed", "qkv"), "wk": ("embed", "qkv"), "wv": ("embed", "qkv"),
    "wo": ("qkv", "embed"),
    "bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",),
}
_MLP_AXES = {
    "wg": ("embed", "ffn"), "wi": ("embed", "ffn"), "wo": ("ffn", "embed"),
}
_MOE_AXES = {
    "router": ("embed", "none"),
    # pure EP: `model` is consumed by the expert dim, so the ffn dim
    # conflict-resolves to replicated within each expert shard
    "wg": ("expert", "embed", "ffn"),
    "wi": ("expert", "embed", "ffn"),
    "wo": ("expert", "ffn", "embed"),
}
_MAMBA_AXES = {
    "wz": ("embed", "d_inner"), "wx": ("embed", "d_inner"),
    "wB": ("embed", "none"), "wC": ("embed", "none"),
    "wdt": ("embed", "none"),
    "conv_x": ("conv", "d_inner"),
    "conv_B": ("conv", "none"), "conv_C": ("conv", "none"),
    "A_log": ("none",), "D": ("none",), "dt_bias": ("none",),
    "gate_norm": ("d_inner",),
    "out_proj": ("d_inner", "embed"),
}
_BY_PARENT = {
    "attn": _ATTN_AXES, "mlp": _MLP_AXES, "moe": _MOE_AXES,
    "mamba": _MAMBA_AXES,
}
_NORMS = {"ln", "ln1", "ln2", "final_ln"}


def _param_leaf_axes(keys, ndim: int) -> Axes:
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else None
    if name == "embed":
        axes = ("vocab", "embed") if ndim == 2 else ("none", "vocab",
                                                     "embed")
    elif name == "head":
        axes = ("embed", "vocab") if ndim == 2 else ("none", "embed",
                                                     "vocab")
    elif name in _NORMS:
        axes = ("embed",)
    elif parent in _BY_PARENT and name in _BY_PARENT[parent]:
        axes = _BY_PARENT[parent][name]
    else:
        raise KeyError(
            f"no logical-axis rule for param leaf "
            f"{'/'.join(map(str, keys))!r}")
    if len(axes) != ndim:
        raise ValueError(f"param leaf {'/'.join(map(str, keys))!r}: rank "
                         f"{ndim} != axes {axes}")
    return axes


def _walk(tree, keys=()):
    if isinstance(tree, dict):
        return {k: _walk(v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, keys + (i,)) for i, v in enumerate(tree)]
    return _param_leaf_axes(keys, tree.dim())


def param_axes(cfg, pshapes=None) -> Any:
    """Logical-axes tree matching ``models.init_lm(cfg)`` for any
    registered arch. ``pshapes`` is a parameter tree (any device); by
    default one is made on the ``meta`` device, which allocates nothing."""
    if pshapes is None:
        from ..models import init_lm

        pshapes = init_lm(cfg, device="meta")
    return _walk(pshapes)


def opt_axes(paxes) -> Any:
    """Axes for the AdamW state: moments mirror the params, step is
    scalar."""
    return {"m": paxes, "v": paxes, "step": ()}


# ---------------------------------------------------------------- inputs
def batch_axes(cfg, kind: str) -> Any:
    """Logical axes of a batch of each kind (``train``, ``prefill``,
    ``decode``), as JAX's ``configs.input_specs`` lays it out."""
    if kind in ("train", "prefill"):
        if cfg.family == "vlm":
            axes = {
                "embeds": ("batch", "seq", "act_embed"),
                "positions": ("batch", "seq", "none"),
            }
            if kind == "train":
                axes["labels"] = ("batch", "seq")
            return axes
        if cfg.n_codebooks:
            return {"tokens": ("batch", "seq", "none")}
        return {"tokens": ("batch", "seq")}
    # decode: one token against a cache
    tok = ("batch", "none", "none") if cfg.n_codebooks else ("batch", "none")
    return {"tokens": tok, "cache": cache_axes(cfg), "cache_len": ()}


def cache_axes(cfg) -> Any:
    """Logical axes for ``models.make_cache(cfg, ...)``. The KV sequence
    dim takes ``model`` (sequence-sharded decode cache), which
    conflict-resolves kv_heads to replicated."""
    from ..models.transformer import n_attn_caches

    axes: Dict[str, Axes] = {}
    if n_attn_caches(cfg):
        kv = ("layer", "batch", "cache_seq", "kv_heads", "none")
        axes["k"] = kv
        axes["v"] = kv
    if cfg.family in ("ssm", "hybrid"):
        axes["conv_x"] = ("layer", "batch", "conv", "d_inner")
        axes["conv_B"] = ("layer", "batch", "conv", "none")
        axes["conv_C"] = ("layer", "batch", "conv", "none")
        axes["ssm"] = ("layer", "batch", "heads", "none", "none")
    return axes


# ------------------------------------------------------------- layouts
def local_shard(t, mesh, placements_):
    """This rank's shard of the full tensor ``t`` under ``placements_``
    on ``mesh`` (a view: no copy, no communication). Mesh dims split in
    order, the outer first, as ``distribute_tensor`` splits them."""
    coord = mesh.get_coordinate()
    for md, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            n = mesh.size(md)
            step = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[md] * step, step)
    return t


def distribute_leaf(t, sh: LeafSharding):
    """The full tensor ``t`` (on any device, the same on every rank) laid
    out by ``sh``: each rank keeps a contiguous copy of its own shard, on
    ``t``'s device, and nothing is sent (the counterpart of ``jax.
    device_put`` with a ``NamedSharding``)."""
    local = local_shard(t.detach(), sh.mesh, sh.placements).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sh.mesh, sh.placements,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def distribute_tree(tree, shardings):
    """``tree`` (dicts and lists of tensors) laid out leaf by leaf by
    ``shardings``, a ``tree_shardings`` tree of the same structure."""
    if isinstance(shardings, LeafSharding):
        return distribute_leaf(tree, shardings)
    if isinstance(shardings, dict):
        return {k: distribute_tree(tree[k], v) for k, v in shardings.items()}
    return [distribute_tree(t, s) for t, s in zip(tree, shardings,
                                                  strict=True)]


def sharded_zeros(shape, dtype, axes: Axes, mesh, device):
    """Zeros of ``shape`` laid out by the logical ``axes`` on ``mesh``, as
    a DTensor: each rank allocates only its own shard, on ``device``
    (no tensor of the full shape is made, not even on ``meta``)."""
    shape = tuple(shape)
    pls = placements(spec_for(shape, axes, mesh), mesh)
    local = list(shape)
    for md, p in enumerate(pls):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(md)
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, pls,
        run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def full_tree(tree):
    """The inverse of ``distribute_tree``: every DTensor leaf gathered into
    its full tensor (a collective on every rank); other leaves as they
    are."""
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    return tree


def like(x, t):
    """``t``, a plain tensor every rank makes alike, as a DTensor
    replicated on ``x``'s mesh when ``x`` is a DTensor; else ``t``. The
    models build their constants (RoPE angles, positions, zero states)
    through this, so that no plain tensor meets a DTensor."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_call(fn, out_placements, *args, mesh=None):
    """``fn`` on the local shards of the DTensor arguments (other
    arguments as they are), its outputs (one tensor or a tuple) made
    DTensors with ``out_placements`` (one placement tuple per output, or
    None for an output that is not a tensor) on the arguments' mesh.
    Differentiable: ``to_local`` and ``from_local`` carry the gradients
    with the placements stated. The caller states placements under which
    ``fn`` of the shards is the shard of ``fn`` (heads, batch: work that
    is embarrassingly parallel), or ``Partial`` where it is a sum. On a
    mesh dim where the work is split (an output is not replicated there),
    an input replicated there gets its gradient as a ``Partial`` sum:
    each rank's part comes from its own share of the work."""
    if mesh is None:
        mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    single = out_placements is None or isinstance(out_placements[0],
                                                  Placement)
    pls = (out_placements,) if single else out_placements
    split = {md for pl in pls if pl is not None
             for md, p in enumerate(pl) if not isinstance(p, Replicate)}

    def local(a):
        if not isinstance(a, DTensor):
            return a
        return a.to_local(grad_placements=[
            Partial() if md in split and isinstance(p, Replicate) else p
            for md, p in enumerate(a.placements)])

    out = fn(*(local(a) for a in args))
    outs = (out,) if single else out
    wrapped = tuple(
        o if pl is None else DTensor.from_local(o, mesh, pl,
                                                run_check=False)
        for o, pl in zip(outs, pls, strict=True))
    return wrapped[0] if single else wrapped


def _sum_partial(x):
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


class _Reduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum_partial(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_partial(g)


def reduced(x):
    """A DTensor's partial sums summed (an all-reduce over the mesh dims
    where it is ``Partial``), its shards kept, and so its gradient's in
    the backward pass (Megatron's f and g); a plain tensor as is. The
    models reduce the residual stream's inputs and a norm's input so:
    left to itself, sharding propagation carries a partial sum through a
    norm's scaling or a residual sum and then gathers the next product's
    weight whole, or the batch of its gradient."""
    if not isinstance(x, DTensor):
        return x
    return _Reduced.apply(x)


def replicated(x):
    """A DTensor replicated on every dim of its mesh (an all-gather of its
    shards, an all-reduce of its partial sums); a plain tensor as is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim)


# ----------------------------------------------------------- activations
def shard_act(x, *axes: str):
    """A sharding constraint resolved through the rule engine, at the
    JAX package's sites (q, k and v, the residual stream after every
    block, the MoE's expert slot buffers).

    A plain tensor comes back unchanged (JAX's no-op outside a mesh). A
    ``DTensor`` is redistributed to the placements ``axes`` resolve to on
    its own mesh; a typo'd logical axis or a rank mismatch raises, as
    JAX's inside a mesh."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = spec_for(tuple(x.shape), axes, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


__all__ = ["LOGICAL_AXIS_RULES", "LeafSharding", "batch_axes", "cache_axes",
           "distribute_leaf", "distribute_tree", "full_tree", "like",
           "local_call", "local_shard", "mesh_shape", "opt_axes",
           "param_axes", "placements", "reduced", "replicated", "shard_act",
           "sharded_zeros", "spec_for", "tree_shardings", "tree_specs"]
