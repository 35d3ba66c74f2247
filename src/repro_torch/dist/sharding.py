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

from torch.distributed.tensor import DTensor, Replicate, Shard

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


# ----------------------------------------------------------- activations
def shard_act(x, *axes: str):
    """A sharding constraint resolved through the rule engine.

    A plain tensor comes back unchanged (JAX's no-op outside a mesh: no
    model code of the port calls this). A ``DTensor`` is redistributed to
    the placements ``axes`` resolve to on its own mesh; a typo'd logical
    axis or a rank mismatch raises, as JAX's inside a mesh."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = spec_for(tuple(x.shape), axes, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


__all__ = ["LOGICAL_AXIS_RULES", "LeafSharding", "batch_axes", "cache_axes",
           "mesh_shape", "opt_axes", "param_axes", "placements",
           "shard_act", "spec_for", "tree_shardings", "tree_specs"]
