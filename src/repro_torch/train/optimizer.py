"""AdamW + cosine schedule + global-norm clipping, the arithmetic of
``repro.train.optimizer`` in its order: clip by the global norm, float32
moments, bias correction with the step as float32, decoupled weight decay
on the float32 parameter.

The state mirrors the parameter tree (dicts and lists of tensors):
``{"m": tree, "v": tree, "step": int32 scalar}``. Unlike JAX, whose arrays
are immutable, ``adamw_update`` updates the parameters and both moments IN
PLACE (under ``torch.no_grad()``, each product and sum rounded as in
JAX's expression), so that a step holds one copy of each and not two:
1.1 B float32 parameters with their gradients and moments take 17.6 GB.
DTensor leaves (a sharded step) are updated alike, each rank on its
shards: the moments take the parameters' placements, the step and the
scalars made from it are replicated on their mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..dist.sharding import like


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(step, oc: OptConfig):
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``;
    ``step`` an int tensor, float32 math."""
    step = step.float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * warm * frac


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (JAX's leaf order, so that sums over leaves add in JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """A tree shaped like ``tree`` with leaves ``fn(leaf)``, ``fn`` called
    in ``tree_leaves`` order (so ``next`` over another tree's leaves pairs
    them up)."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    p0 = tree_leaves(params)[0]
    return {"m": zeros(), "v": zeros(),
            "step": like(p0, torch.zeros((), dtype=torch.int32,
                                         device=p0.device))}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, opt, oc: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step of ``grads`` (a tree shaped like ``params``).
    Returns (params, opt, {"grad_norm", "lr"}); the parameters and moments
    are the same tensors, updated in place."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(step, oc)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                          strict=True):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        u = u + oc.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
