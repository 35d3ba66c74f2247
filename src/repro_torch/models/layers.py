"""Shared neural building blocks (plain functions on tensors; parameters
are dicts of tensors). Each takes plain tensors or DTensors alike: the
constants it builds (RoPE frequencies and section ids) are made
replicated on a DTensor activation's mesh (``dist.sharding.like``), and
a norm sums a partial DTensor first (``dist.sharding.reduced``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device  # noqa: F401  (re-exported)
from ..dist.sharding import like, local_call, reduced


def dense_init(shape, generator, device, in_axis: int = 0):
    """Truncated-normal (+-2 std) fan-in init in float32, the
    distribution of ``repro.models.layers.dense_init``."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)


def embed_init(shape, generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                       generator=generator)


def rmsnorm(x, scale, eps: float):
    xf = reduced(x).float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def _whole_heads(t, H: int, dim: int):
    """t's placements with its split of dim ``dim`` (heads, or heads x
    head dim) kept only over as many ranks as divide the H heads evenly,
    every other split of dims >= ``dim`` gathered."""
    n, pls = 1, []
    for md, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim >= dim:
            if p.dim == dim and H % (n * t.device_mesh.size(md)) == 0:
                n *= t.device_mesh.size(md)
            else:
                p = Replicate()
        pls.append(p)
    return tuple(pls)


def split_heads(t, H: int, hd: int):
    """(B, S, H * hd) -> (B, S, H, hd). A DTensor is split on each rank's
    shard: a last dim split over more ranks than there are heads (a
    projection's columns split over ``model``: attention's q, k, v,
    Mamba2's inner channels) is gathered on those mesh dims first, as
    GSPMD replicates a dim that does not divide, so that each rank holds
    whole heads."""
    B, S = t.shape[:2]
    if not isinstance(t, DTensor):
        return t.reshape(B, S, H, hd)
    pls = _whole_heads(t, H, 2)
    t = t.redistribute(t.device_mesh, pls)
    return local_call(lambda x: x.view(x.shape[0], x.shape[1], -1, hd),
                      pls, t)


def merge_heads(t):
    """(B, S, H, hd) -> (B, S, H * hd), the inverse of ``split_heads``:
    a DTensor is merged on each rank's whole heads (a split of the head
    dim, or an uneven one of the heads, is gathered first)."""
    B, S, H, hd = t.shape
    if not isinstance(t, DTensor):
        return t.reshape(B, S, H * hd)
    pls = _whole_heads(t, H, 2)
    t = t.redistribute(t.device_mesh, pls)
    return local_call(lambda x: x.reshape(x.shape[0], x.shape[1], -1), pls,
                      t)


# ------------------------------------------------------------------ RoPE
def _freqs(x, theta: float):
    """(D/2,) float32 frequencies for x's head dim D, on x's device (and
    mesh). Built on the device (in float64, as the JAX version) so that
    no host copy, which would stall the stream, happens per layer."""
    D = x.shape[-1]
    exps = torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D
    return like(x, (1.0 / theta ** exps).float())


def _rotate(x, ang):
    """Rotate the two halves of x (B, S, H, D) by angles ang (B, S, D/2).
    A DTensor is rotated on each rank's tokens and heads (the angles
    follow x's batch and sequence splits; a split head dim is gathered):
    the rotation is elementwise there."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 3 else p
              for p in x.placements]
        x = x.redistribute(mesh, pl)
        ang = ang.redistribute(mesh, [
            p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in pl])
        return local_call(_rotate, tuple(pl), x, ang)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) absolute int positions."""
    return _rotate(x, like(x, positions).float()[..., None]
                   * _freqs(x, theta))


def apply_mrope(x, positions, theta: float, sections):
    """Qwen2-VL multimodal RoPE: positions (B, S, 3) = (temporal, h, w);
    the D/2 frequency lanes are split into ``sections`` (sum = D/2), each
    rotated by its own position stream."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head dim {D} / 2")
    sec_id = like(x, torch.cat([torch.full((n,), i, device=x.device)
                                for i, n in enumerate(sections)]))  # (D/2,)
    pos = like(x, positions).float().index_select(-1, sec_id)   # (B,S,D/2)
    return _rotate(x, pos * _freqs(x, theta))


# ------------------------------------------------------------------ MLP
def mlp_init(d_model: int, d_ff: int, generator, device, dtype):
    return {
        "wg": dense_init((d_model, d_ff), generator, device).to(dtype),
        "wi": dense_init((d_model, d_ff), generator, device).to(dtype),
        "wo": dense_init((d_ff, d_model), generator, device).to(dtype),
    }


def mlp_fwd(p, x):
    """SwiGLU; the weights are stored in the compute dtype."""
    g = F.silu(x @ p["wg"])
    return (g * (x @ p["wi"])) @ p["wo"]
