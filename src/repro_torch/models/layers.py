"""Shared neural building blocks (plain functions on tensors; parameters
are dicts of tensors)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device  # noqa: F401  (re-exported)


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
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ------------------------------------------------------------------ RoPE
def _freqs(D: int, theta: float, device):
    # Built on the device (in float64, as the JAX version) so that no host
    # copy, which would stall the stream, happens per layer.
    exps = torch.arange(0, D, 2, dtype=torch.float64, device=device) / D
    return (1.0 / theta ** exps).float()                        # (D/2,)


def _rotate(x, ang):
    """Rotate the two halves of x (B, S, H, D) by angles ang (B, S, D/2)."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) absolute int positions."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_mrope(x, positions, theta: float, sections):
    """Qwen2-VL multimodal RoPE: positions (B, S, 3) = (temporal, h, w);
    the D/2 frequency lanes are split into ``sections`` (sum = D/2), each
    rotated by its own position stream."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head dim {D} / 2")
    freqs = _freqs(D, theta, x.device)
    sec_id = torch.cat([torch.full((n,), i, device=x.device)
                        for i, n in enumerate(sections)])        # (D/2,)
    pos = positions.float().index_select(-1, sec_id)            # (B,S,D/2)
    return _rotate(x, pos * freqs)


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
