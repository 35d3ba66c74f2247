"""Shared neural building blocks (plain functions on tensors; parameters
are dicts of tensors)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise. Asking for CUDA on a machine without it raises; nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


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
def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) absolute int positions."""
    D = x.shape[-1]
    # Built on the device (in float64, as the JAX version) so that no host
    # copy, which would stall the stream, happens per layer.
    exps = torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D
    freqs = (1.0 / theta ** exps).float()                       # (D/2,)
    ang = positions.float()[..., None] * freqs                  # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
