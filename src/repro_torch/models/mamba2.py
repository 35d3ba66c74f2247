"""Mamba2 (SSD) block: per-component projections [z | x | B | C | dt],
causal depthwise conv over x/B/C, the selective state-space scan
(``kernels.ops.ssd``: the ``ssd_chunked`` kernel on the card), gated
RMSNorm, out_proj. Decode carries (conv state, ssm state) per slot
instead of a KV cache. The counterpart of ``repro.models.mamba2``.

Caches are updated IN PLACE (the JAX version returns new arrays): the
cache leaves passed in are per-layer views of the engine's cache tensors.
The conv states hold ``cfg.dtype`` values (they are the conv inputs,
already in the compute dtype), the ssm state float32. In decode, a slot
whose ``active`` flag is False (idle or finished) keeps its state.

Parameters: projections and conv weights in the compute dtype; ``A_log``,
``D``, ``dt_bias`` and ``gate_norm`` in float32, cast at use as the JAX
version does (``D`` to the compute dtype, ``dt_bias`` added in float32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import dense_init, merge_heads, rmsnorm, split_heads

CONV_KEYS = ("conv_x", "conv_B", "conv_C")
STATE_KEYS = CONV_KEYS + ("ssm",)


def mamba_init(cfg: ModelConfig, generator, device, dtype):
    """Random weights with the distributions of ``repro.models.mamba2.
    mamba_init``: fan-in truncated normals, convs at half scale,
    A = -exp(0) = -1, D = 1, zero dt bias and gate-norm scale."""
    D, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = lambda shape, scale=1.0: (
        dense_init(shape, generator, device) * scale).to(dtype)
    f32 = lambda n, v: torch.full((n,), v, dtype=torch.float32,
                                  device=device)
    return {
        "wz": w((D, di)),
        "wx": w((D, di)),
        "wB": w((D, ns)),
        "wC": w((D, ns)),
        "wdt": w((D, nh)),
        "conv_x": w((cfg.ssm_conv, di), 0.5),
        "conv_B": w((cfg.ssm_conv, ns), 0.5),
        "conv_C": w((cfg.ssm_conv, ns), 0.5),
        "A_log": f32(nh, 0.0),
        "D": f32(nh, 1.0),
        "dt_bias": f32(nh, 0.0),
        "gate_norm": f32(di, 0.0),
        "out_proj": w((di, D)),
    }


def _causal_conv(xc, w, conv_state=None):
    """Depthwise causal conv along seq. xc (B, S, C); w (K, C);
    conv_state (B, K-1, C): the trailing inputs of the previous step.
    Returns (silu(conv), new trailing inputs)."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros_like(xc[:, :K - 1])
    else:
        pad = conv_state.to(xc.dtype)
    full = torch.cat([pad, xc], dim=1)                  # (B, S+K-1, C)
    out = sum(full[:, i:i + xc.shape[1]] * w[i][None, None, :]
              for i in range(K))
    return F.silu(out), full[:, -(K - 1):]


def mamba_fwd(
    p,
    x,                      # (B, S, D)
    cfg: ModelConfig,
    cache: Optional[dict] = None,   # {conv_x/conv_B/conv_C: (B, K-1, *),
                                    #  ssm: (B, H, N, P)}, updated in place
    mode: str = "train",
    active=None,            # (B,) bool: serving slots whose state may move
) -> Tuple[torch.Tensor, Optional[dict]]:
    B, S, _ = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    dt_ = x.dtype

    z = x @ p["wz"]
    xi = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])     # (B,S,nh)
    A = -torch.exp(p["A_log"])                                  # (nh,)

    states = {k: (cache[k] if cache else None) for k in CONV_KEYS}
    xi, new_cx = _causal_conv(xi, p["conv_x"], states["conv_x"])
    Bm, new_cb = _causal_conv(Bm, p["conv_B"], states["conv_B"])
    Cm, new_cc = _causal_conv(Cm, p["conv_C"], states["conv_C"])
    Bm = Bm.float()
    Cm = Cm.float()

    xh = split_heads(xi, nh, hp)
    if mode == "decode":
        # Single-step recurrence on the carried state.
        h0 = cache["ssm"].float()                       # (B, nh, ns, hp)
        a = torch.exp(A[None, :] * dt[:, 0])            # (B, nh)
        dx = dt[:, 0, :, None] * xh[:, 0].float()
        upd = Bm[:, 0, None, :, None] * dx[:, :, None, :]
        new_ssm = h0 * a[:, :, None, None] + upd
        if isinstance(new_ssm, DTensor):
            # a sum over n, not an einsum: DTensor's einsum flattens
            # (heads, head dim), which a head dim split alone cannot
            y = (Cm[:, 0, None, :, None] * new_ssm).sum(2)[:, None]
        else:
            y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], new_ssm)[:, None]
    else:
        y, new_ssm = ops.ssd(xh, dt, A, Bm, Cm, impl=cfg.attn_impl)
    y = y.to(dt_) + xh * p["D"].to(dt_)[None, None, :, None]
    y = merge_heads(y)
    # gated RMSNorm (mamba2): norm(y) * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps) * F.silu(z)
    out = y @ p["out_proj"]
    if cache is not None and mode in ("prefill", "decode"):
        new = {"conv_x": new_cx, "conv_B": new_cb, "conv_C": new_cc,
               "ssm": new_ssm}
        for k, v in new.items():
            v = v.to(cache[k].dtype)
            if mode == "decode" and active is not None:
                keep = active.reshape((B,) + (1,) * (v.dim() - 1))
                v = torch.where(keep, v, cache[k])
            cache[k].copy_(v)
    return out, cache
