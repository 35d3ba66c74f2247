"""Causal / non-causal GQA attention: the prompt-prefill kernel.

``flash_attention`` launches ``flash_attention_kernel`` of
``csrc/attention.cu`` (it replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``); ``attention_ref``
is its plain PyTorch version (the counterpart of
``repro.kernels.ref.attention_ref``). Query ``i`` sits at absolute
position ``Skv - Sq + i``; a row with no visible key outputs zeros, as
the kernel does (the JAX oracle's softmax would give NaN there).
"""
from __future__ import annotations

import math

import torch

from . import _build


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain softmax attention with GQA; q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D).
    f32 math, output in q.dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kx = k.float().repeat_interleave(group, dim=2)
    vx = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        return _masked_softmax_av(logits, qpos >= kpos, vx, q.dtype)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def _masked_softmax_av(logits, mask, vx, dtype):
    """softmax(logits | mask) @ v with fully-masked rows giving zeros.
    ``mask`` broadcasts against logits (B,H,Sq,Skv); vx is (B,Skv,H,D)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    A CPU tensor goes to ``attention_ref``; a CUDA tensor launches the
    kernel (or raises)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    code = _build.check_tensors("flash_attention", q, k, v)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    nsplit, bq = _build.launch_plan(Sq, Hq // Hkv, Hkv * B)
    err = _build.lib().repro_flash_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, D, int(causal), scale, nsplit, bq,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches (the CPU path never counts)
