"""Causal / non-causal GQA attention: the prompt-prefill kernel.

``flash_attention`` replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention`` with one kernel per
dtype, chosen from ``q.dtype``: bfloat16 launches the tensor-core
``flash_attention_tc_kernel`` of ``csrc/attention_tc.cu``; float32 launches
the CUDA-core ``flash_attention_kernel`` of ``csrc/attention.cu`` (TF32
tensor cores would not hold float32's parity). ``attention_ref`` is its
plain PyTorch version (the counterpart of
``repro.kernels.ref.attention_ref``). Query ``i`` sits at absolute
position ``Skv - Sq + i``; a row with no visible key outputs zeros, as
the kernel does (the JAX oracle's softmax would give NaN there). V may
be narrower than Q and K (MLA's expanded prefill: qk 192, v 128, bf16
only, ``_build.SPLIT_DIMS``); the output then has V's width.

``attention_chunked`` is ``repro.kernels.ref.attention_chunked``, the
reference's memory-bounded plain path (``attn_impl="chunked"``): not a
Pallas kernel, so plain PyTorch on every device, as there.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import _build
from .autograd import KernelFunction, needs_grad


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Plain softmax attention with GQA; q (B,Sq,Hq,D), k (B,Skv,Hkv,D),
    v (B,Skv,Hkv,Dv). f32 math, output (B,Sq,Hq,Dv) in q.dtype."""
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


def attention_chunked(q, k, v, causal: bool = True,
                      scale: float | None = None, block_q: int = 512):
    """Memory-bounded attention: q in blocks of ``min(block_q, Sq)`` rows,
    each against the whole kv, so the scores live as (B, Hkv, group, bq,
    Skv) float32 for one block at a time rather than for all Sq rows.
    GQA contracts against the raw (B, Skv, Hkv, D) kv (no repeated kv).
    Each block runs under ``torch.utils.checkpoint`` (non-reentrant), as
    JAX's ``jax.checkpoint``: the backward recomputes the block's
    probabilities instead of saving them. Causal masking puts query ``i``
    at ``Skv - Sq + i`` and fills with ``-1e30``, as the reference does
    (so a row with no visible key is a uniform average, not zeros)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bq = min(block_q, Sq)
    if Sq % bq:
        raise ValueError(f"attention_chunked: {Sq} query rows do not split "
                         f"into blocks of {bq}")
    kpos = torch.arange(Skv, device=q.device)[None, :]

    def one_block(qb, k, v, i):
        qg = qb.reshape(B, bq, Hkv, group, D).float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
        if causal:
            qpos = (i * bq + torch.arange(bq, device=q.device))[:, None] \
                + (Skv - Sq)
            logits = torch.where(qpos >= kpos, logits,
                                 torch.full((), -1e30, device=q.device))
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
        return o.reshape(B, bq, Hq, D).to(q.dtype)

    blocks = [checkpoint(one_block, q[:, i * bq:(i + 1) * bq], k, v, i,
                         use_reentrant=False)
              for i in range(Sq // bq)]
    return torch.cat(blocks, dim=1)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv), Dv = D
    or (D, Dv) in ``_build.SPLIT_DIMS`` -> (B, Sq, Hq, Dv).

    A CPU tensor goes to ``attention_ref``; a CUDA tensor launches the
    kernel of its dtype (or raises). Where autograd needs the gradient,
    the launch runs inside ``KernelFunction``, whose backward is that of
    ``attention_ref``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if needs_grad(q, k, v):
        return KernelFunction.apply(_launch, attention_ref, q, k, v, causal,
                                    scale)
    return _launch(q, k, v, causal, scale)


def _launch(q, k, v, causal, scale):
    """One counted launch of the kernel of q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    Dv = v.shape[-1]
    if k.dim() != 4 or k.shape[:3] != v.shape[:3] or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2] \
            or (Dv != D and (D, Dv) not in _build.SPLIT_DIMS):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    code = _build.check_tensors("flash_attention", q, k, v)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = q.new_empty((B, Sq, Hq, Dv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = _build.lib("attention_tc").repro_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, Hq, Hkv, D, Dv, int(causal), scale, stream)
    else:
        nsplit, bq = _build.launch_plan(Sq, Hq // Hkv, Hkv * B)
        err = _build.lib("attention").repro_flash_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, Hq, Hkv, D, int(causal), scale, nsplit, bq, stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # launches of either route (never the CPU path)
