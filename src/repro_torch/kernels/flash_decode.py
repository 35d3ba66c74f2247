"""Sq == 1 attention against a contiguous padded KV cache with per-slot
visible lengths: the contiguous engine's decode kernel.

``flash_decode`` replaces the Pallas kernel ``repro/kernels/flash_decode.py:
flash_decode`` with one kernel per dtype, chosen from ``q.dtype``:
bfloat16 launches the tensor-core, split-KV ``flash_decode_tc_kernel`` of
``csrc/decode_tc.cu``; float32 launches the CUDA-core
``flash_decode_kernel`` of ``csrc/attention.cu`` (TF32 tensor cores would
not hold float32's parity). ``decode_ref`` is its plain PyTorch version
(the counterpart of ``repro.kernels.ref.decode_ref``). A slot with length 0
(idle) outputs zeros, as the kernels do; the JAX oracle returns uniform
attention there, which callers discard either way.
"""
from __future__ import annotations

import math

import torch

from . import _build


def decode_ref(q, k, v, lengths, scale: float | None = None):
    """q (B,1,Hq,hd); k, v (B,S,Hkv,hd); lengths (B,) i32: row b attends
    to k[b, :lengths[b]]. f32 softmax, output in q.dtype."""
    B, S, Hkv, hd = k.shape
    Hq = q.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lens = torch.as_tensor(lengths, dtype=torch.int32,
                           device=q.device).expand(B)
    qf = q.float().reshape(B, Hkv, group, hd)
    s = torch.einsum("bgqd,bsgd->bgqs", qf, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    mask = mask[:, None, None, :]                        # (B,1,1,S)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bgqs,bsgd->bgqd", p, v.float())
    return o.reshape(B, 1, Hq, hd).to(q.dtype)


def flash_decode(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) i32 visible
    window per slot (0 => idle slot, output zeros). Returns (B, 1, Hq, D).

    A CPU tensor goes to ``decode_ref``; a CUDA tensor launches the kernel
    of its dtype (or raises). ``lengths`` stays on the device: the grid is
    sized from the shapes, never from the lengths' values."""
    if q.device.type == "cpu":
        return decode_ref(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    if Sq != 1 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"flash_decode: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    code = _build.check_tensors("flash_decode", q, k, v)
    _build.check_index("flash_decode", lengths, (B,), q.device)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        cluster, _ = _build.decode_plan(B, Hkv, Hq // Hkv)
        err = _build.lib("decode_tc").repro_flash_decode_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), B, S, Hq, Hkv, D, scale, cluster, stream)
    else:
        nsplit, _ = _build.launch_plan(1, Hq // Hkv, Hkv * B)
        err = _build.lib("attention").repro_flash_decode(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), B, S, Hq, Hkv, D, scale, nsplit, stream)
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0   # launches of either route (never the CPU path)
