"""Attention against a block-table-indirected KV pool: the paged engine's
decode kernel (Sq == 1) and chunked-prefill kernel (Sq rows at
``q_offset``).

``paged_decode`` / ``paged_prefill`` launch ``paged_decode_kernel`` /
``paged_prefill_kernel`` of ``csrc/attention.cu`` (they replace the Pallas
kernels ``repro/kernels/paged_decode.py:paged_decode`` and
``:paged_prefill``); ``paged_decode_ref`` / ``paged_prefill_ref`` are their
plain PyTorch versions (counterparts of ``repro.kernels.ref``'s oracles).
Table entries past a sequence's allocation may be garbage: they are
clamped into the pool and masked by the window.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import _masked_softmax_av
from .flash_decode import decode_ref


def _gather(pool, block_tables, B):
    NB, _, Hkv, hd = pool.shape
    bt = block_tables.long().clamp(0, NB - 1)
    return pool[bt].reshape(B, -1, Hkv, hd)     # logical order


def paged_decode_ref(q, k_pool, v_pool, block_tables, lengths,
                     scale: float | None = None):
    """q (B,1,Hq,hd); pools (num_blocks, Bs, Hkv, hd); block_tables
    (B, max_blocks) i32; lengths (B,) i32. Gathers each sequence's blocks
    into logical order, then ``decode_ref``."""
    B = q.shape[0]
    return decode_ref(q, _gather(k_pool, block_tables, B),
                      _gather(v_pool, block_tables, B), lengths, scale=scale)


def paged_prefill_ref(q, k_pool, v_pool, block_tables, lengths, q_offset,
                      scale: float | None = None):
    """q (B,Sq,Hq,hd) holds tokens [q_offset, q_offset + Sq); query i sees
    key positions <= q_offset + i and < lengths. Fully-masked rows (padded
    tail queries) output zeros."""
    B, Sq, Hq, hd = q.shape
    Hkv = k_pool.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    k = _gather(k_pool, block_tables, B)
    v = _gather(v_pool, block_tables, B)
    S = k.shape[1]
    dev = q.device
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev).expand(B)
    offs = torch.as_tensor(q_offset, dtype=torch.int32, device=dev).expand(B)
    kx = k.float().repeat_interleave(group, dim=2)
    vx = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    qpos = offs[:, None] + torch.arange(Sq, device=dev)[None, :]   # (B,Sq)
    kpos = torch.arange(S, device=dev)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
        kpos[None, None, :] < lens[:, None, None])                 # (B,Sq,S)
    return _masked_softmax_av(logits, mask[:, None], vx, q.dtype)


def _check_paged(name, q, k_pool, v_pool, block_tables, lengths):
    B, _, Hq, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != D or Hq % k_pool.shape[2] \
            or block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} pool "
                         f"{tuple(k_pool.shape)} tables "
                         f"{tuple(block_tables.shape)}")
    code = _build.check_tensors(name, q, k_pool, v_pool)
    _build.check_index(name, block_tables, block_tables.shape, q.device)
    _build.check_index(name, lengths, (B,), q.device)
    return code


def paged_decode(q, k_pool, v_pool, block_tables, lengths, *,
                 scale: float | None = None):
    """q: (B, 1, Hq, D); pools: (num_blocks, Bs, Hkv, D); block_tables:
    (B, max_blocks) i32; lengths: (B,) i32 visible window (0 => idle slot,
    output zeros). Returns (B, 1, Hq, D).

    A CPU tensor goes to ``paged_decode_ref``; a CUDA tensor launches the
    kernel (or raises)."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, block_tables, lengths,
                                scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode is Sq == 1 only, got {q.shape[1]}")
    code = _check_paged("paged_decode", q, k_pool, v_pool, block_tables,
                        lengths)
    B, _, Hq, D = q.shape
    NB, Bs, Hkv, _ = k_pool.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    nsplit, _ = _build.launch_plan(1, Hq // Hkv, Hkv * B)
    err = _build.lib().repro_paged_decode(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        out.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(), B, NB,
        Bs, block_tables.shape[1], Hq, Hkv, D, scale, nsplit,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode")
    paged_decode.launches += 1
    return out


def paged_prefill(q, k_pool, v_pool, block_tables, lengths, q_offset, *,
                  scale: float | None = None):
    """q: (B, Sq, Hq, D) chunk whose rows sit at absolute positions
    ``q_offset + i`` ((B,) i32); pools and tables as in ``paged_decode``;
    lengths (B,) i32 is the visible window ``q_offset + true chunk
    length``. Returns (B, Sq, Hq, D).

    A CPU tensor goes to ``paged_prefill_ref``; a CUDA tensor launches the
    kernel (or raises)."""
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_pool, v_pool, block_tables, lengths,
                                 q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: unsupported device {q.device}")
    code = _check_paged("paged_prefill", q, k_pool, v_pool, block_tables,
                        lengths)
    B, Sq, Hq, D = q.shape
    _build.check_index("paged_prefill", q_offset, (B,), q.device)
    NB, Bs, Hkv, _ = k_pool.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    nsplit, bq = _build.launch_plan(Sq, Hq // Hkv, Hkv * B)
    err = _build.lib().repro_paged_prefill(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        out.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        q_offset.data_ptr(), B, Sq, NB, Bs, block_tables.shape[1], Hq, Hkv,
        D, scale, nsplit, bq,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_prefill")
    paged_prefill.launches += 1
    return out


paged_decode.launches = 0    # kernel launches (the CPU path never counts)
paged_prefill.launches = 0
