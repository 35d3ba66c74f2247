"""Latent attention decode over a paged pool of latent rows: the MLA
engine's decode kernel.

``mla_paged_decode`` replaces no Pallas kernel: the JAX package has no
latent attention. It serves the absorbed form of MLA decode
(``models.mla``): each slot's H query heads of width Dk (the latent r
plus the RoPE width) against that slot's cached rows (NB, Bs, Dk),
indirected through its block table, one row a token shared by every
head (MQA); the values are the first Dv (= r) columns of the same rows.
For bfloat16 it launches ``mla_paged_decode_kernel`` of
``csrc/mla_decode.cu``; a CUDA tensor of any other dtype is refused.
``mla_paged_decode_ref`` is its plain PyTorch version. Table entries past
a sequence's allocation may be garbage: they are clamped into the pool
and masked by the window; a slot with an empty window outputs zeros.
"""
from __future__ import annotations

import torch

from . import _build

MAX_HEADS = 16       # query heads a block serves: the mma's M


def mla_paged_decode_ref(q, pool, block_tables, lengths, *, v_dim: int,
                         scale: float):
    """q (B, H, Dk); pool (NB, Bs, Dk); block_tables (B, max_blocks) i32;
    lengths (B,) i32. Float32 math, output (B, H, v_dim) in q's dtype."""
    B = q.shape[0]
    NB, _, Dk = pool.shape
    bt = block_tables.long().clamp(0, NB - 1)
    rows = pool[bt].reshape(B, -1, Dk).float()          # logical order
    s = torch.einsum("bhd,bsd->bhs", q.float(), rows) * scale
    pos = torch.arange(rows.shape[1], device=q.device)
    mask = (pos[None, :] < lengths.to(q.device)[:, None])[:, None, :]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhs,bsd->bhd", p, rows[..., :v_dim]).to(q.dtype)


def mla_paged_decode(q, pool, block_tables, lengths, *, v_dim: int,
                     scale: float):
    """q: (B, H, Dk) bfloat16, H <= 16, Dk = v_dim + 64 with v_dim 512;
    pool: (NB, Bs, Dk); block_tables: (B, max_blocks) i32; lengths: (B,)
    i32 visible window (0: an idle slot, zeros out). Returns (B, H,
    v_dim).

    A CPU tensor goes to ``mla_paged_decode_ref``; a CUDA tensor launches
    the kernel (or raises)."""
    if q.device.type == "cpu":
        return mla_paged_decode_ref(q, pool, block_tables, lengths,
                                    v_dim=v_dim, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_paged_decode: unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"mla_paged_decode: dtype {q.dtype} not supported "
                        "(bfloat16)")
    B, H, Dk = q.shape
    if pool.dim() != 3 or pool.shape[2] != Dk or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"mla_paged_decode: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(pool.shape)} tables "
                         f"{tuple(block_tables.shape)}")
    if (Dk, v_dim) not in _build.LATENT_DIMS or not 1 <= H <= MAX_HEADS:
        raise ValueError(f"mla_paged_decode: widths ({Dk}, {v_dim}) with "
                         f"{H} heads; the kernel takes "
                         f"{_build.LATENT_DIMS} and 1-{MAX_HEADS} heads")
    for t in (q, pool):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("mla_paged_decode: q and pool differ in dtype "
                            "or device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mla_paged_decode: inputs must be contiguous "
                             "and 16-byte aligned")
    _build.check_index("mla_paged_decode", block_tables, block_tables.shape,
                       q.device)
    _build.check_index("mla_paged_decode", lengths, (B,), q.device)
    NB, Bs, _ = pool.shape
    c, _ = _build.latent_decode_plan(B)
    out = torch.empty((B, H, v_dim), dtype=q.dtype, device=q.device)
    err = _build.lib("mla_decode").repro_mla_paged_decode(
        q.data_ptr(), pool.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), B, NB, Bs,
        block_tables.shape[1], H, Dk, v_dim, float(scale), c,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mla_paged_decode")
    mla_paged_decode.launches += 1
    return out


mla_paged_decode.launches = 0    # kernel launches (never the CPU path)
