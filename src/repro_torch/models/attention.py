"""GQA attention with RoPE, optional QKV bias, and prefill/decode caches.

The four branches of ``repro.models.attention.attn_fwd``: train / prompt
prefill (the flash_attention kernel), contiguous decode (flash_decode),
paged decode (paged_decode) and chunked prefill against the paged pool
(paged_prefill), all through ``kernels.ops.attention``.

Caches are updated IN PLACE (the JAX version returns new arrays): each
cache leaf passed in is a per-layer view of the engine's cache tensors,
and the returned ``new_cache`` holds the same tensors. The caches hold
``cfg.dtype`` values: every value written is already in the compute dtype,
so this gives the numbers of the JAX engine (which stores float32 and
casts the whole cache back to the compute dtype on every call) without
the per-call copy.

Dropped writes. JAX drops out-of-bounds scatter indices (``mode="drop"``,
used for idle slots and table entries past an allocation); PyTorch's
indexed writes do not. Here every such write is masked explicitly:
contiguous decode writes an idle slot's old value back to its own row,
and paged writes go to the pool's sink block (index ``num_blocks``, see
``transformer.make_paged_cache``), which no table points at and no kernel
reads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import apply_rope, dense_init


def attn_init(cfg: ModelConfig, generator, device, dtype):
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init((D, Hq * hd), generator, device).to(dtype),
        "wk": dense_init((D, Hkv * hd), generator, device).to(dtype),
        "wv": dense_init((D, Hkv * hd), generator, device).to(dtype),
        "wo": dense_init((Hq * hd, D), generator, device).to(dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros(n * hd, dtype=dtype, device=device)
    return p


def _as_lens(cache_len, B, device):
    """(B,) int32 on the device; an int is filled there (no host copy)."""
    if isinstance(cache_len, int):
        return torch.full((B,), cache_len, dtype=torch.int32, device=device)
    return cache_len.to(torch.int32).expand(B)


def _paged_write(pool, phys, off, new):
    """pool[phys, off] = new, with phys outside [0, NB) sent to the sink
    block NB (pool has NB + 1 blocks); in place."""
    NB = pool.shape[0] - 1
    phys = torch.where((phys >= 0) & (phys < NB), phys, NB).long()
    pool[phys, off.long()] = new.to(pool.dtype)


def attn_fwd(
    p,
    x,                        # (B, S, D)
    positions,                # (B, S)
    cfg: ModelConfig,
    cache: Optional[dict] = None,   # {"k","v"}: (B, S_max, Hkv, hd), or
                                    # paged pools (NB + 1, Bs, Hkv, hd)
    cache_len=None,           # int or (B,) i32: valid entries in cache
    mode: str = "train",      # train | prefill | decode
    block_tables=None,        # (B, max_blocks) i32 for paged pools
) -> Tuple[torch.Tensor, Optional[dict]]:
    if cfg.mrope:
        raise NotImplementedError("M-RoPE (vlm family) is not ported yet")
    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q.view(B, S, Hq, hd), positions, cfg.rope_theta)
    k = apply_rope(k.view(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.view(B, S, Hkv, hd)

    if mode == "decode":
        assert cache is not None and S == 1
        # cache_len: scalar or (B,) per-slot lengths, -1 marking idle
        # serving slots (writes dropped, state untouched).
        lens = _as_lens(cache_len, B, x.device)
        window = torch.where(lens >= 0, lens + 1, 0).to(torch.int32)
        ck, cv = cache["k"], cache["v"]
        if block_tables is not None:
            # Token at logical position lens[b] lands in physical block
            # block_tables[b, lens[b] // Bs] at offset lens[b] % Bs.
            Bs = ck.shape[1]
            bt = block_tables
            pos = lens.clamp(min=0).long()
            phys = bt.gather(1, (pos // Bs)[:, None])[:, 0]
            phys = torch.where(lens >= 0, phys, -1)      # idle => sink
            _paged_write(ck, phys, pos % Bs, k[:, 0])
            _paged_write(cv, phys, pos % Bs, v[:, 0])
            NB = ck.shape[0] - 1
            o = ops.attention(q, ck[:NB], cv[:NB], causal=False,
                              impl=cfg.decode_impl, lengths=window,
                              block_tables=bt)
        else:
            S_max = ck.shape[1]
            live = (lens >= 0) & (lens < S_max)
            widx = torch.where(live, lens, 0).long()
            brow = torch.arange(B, device=x.device)
            keep = live[:, None, None]
            # Idle slots write their own row's old value back: a no-op.
            ck[brow, widx] = torch.where(keep, k[:, 0].to(ck.dtype),
                                         ck[brow, widx])
            cv[brow, widx] = torch.where(keep, v[:, 0].to(cv.dtype),
                                         cv[brow, widx])
            o = ops.attention(q, ck, cv, causal=False, impl=cfg.decode_impl,
                              lengths=window)
        new_cache = cache
    elif mode == "prefill" and block_tables is not None:
        # Chunked prefill: this call holds tokens [start, start + S); KV
        # for [0, start) already sits in pool blocks. Write the chunk's
        # k/v through the table, then attend over the whole window.
        assert cache is not None
        ck, cv = cache["k"], cache["v"]
        Bs = ck.shape[1]
        bt = block_tables
        start = _as_lens(cache_len, B, x.device)
        pos = (start[:, None] + torch.arange(S, device=x.device)[None, :])
        pos = pos.long()                                          # (B, S)
        phys = bt.gather(1, pos // Bs)
        _paged_write(ck, phys, pos % Bs, k)
        _paged_write(cv, phys, pos % Bs, v)
        NB = ck.shape[0] - 1
        o = ops.attention(q, ck[:NB], cv[:NB], causal=True,
                          impl=cfg.decode_impl,
                          lengths=(start + S).to(torch.int32),
                          block_tables=bt, q_offset=start.contiguous())
        new_cache = cache
    else:
        o = ops.attention(q, k, v, causal=True, impl=cfg.attn_impl)
        new_cache = None
        if mode == "prefill" and cache is not None:
            # Write the prompt's k/v into the (larger) cache at cache_len
            # (chunk 0 in practice); in place.
            off = int(cache_len) if cache_len is not None else 0
            cache["k"][:, off:off + S] = k.to(cache["k"].dtype)
            cache["v"][:, off:off + S] = v.to(cache["v"].dtype)
            new_cache = cache
    y = o.reshape(B, S, Hq * hd) @ p["wo"]
    return y, new_cache
