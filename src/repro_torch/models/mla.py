"""Multi-head latent attention (MLA, DeepSeek-V2/V3 and Moonlight) over a
cache of one latent row a token.

For x (B, S, D), H heads of ``qk_nope_head_dim`` + ``qk_rope_head_dim``
(dn + dr) query/key widths and ``v_head_dim`` (dv) value widths, latent
width r = ``kv_lora_rank`` (no query LoRA):

* queries ``q = x W_q`` (D, H (dn + dr)), each head split into ``q_nope``
  (dn) and ``q_pe`` (dr), RoPE on ``q_pe``;
* the latent ``a = x W_kva`` (D, r + dr): ``c = RMSNorm(a[:r])`` with the
  layer's ``kv_norm`` and ``k_pe = RoPE(a[r:])``, one dr-wide key part
  that every head shares. The cache keeps ``[c, k_pe]`` (r + dr wide) a
  token, in one leaf ``kv``;
* prefill runs the expanded form: ``c W_kvb`` (r, H (dn + dv)) gives each
  head's ``k_nope`` (dn) and ``v`` (dv); the keys are ``[k_nope, k_pe]``
  and the scores ``q . k / sqrt(dn + dr)``, causal, through
  ``ops.attention`` (``flash_attention`` with K and V of different
  widths);
* decode runs the absorbed form, the same function: each head's
  ``q_nope`` is taken through ``W_UK`` (the head's dn columns of
  ``W_kvb``, transposed: dn -> r) and joined with its roped ``q_pe``, so
  the scores are one (r + dr)-wide query a head against the cached rows
  (MQA: one key row for all H heads), and the values are the rows' first
  r columns; each head's latent output goes through ``W_UV`` (its dv
  columns of ``W_kvb``: r -> dv). The scale stays ``1 / sqrt(dn + dr)``.
  The paged pool is read by ``ops.latent_attention`` (the
  ``mla_paged_decode`` kernel);
* ``o W_o`` (H dv, D).

RoPE is the port's rotate-half form (``layers.apply_rope``) on the dr
dims; the published code interleaves them, which under random weights
is a fixed permutation of those columns of ``W_q`` and ``W_kva``.

Paths this module does not build raise: chunked prefill and the prefix
cache over latent blocks (a paged prefill with ``block_tables``), and
decode against a contiguous cache. Parameters are plain tensors (no
DTensor rules).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops

from .attention import _as_lens, _paged_write
from .config import ModelConfig
from .layers import apply_rope, dense_init, rmsnorm


def mla_init(cfg: ModelConfig, generator, device, dtype):
    """W_q (D, H (dn + dr)), W_kva (D, r + dr), kv_norm (r,) float32 (the
    port's scale: the multiplier less one), W_kvb (r, H (dn + dv)) and
    W_o (H dv, D), fan-in truncated normals as ``layers.dense_init``."""
    D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init((D, H * (dn + dr)), generator, device).to(dtype),
        "wkv_a": dense_init((D, r + dr), generator, device).to(dtype),
        "kv_norm": torch.zeros(r, dtype=torch.float32, device=device),
        "wkv_b": dense_init((r, H * (dn + dv)), generator, device).to(dtype),
        "wo": dense_init((H * dv, D), generator, device).to(dtype),
    }


def latent_rows(p, x, positions, cfg: ModelConfig):
    """The cached rows ``[c, RoPE(k_pe)]`` (B, S, r + dr) of x, in x's
    dtype."""
    r = cfg.kv_lora_rank
    a = x @ p["wkv_a"]
    c = rmsnorm(a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(a[..., None, r:], positions, cfg.rope_theta)
    return torch.cat([c, k_pe[:, :, 0]], dim=-1)


def _queries(p, x, positions, cfg: ModelConfig):
    """(q_nope (B, S, H, dn), RoPE(q_pe) (B, S, H, dr))."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_head_dim
    q = (x @ p["wq"]).view(B, S, cfg.n_heads, -1)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _kvb_heads(p, cfg: ModelConfig):
    """W_kvb as (r, H, dn + dv): head h's k_nope and v columns."""
    return p["wkv_b"].view(cfg.kv_lora_rank, cfg.n_heads, -1)


def expanded_attention(p, q_nope, q_pe, lat, cfg: ModelConfig):
    """Causal attention of the queries over the rows ``lat`` (B, S, r +
    dr) in the expanded form: per-head keys ``[c W_UK, k_pe]`` and values
    ``c W_UV``. Returns (B, S, H, dv)."""
    B, S, H, _ = q_nope.shape
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    kv = (lat[..., :r] @ p["wkv_b"]).view(B, S, H, -1)
    k_pe = lat[:, :, None, r:].expand(B, S, H, cfg.qk_rope_head_dim)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    return ops.attention(q, k, kv[..., dn:].contiguous(), causal=True,
                         scale=softmax_scale(cfg), impl=cfg.attn_impl)


def absorb_queries(p, q_nope, q_pe, cfg: ModelConfig):
    """The decode queries (B, H, r + dr): ``q_nope`` of each head through
    its W_UK^T (dn -> r), then its roped ``q_pe``."""
    dn = cfg.qk_nope_head_dim
    w_uk = _kvb_heads(p, cfg)[..., :dn].permute(1, 2, 0)     # (H, dn, r)
    q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1), w_uk)  # (H, B, r)
    return torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)


def expand_values(p, o_lat, cfg: ModelConfig):
    """Each head's latent output (B, H, r) through its W_UV (r -> dv):
    (B, H, dv)."""
    w_uv = _kvb_heads(p, cfg)[..., cfg.qk_nope_head_dim:].transpose(0, 1)
    return torch.matmul(o_lat.transpose(0, 1), w_uv).transpose(0, 1)


def softmax_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_fwd(p, x, positions, cfg: ModelConfig,
            cache: Optional[torch.Tensor] = None, cache_len=None,
            mode: str = "train", block_tables=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), cache). ``cache`` is one layer's
    latent leaf: a contiguous (B, S_max, r + dr) row (prefill writes the
    prompt's rows at ``cache_len``) or, with ``block_tables``, a paged
    pool (NB + 1, Bs, r + dr) that decode writes one row a slot into and
    reads (``cache_len`` (B,) i32, -1 marking an idle slot). Updated in
    place."""
    B, S, _ = x.shape
    if isinstance(x, DTensor):
        raise NotImplementedError("MLA on DTensors: the latent attention "
                                  "has no sharding rules")
    q_nope, q_pe = _queries(p, x, positions, cfg)
    lat = latent_rows(p, x, positions, cfg)
    if mode == "decode":
        if block_tables is None:
            raise NotImplementedError(
                "MLA decode reads the paged latent pool: the contiguous "
                "engine's cache is not built for latent rows")
        assert cache is not None and S == 1
        lens = _as_lens(cache_len, B, x.device)
        Bs = cache.shape[1]
        pos = lens.clamp(min=0).long()
        phys = block_tables.gather(1, (pos // Bs)[:, None])[:, 0]
        _paged_write(cache, torch.where(lens >= 0, phys, -1), pos % Bs,
                     lat[:, 0])
        window = torch.where(lens >= 0, lens + 1, 0).to(torch.int32)
        NB = cache.shape[0] - 1
        o_lat = ops.latent_attention(
            absorb_queries(p, q_nope, q_pe, cfg), cache[:NB], block_tables,
            window, v_dim=cfg.kv_lora_rank, scale=softmax_scale(cfg),
            impl=cfg.decode_impl)
        o = expand_values(p, o_lat, cfg)[:, None]
    else:
        if block_tables is not None:
            raise NotImplementedError(
                "chunked prefill and the prefix cache over latent blocks "
                "(paged_prefill at qk 192 / v 128) are not built for MLA")
        o = expanded_attention(p, q_nope, q_pe, lat, cfg)
        if mode == "prefill" and cache is not None:
            off = int(cache_len) if cache_len is not None else 0
            cache[:, off:off + S] = lat.to(cache.dtype)
    return o.reshape(B, S, -1) @ p["wo"], cache
