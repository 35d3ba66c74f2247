"""Task-level entry points: prefill, decode, sampling."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .config import ModelConfig
from .transformer import forward, make_cache


def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], max_seq: int):
    """Fill a fresh cache of size max_seq from ``batch["tokens"]`` (B, S)
    (or (B, S, K) for audio) or, for vlm, ``batch["embeds"]`` (B, S, D),
    with ``batch["positions"]`` when given ((B, S, 3) under M-RoPE).
    Returns (logits, cache)."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    src = tokens if tokens is not None else embeds
    cache = make_cache(cfg, src.shape[0], max_seq, device=src.device)
    logits, cache, _ = forward(params, cfg, tokens, embeds=embeds,
                               positions=batch.get("positions"),
                               cache=cache, cache_len=0, mode="prefill")
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens, cache, cache_len,
                block_tables=None):
    """One token per sequence: tokens (B, 1), or (B, 1, K) for audio.
    Returns (logits, cache); with ``block_tables`` the cache is the paged
    pool (make_paged_cache). The cache is updated in place."""
    logits, cache, _ = forward(params, cfg, tokens, cache=cache,
                               cache_len=cache_len, mode="decode",
                               block_tables=block_tables)
    return logits, cache


def sample_tokens(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0):
    """On-device sampling over vocab-sliced logits (..., V): greedy argmax
    (first maximum, as jnp.argmax) at temperature 0, else a categorical
    draw at logits / T (Gumbel-max with ``generator``'s uniforms).
    Returns int32 ids shaped like logits[..., 0]."""
    lg = logits.float()
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(lg / temperature + gumbel, dim=-1).to(torch.int32)
