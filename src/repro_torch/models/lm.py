"""Task-level entry points: training loss, prefill, decode, sampling."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .config import ModelConfig
from .transformer import forward, make_cache

AUX_LOSS_WEIGHT = 0.01


def _xent(logits, targets, vocab: int):
    """Cross-entropy per position on the unpadded vocab slice, float32
    math; logits (..., Vp), targets (...) int."""
    lg = logits[..., :vocab].float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets[..., None].long())[..., 0]
    return lse - gold


def train_loss(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Next-token loss of ``batch``: {"tokens": (B, S)}, (B, S, K) for
    audio (the mean over codebooks), or for vlm {"embeds", "positions",
    "labels"}. Returns (loss, metrics) with the JAX package's metric names:
    ``ce_loss`` and ``loss``, and for moe ``aux_loss`` (per layer; the
    loss adds ``AUX_LOSS_WEIGHT`` of it), ``expert_counts`` and
    ``dropped_frac``."""
    if cfg.family == "vlm":
        logits, _, aux = forward(params, cfg, embeds=batch["embeds"],
                                 positions=batch.get("positions"),
                                 mode="train")
        per_tok = _xent(logits[:, :-1], batch["labels"][:, 1:], cfg.vocab)
    else:
        tokens = batch["tokens"]
        logits, _, aux = forward(params, cfg, tokens, mode="train")
        per_tok = _xent(logits[:, :-1], tokens[:, 1:], cfg.vocab)
        if cfg.n_codebooks:
            per_tok = per_tok.mean(-1)
    loss = per_tok.mean()
    metrics = {"ce_loss": loss}
    if cfg.family == "moe":
        aux_l = aux["aux_loss"] / cfg.n_layers
        loss = loss + AUX_LOSS_WEIGHT * aux_l
        metrics["aux_loss"] = aux_l
        metrics["expert_counts"] = aux["expert_counts"]
        metrics["dropped_frac"] = aux["dropped"] / (
            float(per_tok.numel()) * cfg.top_k * cfg.n_layers)
    metrics["loss"] = loss
    return loss, metrics


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
