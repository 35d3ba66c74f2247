"""Task-level entry points: training loss, prefill, decode, sampling."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import local_call, reduced, shard_act
from ..kernels import ops
from .config import ModelConfig
from .transformer import forward, make_cache

AUX_LOSS_WEIGHT = 0.01


def _xent(logits, targets, vocab: int):
    """Cross-entropy per position on the unpadded vocab slice, float32
    math; logits (..., Vp), targets (...) int. DTensor logits take
    ``_xent_sharded``."""
    if isinstance(logits, DTensor):
        return _xent_sharded(logits, targets, vocab)
    lg = logits[..., :vocab].float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets[..., None].long())[..., 0]
    return lse - gold


def _xent_sharded(logits, targets, vocab: int):
    """``_xent`` on logits split over the vocab (the head's ``vocab``
    axis over ``model``): each rank reads only its columns, padded ones
    masked out. The logits are first constrained to ``("batch", "seq",
    ..., "vocab")``. The maximum, the sum of exponentials and the gold
    logit are each one all-reduce of a (..., ) float32 tensor over the
    vocab's mesh dims (the maximum is a shift only, and carries no
    gradient)."""
    logits = shard_act(logits, "batch", "seq",
                       *("none",) * (logits.dim() - 3), "vocab")
    v = _VocabSplit(logits, vocab)
    targets = targets.redistribute(v.mesh, v.row)
    m = v.reduce(lambda lg: v.masked(lg)[0].amax(-1), "max",
                 logits.detach())

    def terms(lg, t, m):
        lg, c = v.masked(lg)
        e = torch.exp(lg - m.unsqueeze(-1))       # exp(-inf) = 0: padded
        hit = c == t.long().unsqueeze(-1)
        return e.sum(-1), torch.where(hit, lg, 0.0).sum(-1)

    s, gold = v.reduce(terms, "sum", logits, targets, m, outputs=2)
    return m + torch.log(s) - gold


class _VocabSplit:
    """Logits (..., Vp) split over the vocab on some mesh dims: ``row``,
    the placements of a (...,) statistic (the vocab's mesh dims
    replicated), and ``reduce``, a statistic of each rank's columns
    combined over those dims."""

    def __init__(self, logits, vocab: int):
        d = logits.dim() - 1
        self.mesh, self.vocab = logits.device_mesh, vocab
        self.vdims = [md for md, p in enumerate(logits.placements)
                      if isinstance(p, Shard) and p.dim == d]
        self.row = [Replicate() if md in self.vdims else p
                    for md, p in enumerate(logits.placements)]
        self.off = ops.shard_offset(logits, d)

    def masked(self, lg):
        """A rank's columns in float32, the padded ones -inf, and their
        global indices."""
        cols = self.off + torch.arange(lg.shape[-1], device=lg.device)
        return (lg.float().masked_fill(cols >= self.vocab, float("-inf")),
                cols)

    def reduce(self, fn, kind: str, *args, outputs: int = 1):
        """``fn`` of the local columns (``outputs`` tensors), each an
        all-reduce (``kind``) over the vocab's mesh dims."""
        part = tuple(Partial(kind) if md in self.vdims else p
                     for md, p in enumerate(self.row))
        out = local_call(fn, part if outputs == 1 else (part,) * outputs,
                         *args)
        outs = (out,) if outputs == 1 else out
        outs = tuple(o.redistribute(self.mesh, self.row) for o in outs)
        return outs[0] if outputs == 1 else outs


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
    # on DTensors laid out on the batch's mesh, as JAX's prefill cell's
    # out_shardings
    cache = make_cache(cfg, src.shape[0], max_seq, device=src.device,
                       mesh=src.device_mesh if isinstance(src, DTensor)
                       else None)
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


def argmax_vocab(logits, vocab: int):
    """The greedy token over the unpadded vocab slice of logits (...,
    Vp): ``torch.argmax``'s first maximum, int64. Logits that are a
    DTensor split over the vocab are reduced by two all-reduces of a
    (...,) tensor, the maximum and then the least column holding it,
    instead of a gather of the logits."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits[..., :vocab], dim=-1)
    logits = reduced(logits)
    v = _VocabSplit(logits, vocab)
    m = v.reduce(lambda lg: v.masked(lg)[0].amax(-1), "max", logits)

    def first(lg, m):
        lg, cols = v.masked(lg)
        hit = lg == m.unsqueeze(-1)
        return torch.where(hit, cols, torch.iinfo(torch.int64).max).amin(-1)

    return v.reduce(first, "min", logits, m)


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
