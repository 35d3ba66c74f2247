"""Step builders: train_step / prefill_step / decode_step factories, and
the training state. The counterpart of ``repro.train.trainer``; PyTorch
runs eagerly, so a builder returns a plain function (JAX's are jitted by
the launcher)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import replicated
from repro_torch.models import decode_step as _decode
from repro_torch.models import init_lm, prefill as _prefill, train_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import argmax_vocab

from .optimizer import (OptConfig, adamw_init, adamw_update, tree_leaves,
                        tree_map)


def loss_and_grads(params, cfg: ModelConfig, batch):
    """``train_loss`` and the gradient of every leaf of ``params`` (a
    tree of the same shape, float32 for float32 masters). A leaf the loss
    does not reach (the vlm family's token embedding) gets zeros, as
    ``jax.grad`` gives it. DTensor leaves get gradients with their own
    placements. Returns (loss, metrics, grads), detached."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = train_loss(params, cfg, batch)
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad(p):
        g = next(got)
        if g is None:
            return torch.zeros_like(p)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        return g

    grads = tree_map(grad, params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _split(batch, microbatches: int, i: int):
    """Microbatch i: rows [i B / m, (i + 1) B / m) of every leaf, as JAX
    slices them. A DTensor leaf is gathered, sliced, and laid out again
    with its own placements."""
    def one(v):
        mb = replicated(v).reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
        if isinstance(v, DTensor):
            mb = mb.redistribute(v.device_mesh, v.placements)
        return mb
    return {k: one(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, oc: OptConfig, microbatches: int = 1):
    """Training step with optional gradient accumulation: an unrolled loop
    over ``microbatches`` slices of the batch, the float32 gradients
    summed and divided by their number, ``expert_counts`` summed and the
    other metrics averaged (JAX's order of operations). The step updates
    the parameters and optimizer state in place (``adamw_update``) and
    returns (params, opt, metrics)."""

    def train_step(params, opt, batch):
        if microbatches == 1:
            _, metrics, grads = loss_and_grads(params, cfg, batch)
        else:
            grads = metrics = None
            for i in range(microbatches):
                _, m, g = loss_and_grads(params, cfg,
                                         _split(batch, microbatches, i))
                g = tree_map(lambda a: a.float(), g)
                if grads is None:
                    grads, metrics = g, m
                else:
                    more = iter(tree_leaves(g))
                    grads = tree_map(lambda a: a + next(more), grads)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda a: a / microbatches, grads)
            metrics = {k: (v if k == "expert_counts" else v / microbatches)
                       for k, v in metrics.items()}
        params, opt, om = adamw_update(params, grads, opt, oc)
        return params, opt, dict(metrics, **om)

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        logits, cache = _prefill(params, cfg, batch, max_seq=max_seq)
        # the last position's greedy token (sampling lives in the engine)
        next_tok = argmax_vocab(logits[:, -1:], cfg.vocab)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_one(params, tokens, cache, cache_len):
        logits, cache = _decode(params, cfg, tokens, cache, cache_len)
        next_tok = argmax_vocab(logits, cfg.vocab)
        return next_tok, cache

    return decode_one


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """Float32 master parameters (``init_lm``'s distributions) and a fresh
    AdamW state. ``generator`` must live on ``device``."""
    params = init_lm(cfg, generator, device, dtype=torch.float32)
    return params, adamw_init(params)
