"""Decoder-only LM assembly, dense family:
[rmsnorm -> GQA attn -> rmsnorm -> SwiGLU] x L.

Parameters are a dict: ``embed`` (Vp, D), ``head`` (D, Vp) unless tied,
``final_ln`` (D,), and ``blocks``, a list with one dict per layer (the JAX
version stacks them on a leading L axis for ``lax.scan``; here a Python
loop walks the list). Matrices are stored in the compute dtype
``cfg.dtype``, norm scales in float32 (the JAX version stores float32
masters and casts to the compute dtype on every use, which rounds to the
same values).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .attention import attn_fwd, attn_init
from .config import ModelConfig
from .layers import embed_init, mlp_fwd, mlp_init, resolve_device, rmsnorm


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_codebooks or cfg.mrope:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


# ------------------------------------------------------------------ init
def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device=None) -> Dict[str, Any]:
    """Random weights with the distributions of ``repro.models.init_lm``
    (not its random numbers). ``generator`` must live on ``device``."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = compute_dtype(cfg)
    Vp, D = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init((Vp, D), generator, device).to(dt)}
    if not cfg.tie_embeddings:
        params["head"] = embed_init((D, Vp), generator, device).to(dt)
    zeros = lambda: torch.zeros(D, dtype=torch.float32, device=device)
    params["blocks"] = [
        {"ln1": zeros(),
         "attn": attn_init(cfg, generator, device, dt),
         "ln2": zeros(),
         "mlp": mlp_init(D, cfg.d_ff, generator, device, dt)}
        for _ in range(cfg.n_layers)
    ]
    params["final_ln"] = zeros()
    return params


# ----------------------------------------------------------------- cache
def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """Contiguous per-slot caches (L, batch, max_seq, Hkv, hd)."""
    _check_family(cfg)
    device = resolve_device(device)
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or compute_dtype(cfg)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Paged serving cache: per-layer pools of ``num_blocks`` blocks of
    ``block_size`` tokens, indirected through per-sequence block tables.
    Each pool holds ONE extra block, index ``num_blocks``: the sink that
    dropped writes (idle slots, table entries past an allocation) go to,
    where JAX drops them. No table points at it and no kernel reads it.
    ``slots`` is unused by the dense family (no per-slot recurrent
    state); it is kept so the signature matches the JAX version's."""
    _check_family(cfg)
    device = resolve_device(device)
    kv = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or compute_dtype(cfg)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


# -------------------------------------------------------------- forward
def run_layers(params, cfg: ModelConfig, x, positions, cache, cache_len,
               mode, block_tables=None):
    """Apply every block; caches are per-layer views updated in place."""
    for li, bp in enumerate(params["blocks"]):
        acache = ({"k": cache["k"][li], "v": cache["v"][li]}
                  if cache else None)
        h, _ = attn_fwd(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                        positions, cfg, cache=acache, cache_len=cache_len,
                        mode=mode, block_tables=block_tables)
        x = x + h
        x = x + mlp_fwd(bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps))
    return x, cache


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens]


def lm_logits(params, cfg: ModelConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head


def forward(params, cfg: ModelConfig, tokens, positions=None,
            cache: Optional[dict] = None, cache_len=None,
            mode: str = "train", block_tables=None):
    """tokens (B, S) -> (logits (B, S, Vp), cache, aux). The cache, when
    given, is updated in place and returned."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    B, S = tokens.shape[:2]
    if positions is None:
        ar = torch.arange(S, dtype=torch.int32, device=x.device)[None]
        if cache_len is None:
            positions = ar.expand(B, S)
        elif isinstance(cache_len, int):
            positions = (ar + cache_len).expand(B, S)
        else:
            cl = torch.as_tensor(cache_len, dtype=torch.int32,
                                 device=x.device)
            off = (cl.clamp(min=0)[:, None] if cl.dim() == 1
                   else cl.expand(B, 1))
            positions = ar + off
    x, cache = run_layers(params, cfg, x, positions, cache, cache_len, mode,
                          block_tables)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    aux = {"aux_loss": torch.zeros((), device=x.device)}
    return lm_logits(params, cfg, x), cache, aux
