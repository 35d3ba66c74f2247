"""Decoder-only LM assembly for the ported families:
  dense : [rmsnorm -> GQA attn -> rmsnorm -> SwiGLU] x L
  moe   : [rmsnorm -> GQA attn -> rmsnorm -> MoE] x L
  ssm   : [rmsnorm -> Mamba2] x L

Parameters are a dict: ``embed`` (Vp, D), ``head`` (D, Vp) unless tied,
``final_ln`` (D,), and ``blocks``, a list with one dict per layer (the JAX
version stacks them on a leading L axis for ``lax.scan``; here a Python
loop walks the list). Matrices are stored in the compute dtype
``cfg.dtype``, norm scales (and Mamba2's ``A_log``, ``D``, ``dt_bias``)
in float32 (the JAX version stores float32 masters and casts to the
compute dtype on every use, which rounds to the same values).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .attention import attn_fwd, attn_init
from .config import ModelConfig
from .layers import embed_init, mlp_fwd, mlp_init, resolve_device, rmsnorm
from .mamba2 import STATE_KEYS, mamba_fwd, mamba_init
from .moe import moe_fwd, moe_init


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


FAMILIES = ("dense", "moe", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.n_codebooks or cfg.mrope:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have {FAMILIES})")


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
    if cfg.family == "ssm":
        params["blocks"] = [
            {"ln": zeros(), "mamba": mamba_init(cfg, generator, device, dt)}
            for _ in range(cfg.n_layers)
        ]
    else:
        params["blocks"] = []
        for _ in range(cfg.n_layers):
            blk = {"ln1": zeros(),
                   "attn": attn_init(cfg, generator, device, dt),
                   "ln2": zeros()}
            if cfg.family == "moe":
                blk["moe"] = moe_init(cfg, generator, device, dt)
            else:
                blk["mlp"] = mlp_init(D, cfg.d_ff, generator, device, dt)
            params["blocks"].append(blk)
    params["final_ln"] = zeros()
    return params


# ----------------------------------------------------------------- cache
def n_attn_caches(cfg: ModelConfig) -> int:
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _recurrent_leaves(cfg: ModelConfig, slots: int, dtype, device):
    """Per-slot Mamba2 state (L, slots, ...): conv states in ``dtype``
    (they hold compute-dtype values, so this is lossless), ssm in float32
    as JAX hard-codes."""
    if cfg.family != "ssm":
        return {}
    L, k1 = cfg.n_layers, cfg.ssm_conv - 1
    z = lambda *s, dt=dtype: torch.zeros((L, slots) + s, dtype=dt,
                                         device=device)
    return {"conv_x": z(k1, cfg.d_inner),
            "conv_B": z(k1, cfg.ssm_state),
            "conv_C": z(k1, cfg.ssm_state),
            "ssm": z(cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim,
                     dt=torch.float32)}


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """Contiguous per-slot caches: attention k/v (L, batch, max_seq, Hkv,
    hd) and, for the ssm family, the recurrent leaves per slot."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    cache = {}
    if n_attn_caches(cfg):
        kv = (n_attn_caches(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
        cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    cache.update(_recurrent_leaves(cfg, batch, dtype, device))
    return cache


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Paged serving cache: per-layer k/v pools of ``num_blocks`` blocks of
    ``block_size`` tokens, indirected through per-sequence block tables.
    Each pool holds ONE extra block, index ``num_blocks``: the sink that
    dropped writes (idle slots, table entries past an allocation) go to,
    where JAX drops them. No table points at it and no kernel reads it.
    Recurrent conv/ssm state is O(1) per sequence, so it stays dense per
    decode slot (``slots`` rows, no sink)."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    cache = {}
    if n_attn_caches(cfg):
        kv = (n_attn_caches(cfg), num_blocks + 1, block_size,
              cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
        cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    cache.update(_recurrent_leaves(cfg, slots, dtype, device))
    return cache


# -------------------------------------------------------------- forward
def _zero_aux(cfg: ModelConfig, device):
    aux = {"aux_loss": torch.zeros((), device=device)}
    if cfg.family == "moe":
        aux["expert_counts"] = torch.zeros(cfg.n_experts, device=device)
        aux["dropped"] = torch.zeros((), device=device)
    return aux


def run_layers(params, cfg: ModelConfig, x, positions, cache, cache_len,
               mode, block_tables=None):
    """Apply every block; caches are per-layer views updated in place.
    Returns (x, cache, aux): aux sums each layer's ``aux_loss`` (and, for
    the moe family, ``expert_counts`` and ``dropped``) as JAX's scan
    does."""
    aux = _zero_aux(cfg, x.device)
    if cfg.family == "ssm":
        # Per-slot lengths in decode: -1 marks a slot whose state stays.
        active = (cache_len >= 0 if mode == "decode"
                  and torch.is_tensor(cache_len) and cache_len.dim() == 1
                  else None)
        for li, bp in enumerate(params["blocks"]):
            mcache = ({k: cache[k][li] for k in STATE_KEYS}
                      if cache else None)
            h, _ = mamba_fwd(bp["mamba"],
                             rmsnorm(x, bp["ln"], cfg.norm_eps), cfg,
                             cache=mcache, mode=mode, active=active)
            x = x + h
        return x, cache, aux
    for li, bp in enumerate(params["blocks"]):
        acache = ({"k": cache["k"][li], "v": cache["v"][li]}
                  if cache else None)
        h, _ = attn_fwd(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                        positions, cfg, cache=acache, cache_len=cache_len,
                        mode=mode, block_tables=block_tables)
        x = x + h
        hin = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            h, moe_aux = moe_fwd(bp["moe"], hin, cfg)
            for k in aux:
                aux[k] = aux[k] + moe_aux[k]
        else:
            h = mlp_fwd(bp["mlp"], hin)
        x = x + h
    return x, cache, aux


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
    x, cache, aux = run_layers(params, cfg, x, positions, cache, cache_len,
                               mode, block_tables)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return lm_logits(params, cfg, x), cache, aux
