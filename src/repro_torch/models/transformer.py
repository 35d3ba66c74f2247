"""Decoder-only LM assembly for every family of the JAX package:
  dense/vlm/audio : [rmsnorm -> GQA attn -> rmsnorm -> SwiGLU] x L
  moe             : [rmsnorm -> GQA attn -> rmsnorm -> MoE] x L; with a
                    ``kv_lora_rank`` (``MLAConfig``) the attention is MLA
                    (``models.mla``) and the first ``first_k_dense``
                    layers take a d_ff SwiGLU in place of the MoE
  ssm             : [rmsnorm -> Mamba2] x L
  hybrid (zamba2) : [rmsnorm -> Mamba2] x L, plus ONE weight-shared
                    (attn + MLP) block applied after every ``attn_every``-th
                    layer (Zamba2's shared-block weight tying)

Parameters are a dict: ``embed`` (Vp, D), ``head`` (D, Vp) unless tied,
``final_ln`` (D,), and ``blocks``, a list with one dict per layer (the JAX
version stacks them on a leading L axis for ``lax.scan``; here a Python
loop walks the list). The hybrid family adds ``shared`` ({ln1, attn, ln2,
mlp}), one set of tensors that every application reads. The audio family
(musicgen) has K codebooks: ``embed`` (K, Vp, D), summed over the K token
streams, and ``head`` (K, D, Vp), logits (B, S, K, Vp). The vlm family
(qwen2-vl) takes precomputed merged embeddings (B, S, D) and M-RoPE
positions (B, S, 3) instead of tokens (the vision tower is a stub, as in
the JAX package). For serving, matrices are stored in the compute dtype
``cfg.dtype``, norm scales (and Mamba2's ``A_log``, ``D``, ``dt_bias``) in
float32 (the JAX version stores float32 masters and casts to the compute
dtype on every use, which rounds to the same values). Training keeps
float32 masters as JAX does (``init_lm(..., dtype=torch.float32)``): in
``mode="train"`` each layer casts its matrices, biases and convs to the
compute dtype inside its body, so that remat recomputes the cast copy
and the gradients arrive in float32.

Every entry point takes DTensor parameters and inputs laid out by
``dist.sharding`` (``distribute_tree`` of ``tree_shardings``), as the
JAX package's run under GSPMD: FSDP over ``data``, TP / EP over
``model``, DP over ``pod`` and ``data``. DTensor's sharding propagation
inserts the collectives; ``shard_act`` constrains the residual stream
after every block (and q, k, v and the MoE's slot buffers), at the JAX
package's sites. The constants a step builds (positions, zero
statistics) are made replicated on the activations' mesh
(``dist.sharding.like``), and partial sums are reduced at the residual
stream's inputs (``dist.sharding.reduced``). A plain tensor takes the
same path as before: ``shard_act``, ``reduced`` and ``like`` return it
as it is.

``cfg.remat`` applies in ``mode="train"`` while autograd records: each
layer's body runs under ``torch.utils.checkpoint`` (non-reentrant);
``none`` saves every activation, ``full`` none of the layer's, ``dots``
the outputs of its matrix products (``aten.mm`` / ``aten.addmm``, JAX's
``dots_with_no_batch_dims_saveable``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as _ckpt

from ..dist.sharding import (cache_axes, like, local_call, reduced,
                             shard_act, sharded_zeros)
from ..kernels import ops

from .attention import attn_fwd, attn_init
from .config import ModelConfig
from .layers import embed_init, mlp_fwd, mlp_init, resolve_device, rmsnorm
from .mamba2 import STATE_KEYS, mamba_fwd, mamba_init
from .mla import mla_fwd, mla_init
from .moe import moe_fwd, moe_init


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
REMATS = ("none", "dots", "full")

# Leaves kept in float32 whatever the compute dtype, as the JAX math uses
# them: norm scales, and Mamba2's A_log, D, dt_bias (cast at use by
# ``mamba_fwd``).
F32_LEAVES = ("ln1", "ln2", "final_ln", "ln", "gate_norm", "A_log", "D",
              "dt_bias", "kv_norm", "router_bias")


def cast_params(tree, dtype: torch.dtype):
    """The matrices, biases and conv weights of ``tree`` (nested dicts of
    tensors) cast to ``dtype``; the ``F32_LEAVES`` stay as they are. A
    leaf already in ``dtype`` is returned, not copied."""
    return {k: (cast_params(v, dtype) if isinstance(v, dict)
                else v if k in F32_LEAVES else v.to(dtype))
            for k, v in tree.items()}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"unknown family {cfg.family!r} (have {FAMILIES})")


# ------------------------------------------------------------------ init
def _attn_mlp_init(cfg: ModelConfig, generator, device, dt):
    zeros = lambda: torch.zeros(cfg.d_model, dtype=torch.float32,
                                device=device)
    attn = (mla_init if cfg.is_mla else attn_init)(cfg, generator, device, dt)
    return {"ln1": zeros(), "attn": attn, "ln2": zeros()}


def init_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
            device=None, dtype: Optional[torch.dtype] = None
            ) -> Dict[str, Any]:
    """Random weights with the distributions of ``repro.models.init_lm``
    (not its random numbers). ``generator`` must live on ``device``.
    Matrices are stored in ``dtype`` (default ``cfg.dtype``; training
    passes float32), the ``F32_LEAVES`` in float32."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    Vp, D = cfg.padded_vocab, cfg.d_model
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    params: Dict[str, Any] = {
        "embed": embed_init(K + (Vp, D), generator, device).to(dt)}
    if not cfg.tie_embeddings:
        params["head"] = embed_init(K + (D, Vp), generator, device).to(dt)
    zeros = lambda: torch.zeros(D, dtype=torch.float32, device=device)
    params["blocks"] = []
    for li in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            blk = {"ln": zeros(),
                   "mamba": mamba_init(cfg, generator, device, dt)}
        else:
            blk = _attn_mlp_init(cfg, generator, device, dt)
            if cfg.is_moe_layer(li):
                blk["moe"] = moe_init(cfg, generator, device, dt)
            else:
                blk["mlp"] = mlp_init(D, cfg.d_ff, generator, device, dt)
        params["blocks"].append(blk)
    if cfg.family == "hybrid":
        params["shared"] = dict(_attn_mlp_init(cfg, generator, device, dt),
                                mlp=mlp_init(D, cfg.d_ff, generator, device,
                                             dt))
    params["final_ln"] = zeros()
    return params


# ----------------------------------------------------------------- cache
def n_attn_caches(cfg: ModelConfig) -> int:
    """k/v cache layers: one per layer, none for ssm, and one per
    application of the shared block for hybrid."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _zeros(device):
    return lambda name, shape, dtype: torch.zeros(shape, dtype=dtype,
                                                  device=device)


def _recurrent_leaves(cfg: ModelConfig, slots: int, dtype, zeros):
    """Per-slot Mamba2 state (L, slots, ...) of the ssm and hybrid
    families: conv states in ``dtype`` (they hold compute-dtype values, so
    this is lossless), ssm in float32 as JAX hard-codes. ``zeros(name,
    shape, dtype)`` makes each leaf."""
    if cfg.family not in ("ssm", "hybrid"):
        return {}
    L, k1 = cfg.n_layers, cfg.ssm_conv - 1
    shapes = {"conv_x": ((k1, cfg.d_inner), dtype),
              "conv_B": ((k1, cfg.ssm_state), dtype),
              "conv_C": ((k1, cfg.ssm_state), dtype),
              "ssm": ((cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                      torch.float32)}
    return {k: zeros(k, (L, slots) + s, dt) for k, (s, dt) in shapes.items()}


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, mesh=None) -> Dict[str, torch.Tensor]:
    """Contiguous per-slot caches: attention k/v (n_attn_caches, batch,
    max_seq, Hkv, hd) and, for the ssm and hybrid families, the recurrent
    leaves per slot. With ``mesh``, each leaf a DTensor laid out on it by
    ``dist.sharding.cache_axes`` (JAX's prefill out_shardings), each rank
    allocating only its shard."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    zeros = _zeros(device)
    if mesh is not None:
        axes = cache_axes(cfg)
        zeros = lambda name, shape, dt: sharded_zeros(shape, dt, axes[name],
                                                      mesh, device)
    cache = {}
    if cfg.is_mla:
        # one latent row a token (the prefill row of the paged engine;
        # MLA decode reads the paged pool only)
        cache["kv"] = zeros("kv", (cfg.n_layers, batch, max_seq,
                                   cfg.latent_dim), dtype)
    elif n_attn_caches(cfg):
        kv = (n_attn_caches(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd)
        cache["k"] = zeros("k", kv, dtype)
        cache["v"] = zeros("v", kv, dtype)
    cache.update(_recurrent_leaves(cfg, batch, dtype, zeros))
    return cache


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, dtype=None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Paged serving cache: per-layer k/v pools of ``num_blocks`` blocks of
    ``block_size`` tokens, indirected through per-sequence block tables
    (an MLA config: one latent pool ``kv`` (L, num_blocks + 1, block_size,
    ``latent_dim``), one row a token for every head).
    Each pool holds ONE extra block, index ``num_blocks``: the sink that
    dropped writes (idle slots, table entries past an allocation) go to,
    where JAX drops them. No table points at it and no kernel reads it.
    Recurrent conv/ssm state is O(1) per sequence, so it stays dense per
    decode slot (``slots`` rows, no sink)."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    cache = {}
    if cfg.is_mla:
        cache["kv"] = torch.zeros((cfg.n_layers, num_blocks + 1, block_size,
                                   cfg.latent_dim), dtype=dtype,
                                  device=device)
    elif n_attn_caches(cfg):
        kv = (n_attn_caches(cfg), num_blocks + 1, block_size,
              cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
        cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    cache.update(_recurrent_leaves(cfg, slots, dtype, _zeros(device)))
    return cache


# -------------------------------------------------------------- forward
def _zero_aux(cfg: ModelConfig, x):
    """The zero sums of the MoE statistics, on x's device (and mesh)."""
    z = lambda *s: like(x, torch.zeros(s, device=x.device))
    aux = {"aux_loss": z()}
    if cfg.family == "moe":
        aux["expert_counts"] = z(cfg.n_experts)
        aux["dropped"] = z()
    if cfg.deepseek_moe:
        aux["moe_load"] = torch.zeros(3, dtype=torch.int64, device=x.device)
        aux["routes"] = []      # each MoE layer's (T, K) experts, in order
    return aux


def _layer_of(t, i: int):
    """Layer ``i``'s view of a cache leaf (L, ...). A DTensor's is taken
    on its local shard (its layer axis is never split): DTensor's own
    select would propagate its sharding afresh for every layer index."""
    if not isinstance(t, DTensor):
        return t[i]
    pls = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                for p in t.placements)
    return local_call(lambda c: c[i], pls, t)


def _attention(cfg, bp, x, positions, cache, ci, cache_len, mode,
               block_tables):
    """x + attention of ``bp`` (a block or the shared block) on k/v cache
    layer ``ci`` (a view, updated in place)."""
    if cfg.is_mla:
        h, _ = mla_fwd(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                       positions, cfg,
                       cache=_layer_of(cache["kv"], ci) if cache else None,
                       cache_len=cache_len, mode=mode,
                       block_tables=block_tables)
        return x + h
    acache = ({"k": _layer_of(cache["k"], ci), "v": _layer_of(cache["v"], ci)}
              if cache else None)
    h, _ = attn_fwd(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                    positions, cfg, cache=acache, cache_len=cache_len,
                    mode=mode, block_tables=block_tables)
    return x + reduced(h)


def _applies_shared(cfg: ModelConfig, li: int) -> bool:
    return cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0


def apply_layer(params, cfg: ModelConfig, li: int, x, positions,
                cache=None, cache_len=None, mode: str = "train",
                block_tables=None):
    """Layer ``li`` on x (B, S, D) and, for the hybrid family, the shared
    block where it follows that layer. Returns (x, aux): aux is the
    layer's MoE routing statistics (None for the other families)."""
    return _layer(cfg, params["blocks"][li], params.get("shared"), li, x,
                  positions, cache, cache_len, mode, block_tables)


def _layer(cfg, bp, sp, li, x, positions, cache, cache_len, mode,
           block_tables):
    """``apply_layer`` on the layer's parameters ``bp`` and the shared
    block's ``sp``."""
    if cfg.family in ("ssm", "hybrid"):
        # Per-slot lengths in decode: -1 marks a slot whose state stays.
        active = (cache_len >= 0 if mode == "decode"
                  and torch.is_tensor(cache_len) and cache_len.dim() == 1
                  else None)
        mcache = ({k: _layer_of(cache[k], li) for k in STATE_KEYS}
                  if cache else None)
        h, _ = mamba_fwd(bp["mamba"], rmsnorm(x, bp["ln"], cfg.norm_eps),
                         cfg, cache=mcache, mode=mode, active=active)
        x = x + reduced(h)
        if _applies_shared(cfg, li):
            # The shared block, on its application's own k/v layer.
            x = _attention(cfg, sp, x, positions, cache,
                           (li + 1) // cfg.attn_every - 1, cache_len, mode,
                           block_tables)
            x = x + reduced(mlp_fwd(sp["mlp"],
                                    rmsnorm(x, sp["ln2"], cfg.norm_eps)))
        return x, None
    x = _attention(cfg, bp, x, positions, cache, li, cache_len, mode,
                   block_tables)
    hin = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    if cfg.is_moe_layer(li):
        h, aux = moe_fwd(bp["moe"], hin, cfg)
        return x + reduced(h), aux
    return x + reduced(mlp_fwd(bp["mlp"], hin)), None


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` remat policy: keep matrix products' outputs."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _train_layer(params, cfg: ModelConfig, li: int, x, positions):
    """Layer ``li`` in training: its float32 masters cast to the compute
    dtype inside the body, the body under ``cfg.remat``."""
    def body(x):
        dt = compute_dtype(cfg)
        sp = (cast_params(params["shared"], dt)
              if _applies_shared(cfg, li) else None)
        return _layer(cfg, cast_params(params["blocks"][li], dt), sp, li,
                      x, positions, None, None, "train", None)

    if cfg.remat not in REMATS:
        raise ValueError(f"unknown remat {cfg.remat!r}; have {REMATS}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body(x)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    return _ckpt.checkpoint(body, x, use_reentrant=False, **kw)


def run_layers(params, cfg: ModelConfig, x, positions, cache, cache_len,
               mode, block_tables=None):
    """Apply every block; caches are per-layer views updated in place.
    Returns (x, cache, aux): aux sums each layer's ``aux_loss`` (and, for
    the moe family, ``expert_counts`` and ``dropped``) as JAX's scan
    does; a DeepSeek MoE's ``moe_load`` is summed likewise and its
    ``routes`` lists are joined."""
    aux = _zero_aux(cfg, x)
    for li in range(cfg.n_layers):
        if mode == "train":
            x, layer_aux = _train_layer(params, cfg, li, x, positions)
        else:
            x, layer_aux = apply_layer(params, cfg, li, x, positions, cache,
                                       cache_len, mode, block_tables)
        x = shard_act(x, "batch", "seq", "act_embed")
        if layer_aux is not None:
            for k in aux:
                aux[k] = aux[k] + layer_aux[k]
    return x, cache, aux


def _lookup(table, ids):
    """table[ids]. On DTensors, the vocab-sharded lookup: the table's
    embed dim is gathered (FSDP), each rank looks up the ids that fall in
    its vocab rows (zeros elsewhere), and the partial rows are summed over
    the vocab's mesh dims; the ids keep their batch split."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    table = table.redistribute(mesh, [p if v else Replicate() for p, v in
                                      zip(table.placements, vocab)])
    ids = ids.redistribute(mesh, [Replicate() if v else p for p, v in
                                  zip(ids.placements, vocab)])
    off = ops.shard_offset(table, 0)

    def local(t, i):
        rel = i.long() - off
        hit = (rel >= 0) & (rel < t.shape[0])
        rows = t[rel.clamp(0, t.shape[0] - 1)]
        return torch.where(hit.unsqueeze(-1), rows, 0.0).to(t.dtype)

    out = local_call(local, tuple(Partial() if v else p for p, v in
                                  zip(ids.placements, vocab)), table, ids)
    return out.redistribute(mesh, [Replicate() if v else p for p, v in
                                   zip(ids.placements, vocab)])


def embed_tokens(params, cfg: ModelConfig, tokens):
    if cfg.n_codebooks:
        # audio: sum the K codebook embeddings of (B, S, K) tokens
        emb = params["embed"]                           # (K, Vp, D)
        return sum(_lookup(emb[k], tokens[..., k])
                   for k in range(cfg.n_codebooks))
    return _lookup(params["embed"], tokens)


def lm_logits(params, cfg: ModelConfig, x):
    if cfg.n_codebooks:
        head = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
                else params["head"])                    # (K, D, Vp)
        if isinstance(x, DTensor):
            # one product a codebook: DTensor's einsum would reshape the
            # K heads' sharded vocab into K * Vp
            return torch.stack([x @ head[k] for k in range(head.shape[0])],
                               dim=2)
        return torch.einsum("bsd,kdv->bskv", x, head)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head


def forward(params, cfg: ModelConfig, tokens=None, positions=None,
            cache: Optional[dict] = None, cache_len=None,
            mode: str = "train", block_tables=None, embeds=None):
    """tokens (B, S), or (B, S, K) for audio; or, for vlm, ``embeds`` (B,
    S, D) merged embeddings. positions (B, S), or (B, S, 3) under M-RoPE;
    by default arange from the cache length (broadcast to the three
    streams under M-RoPE). Returns (logits (B, S, Vp) or (B, S, K, Vp),
    cache, aux); the cache, when given, is updated in place."""
    _check_family(cfg)
    if mode == "train":
        # Embedding and head as the compute dtype's copies of the masters
        # (the layers cast their own inside their bodies).
        top = {k: params[k] for k in ("embed", "head") if k in params}
        params = dict(params, **cast_params(top, compute_dtype(cfg)))
    if embeds is not None:
        x = embeds.to(compute_dtype(cfg))
    else:
        x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[:2]
    if positions is None:
        ar = like(x, torch.arange(S, dtype=torch.int32,
                                  device=x.device)[None])
        if cache_len is None:
            positions = ar.expand(B, S)
        elif isinstance(cache_len, int):
            positions = (ar + cache_len).expand(B, S)
        else:
            cl = (cache_len.to(torch.int32)
                  if isinstance(cache_len, DTensor) else
                  like(x, torch.as_tensor(cache_len, dtype=torch.int32,
                                          device=x.device)))
            off = (cl.clamp(min=0)[:, None] if cl.dim() == 1
                   else cl.expand(B, 1))
            positions = ar + off
        if cfg.mrope:
            positions = positions[..., None].expand(B, S, 3)
    x, cache, aux = run_layers(params, cfg, x, positions, cache, cache_len,
                               mode, block_tables)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return lm_logits(params, cfg, x), cache, aux
