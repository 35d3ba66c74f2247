"""Architecture registry: ``--arch`` name resolution, which (arch, shape)
cells apply, and ``input_specs``, the dry run's stand-ins for a cell's
step inputs. The counterpart of ``repro.configs.registry``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig

from .mamba2_130m import CONFIG as mamba2_130m
from .mistral_nemo_12b import CONFIG as mistral_nemo_12b
from .moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from .musicgen_medium import CONFIG as musicgen_medium
from .phi3_5_moe_42b import CONFIG as phi3_5_moe_42b
from .qwen1_5_110b import CONFIG as qwen1_5_110b
from .qwen2_1_5b import CONFIG as qwen2_1_5b
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (musicgen_medium, tinyllama_1_1b, qwen1_5_110b,
              mistral_nemo_12b, qwen2_1_5b, zamba2_7b, mamba2_130m,
              qwen2_vl_2b, moonshot_v1_16b_a3b, phi3_5_moe_42b)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k decode runs only for bounded-state archs (spec)."""
    if shape.name.startswith("long") and not cfg.supports_long_context:
        return False, (
            "skipped: pure full-attention arch — a 524288-token KV cache "
            "decode is reserved for ssm/hybrid archs per spec "
            "(DESIGN.md §12)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, object]:
    """Stand-ins for every input of the cell's step function, the dict of
    JAX's ``input_specs``: tensors on ``device`` (``meta`` by default,
    which allocates nothing) where JAX has ``ShapeDtypeStruct``. The
    decode cache is ``models.make_cache(cfg, B, S)``'s, so its dtype is
    the config's compute dtype (JAX's ``make_cache`` defaults to bf16;
    every registered arch computes in bf16)."""
    B, S = shape.global_batch, shape.seq_len
    f = lambda s, dt: torch.empty(s, dtype=dt, device=device)
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            out = {"embeds": f((B, S, cfg.d_model), bf16),
                   "positions": f((B, S, 3), i32)}
            if shape.kind == "train":
                out["labels"] = f((B, S), i32)
            return out
        if cfg.n_codebooks:
            return {"tokens": f((B, S, cfg.n_codebooks), i32)}
        return {"tokens": f((B, S), i32)}

    # decode: one new token against a cache of size S
    from repro_torch.models.transformer import make_cache

    tok = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    return {"tokens": f(tok, i32),
            "cache": make_cache(cfg, B, S, device=device),
            "cache_len": f((), i32)}
