"""Architecture registry: ``--arch`` name resolution and which (arch,
shape) cells apply. The counterpart of ``repro.configs.registry`` (its
``input_specs``, the dry run's abstract inputs, is JAX tooling and is not
ported here)."""
from __future__ import annotations

from typing import Dict

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
