"""Architecture configs the port runs (exact published dims).

Only the archs whose family the port implements are registered: dense
(tinyllama, qwen2), ssm (mamba2) and moe (moonshot-v1-16b-a3b,
phi3.5-moe-42b-a6.6b).
"""
from typing import Dict

from repro_torch.models.config import SHAPES, ModelConfig

from .mamba2_130m import CONFIG as mamba2_130m
from .moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from .phi3_5_moe_42b import CONFIG as phi3_5_moe_42b
from .qwen2_1_5b import CONFIG as qwen2_1_5b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (tinyllama_1_1b,
                                                      qwen2_1_5b,
                                                      mamba2_130m,
                                                      moonshot_v1_16b_a3b,
                                                      phi3_5_moe_42b)}

__all__ = ["ARCHS", "SHAPES"]
