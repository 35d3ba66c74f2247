"""Architecture configs the port runs (exact published dims).

Only the archs whose family the port implements (dense, ssm) are
registered.
"""
from typing import Dict

from repro_torch.models.config import SHAPES, ModelConfig

from .mamba2_130m import CONFIG as mamba2_130m
from .qwen2_1_5b import CONFIG as qwen2_1_5b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (tinyllama_1_1b,
                                                      qwen2_1_5b,
                                                      mamba2_130m)}

__all__ = ["ARCHS", "SHAPES"]
