"""Architecture configs the port runs (exact published dims).

Only the archs whose family the port implements (dense) are registered.
"""
from typing import Dict

from repro_torch.models.config import SHAPES, ModelConfig

from .qwen2_1_5b import CONFIG as qwen2_1_5b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (tinyllama_1_1b,
                                                      qwen2_1_5b)}

__all__ = ["ARCHS", "SHAPES"]
