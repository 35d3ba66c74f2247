"""Model substrate: the dense decoder-only LM (GQA attention, SwiGLU)."""
from .config import SHAPES, ModelConfig, ShapeConfig
from .lm import decode_step, prefill, sample_tokens
from .transformer import (forward, init_lm, lm_logits, make_cache,
                          make_paged_cache, run_layers)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES",
    "init_lm", "forward", "run_layers", "lm_logits", "make_cache",
    "make_paged_cache", "prefill", "decode_step", "sample_tokens",
]
