"""Model substrate: the decoder-only LM in its dense (GQA attention,
SwiGLU), moe (GQA attention, top-k routed experts) and ssm (Mamba2)
families."""
from .config import SHAPES, ModelConfig, ShapeConfig
from .lm import decode_step, prefill, sample_tokens
from .transformer import (forward, init_lm, lm_logits, make_cache,
                          make_paged_cache, n_attn_caches, run_layers)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES",
    "init_lm", "forward", "run_layers", "lm_logits", "make_cache",
    "make_paged_cache", "n_attn_caches", "prefill", "decode_step",
    "sample_tokens",
]
