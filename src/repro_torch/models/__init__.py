"""Model substrate: the decoder-only LM in its dense (GQA attention,
SwiGLU), moe (GQA attention, top-k routed experts), ssm (Mamba2), hybrid
(Mamba2 with a weight-shared attention block), vlm (M-RoPE over merged
embeddings) and audio (codebook streams) families."""
from .config import SHAPES, ModelConfig, ShapeConfig
from .lm import decode_step, prefill, sample_tokens, train_loss
from .transformer import (apply_layer, embed_tokens, forward, init_lm,
                          lm_logits, make_cache, make_paged_cache,
                          n_attn_caches, run_layers)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES",
    "init_lm", "forward", "apply_layer", "run_layers", "embed_tokens",
    "lm_logits", "make_cache",
    "make_paged_cache", "n_attn_caches", "prefill", "decode_step",
    "sample_tokens", "train_loss",
]
