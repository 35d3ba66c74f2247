"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191; hf].
Backbone only per spec: the vision tower is a stub — input_specs provide
precomputed merged patch+text embeddings plus (B,S,3) M-RoPE positions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
)
