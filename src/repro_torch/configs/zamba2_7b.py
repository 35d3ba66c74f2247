"""zamba2-7b [hybrid] — Mamba2 backbone + weight-shared attention blocks.
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]. The shared (attn+MLP) block is applied every
6 mamba layers with tied weights (Zamba2's weight sharing); deviations noted
in DESIGN.md."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    rope_theta=10000.0,
)
