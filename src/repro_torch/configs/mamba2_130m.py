"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
24L d_model=768 vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
)
