"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
48L d_model=1536 24H (GQA kv=24 = MHA) d_ff=6144 vocab=2048, 4 codebooks.
[arXiv:2306.05284; hf]. Frontend (EnCodec) is a stub: the model consumes
the 4 parallel token streams directly (delay-pattern handling lives in the
data pipeline, not the backbone)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    n_codebooks=4,
    rope_theta=10000.0,
)
