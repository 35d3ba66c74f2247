"""Architecture configs (exact published dims) and their registry: the ten
archs of the JAX package, in every family the port runs (dense, moe, ssm,
hybrid, vlm, audio)."""
from repro_torch.models.config import SHAPES

from .registry import ARCHS, cell_applicable, get_config, input_specs

__all__ = ["ARCHS", "SHAPES", "cell_applicable", "get_config",
           "input_specs"]
