"""Weight carry-over from the JAX package.

``params_from_jax`` takes the tree that ``repro.models.init_lm`` returns,
converted to numpy arrays (``jax.tree.map(np.asarray, params)``), and
returns the port's parameters, so the two packages compute the same
function. The JAX tree stacks every layer parameter on a leading L axis
(for ``lax.scan``); the port unstacks it into one dict per layer. The
hybrid family's ``shared`` block is one set of tensors in both (not
stacked), and the audio family's (K, ...) codebook ``embed`` and ``head``
carry over whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import _check_family, compute_dtype

# Leaves kept in float32, as the JAX math uses them: norm scales, and
# Mamba2's A_log, D, dt_bias (cast at use by ``mamba_fwd``).
_F32 = ("ln1", "ln2", "final_ln", "ln", "gate_norm", "A_log", "D",
        "dt_bias")


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Matrices, biases and conv weights go to ``dtype`` (default
    ``cfg.dtype``); the ``_F32`` leaves stay float32."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)

    def conv(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        return t.to(device=device,
                    dtype=torch.float32 if name in _F32 else dtype)

    def layer(sub, i):
        return {k: (layer(v, i) if isinstance(v, dict) else conv(k, v[i]))
                for k, v in sub.items()}

    out = {name: conv(name, tree[name])
           for name in ("embed", "head", "final_ln") if name in tree}
    out["blocks"] = [layer(tree["blocks"], i) for i in range(cfg.n_layers)]
    if "shared" in tree:
        whole = lambda sub: {k: (whole(v) if isinstance(v, dict)
                                 else conv(k, v)) for k, v in sub.items()}
        out["shared"] = whole(tree["shared"])
    return out
