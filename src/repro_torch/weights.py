"""Weight carry-over from the JAX package.

``params_from_jax`` takes the tree that ``repro.models.init_lm`` returns,
converted to numpy arrays (``jax.tree.map(np.asarray, params)``), and
returns the port's parameters, so the two packages compute the same
function. The JAX tree stacks every layer parameter on a leading L axis
(for ``lax.scan``); the port unstacks it into one dict per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import _check_family, compute_dtype

_NORMS = ("ln1", "ln2", "final_ln")    # kept in float32, as the JAX math


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Matrices and biases go to ``dtype`` (default ``cfg.dtype``), norm
    scales stay float32."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)

    def conv(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        return t.to(device=device,
                    dtype=torch.float32 if name in _NORMS else dtype)

    def layer(sub, i):
        return {k: (layer(v, i) if isinstance(v, dict) else conv(k, v[i]))
                for k, v in sub.items()}

    out = {name: conv(name, tree[name])
           for name in ("embed", "head", "final_ln") if name in tree}
    out["blocks"] = [layer(tree["blocks"], i) for i in range(cfg.n_layers)]
    return out
