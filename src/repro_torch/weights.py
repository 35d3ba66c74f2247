"""Weight carry-over between the JAX package's layout and the port's.

``params_from_jax`` takes the tree that ``repro.models.init_lm`` returns,
converted to numpy arrays (``jax.tree.map(np.asarray, params)``), and
returns the port's parameters, so the two packages compute the same
function. The JAX tree stacks every layer parameter on a leading L axis
(for ``lax.scan``); the port unstacks it into one dict per layer. The
hybrid family's ``shared`` block is one set of tensors in both (not
stacked), and the audio family's (K, ...) codebook ``embed`` and ``head``
carry over whole. ``params_to_jax`` is its inverse (numpy float32 in the
JAX tree's stacked layout): the training checkpoint writes parameters and
AdamW moments through it, so that either package restores the other's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.models.transformer import (F32_LEAVES, _check_family,
                                            compute_dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Matrices, biases and conv weights go to ``dtype`` (default
    ``cfg.dtype``; training passes float32); the ``F32_LEAVES`` stay
    float32."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)

    def conv(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        return t.to(device=device,
                    dtype=torch.float32 if name in F32_LEAVES else dtype)

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


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the port's tree (parameters, or
    a tree of the same shape such as AdamW's moments) as numpy float32
    arrays in the JAX layout, every layer leaf stacked on a leading L
    axis."""
    arr = lambda t: t.detach().to("cpu", torch.float32).numpy()

    def stack(blocks):
        return {k: (stack([b[k] for b in blocks]) if isinstance(v, dict)
                    else np.stack([arr(b[k]) for b in blocks]))
                for k, v in blocks[0].items()}

    whole = lambda sub: {k: (whole(v) if isinstance(v, dict) else arr(v))
                         for k, v in sub.items()}
    out = {name: arr(params[name])
           for name in ("embed", "head", "final_ln") if name in params}
    out["blocks"] = stack(params["blocks"])
    if "shared" in params:
        out["shared"] = whole(params["shared"])
    return out
