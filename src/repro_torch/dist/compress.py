"""Int8 error-feedback gradient compression. The counterpart of
``repro.dist.compress``.

The standard EF-SGD compressed all-reduce, in JAX's order of operations:

  corrected = grad + err                 # fold in what earlier rounds dropped
  q, scale  = int8_quantize(corrected)   # one scale shared over the group
  out       = psum(q as int32) * (scale / n)
  err'      = corrected - q * scale      # remember this round's truncation

The scale is shared (``pmax`` of each rank's amax), so every rank's codes
lie on one grid and one integer sum plus one float32 multiply gives the
mean. Error feedback keeps the time-averaged transmitted gradient
unbiased, so training tracks the exact mean closely.

The reference sums the codes as int32 (``compress.py:67`` there), so the
bytes on the wire are float32's, 4 per element, whatever its docstring
says of int8; the port keeps those semantics (and so those bytes).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from . import collectives as C

_QMAX = 127.0


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def init_error(tree: Any) -> Any:
    """Zero float32 error-feedback buffers, one per gradient leaf. Thread
    them through training steps."""
    return _rebuild(tree, (torch.zeros_like(g, dtype=torch.float32)
                           for _, g in _leaves(tree)))


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as the reference divides. A Python number
    as the divisor of a CUDA tensor is applied as ``a * (1 / b)``, which
    can be one ulp off, and one ulp of the scale can move a code by one."""
    return a / torch.full_like(a, b)


def _quantize(x: torch.Tensor, amax: torch.Tensor):
    scale = _div(torch.clamp(amax, min=1e-30), _QMAX)
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantize -> dequantize. Worst-case error
    is half a quantization step, at most amax / 127."""
    xf = x.float()
    q, scale = _quantize(xf, xf.abs().max())
    return (q.float() * scale).to(x.dtype)


def compressed_psum_mean(tree: Any, group, err: Any) -> Tuple[Any, Any]:
    """Compressed mean-all-reduce of ``tree`` over the process ``group``
    with persistent error feedback ``err`` (from :func:`init_error`).
    With ``group=None`` it is the local quantize round trip (one rank).
    Returns ``(mean_tree, new_err)``."""
    def leaf(g, e):
        corrected = g.float() + e
        amax = corrected.abs().max()
        if group is not None:
            # shared grid across the group so raw codes sum exactly
            amax = C.pmax(amax, group)
        q, scale = _quantize(corrected, amax)
        sent = q.float() * scale
        if group is None:
            out = sent
        else:
            n = C.size(group)
            out = C.psum(q.to(torch.int32), group).float() * _div(scale, n)
        return out.to(g.dtype), corrected - sent

    flat_g, flat_e = list(_leaves(tree)), list(_leaves(err))
    if [p for p, _ in flat_g] != [p for p, _ in flat_e]:
        raise ValueError("error-feedback tree does not match the gradient "
                         "tree; build it with init_error()")
    pairs = [leaf(g, e) for (_, g), (_, e) in zip(flat_g, flat_e)]
    return (_rebuild(tree, (o for o, _ in pairs)),
            _rebuild(tree, (e for _, e in pairs)))
