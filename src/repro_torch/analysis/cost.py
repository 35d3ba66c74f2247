"""What a step costs, read off an eager trace: the counterpart of XLA's
``compiled.cost_analysis()`` and of the temp size of its
``memory_analysis()``.

``trace_cost(fn, *args)`` calls ``fn`` once under two dispatch modes and
returns three numbers (``trace`` returns ``fn``'s output beside them):

  flops      — ``torch.utils.flop_counter``'s formulas (those of its
               ``FlopCounterMode``): matrix products, convolutions and
               attention, 2 per multiply-add, forward and backward alike;
  bytes      — the bytes of every tensor operand and result of every aten
               op that is not a view (a view moves nothing). Each op is
               counted as if it ran alone, reading its inputs from memory
               and writing its outputs back: an unfused count, so an upper
               bound on the memory traffic of the same work; a fused
               kernel, or a cache hit, moves less;
  peak_bytes — the largest sum of the tensors the call made that were
               alive at one time (each storage counted once, from the op
               that made it until its last reference goes, the autograd
               graph's saved tensors included). Tensors that were
               arguments of ``fn`` are not in it.

On ``meta`` tensors the call allocates and computes nothing, so a full
production step traces in seconds on a host; on real tensors (the GLB
superstep, whose matching reads values) it runs for real.

On DTensors the three numbers are one device's: the mode passes every
DTensor op on to DTensor's dispatch and counts the local aten ops that
it issues on this rank's shards (FLOPs by ``torch.utils.flop_counter``'s
formulas, bytes and peak as above); the fake tensors of its sharding
propagation are not counted, nor are the collectives' bytes (those are
``dist.collectives.CollectiveLog``'s); what a collective returns (a
gathered weight, say) is in the peak.

Unlike XLA's count, which sees the body of a loop once, an eager trace
runs every trip: each q block of ``attention_chunked``, each chunk of the
SSD scan, each layer. So the JAX dry run's reduced-depth extrapolation
and its loop corrections (``repro/launch/dryrun.py``: ``_lin``,
``analyze_cost``, ``loop_corrections``) have no counterpart here: the
trace at full depth is already the whole step.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..dist.collectives import _NAMESPACES


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class ByteMode(TorchDispatchMode):
    """Counts the FLOPs of every aten op, the operand and result bytes of
    every non-view one, and the peak of the live storages the ops made
    (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._made: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._made.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not all(t in (torch.Tensor, torch.nn.Parameter) for t in types):
            return out                     # sharding propagation's fakes
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if func.is_view:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func.namespace not in _NAMESPACES:
            # (a collective's bytes go on the wire: CollectiveLog's)
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._made:
                continue
            n = st.nbytes()
            self._made[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def trace(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, float]]:
    """``fn(*args, **kwargs)`` once, traced: (its output, {"flops",
    "bytes", "peak_bytes"}) (see the module docstring)."""
    with ByteMode() as mode:
        out = fn(*args, **kwargs)
    return out, {"flops": float(mode.flops), "bytes": float(mode.bytes),
                 "peak_bytes": float(mode.peak)}


def trace_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """``trace``'s three numbers alone."""
    return trace(fn, *args, **kwargs)[1]


__all__ = ["ByteMode", "trace", "trace_cost"]
