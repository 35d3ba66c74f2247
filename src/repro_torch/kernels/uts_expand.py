"""UTS node expansion: the hot loop of the paper's ``process(n)`` (§2.5.2).

``uts_expand`` launches ``uts_expand_kernel`` of ``csrc/uts.cu`` (it
replaces the Pallas kernel ``repro/kernels/uts_expand.py:uts_expand``;
``_launch`` also reaches the first version of that kernel,
``uts_expand_lane_kernel``, which only the card tests and
``chip_smoke.py`` call, to hold the two against each other).
For M nodes and ``width`` consecutive child indices base + lane it hashes
each child's descriptor with three rounds of the 32-bit finalizer
``fmix32`` and samples its geometric child count as the number of the 32
thresholds T_k with h0 < T_k (unsigned). Its plain PyTorch version is
``uts_expand_ref`` (the counterpart of ``repro.kernels.ref.uts_expand_ref``);
the two are bit-exact.

Descriptors and thresholds are uint32 values. PyTorch on the CPU has no
shift, compare or add for ``torch.uint32``, so they travel as int32
tensors holding the uint32 bit pattern; the plain version widens them to
int64 in [0, 2^32), keeps every product, sum and shift there (masking to
32 bits) and narrows back. The kernel does native uint32 arithmetic on
the same bits.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CHILD = 32
# fmix32 multipliers (C1, C2) and the child-index mixing constants (C3, C4)
C1, C2, C3, C4 = 0x7FEB352D, 0x846CA68B, 0x9E3779B9, 0x85EBCA77
MASK32 = 0xFFFFFFFF


def widen(bits: torch.Tensor) -> torch.Tensor:
    """int32 uint32-bits -> int64 in [0, 2^32)."""
    return bits.to(torch.int64) & MASK32


def narrow(h: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), without leaving int64: the
    low and high 16-bit halves of h are multiplied separately, so no
    product exceeds 2^48."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32_t(h: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (splitmix/murmur-style avalanche) on int64 values
    in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul32(h, C1)
    h = h ^ (h >> 15)
    h = mul32(h, C2)
    return h ^ (h >> 16)


def child_hash_t(d0: torch.Tensor, d1: torch.Tensor, i: torch.Tensor):
    """Descriptor (h0, h1) of child ``i`` of node (d0, d1); all int64 in
    [0, 2^32), broadcast together."""
    h0 = fmix32_t((d0 + mul32(i, C3)) & MASK32)
    h1 = fmix32_t(((d1 ^ h0) + mul32(i, C4)) & MASK32)
    return fmix32_t(h0 ^ h1), h1


def child_count_t(h0: torch.Tensor, thresholds: torch.Tensor):
    """#{k : h0 < T_k} as int32; h0 and thresholds int64 in [0, 2^32)."""
    return (h0[..., None] < thresholds).sum(-1).to(torch.int32)


def uts_expand_ref(d0, d1, base, thresholds, width: int):
    """Plain PyTorch node expansion. d0, d1 (M,) and thresholds
    (MAX_CHILD,) int32 uint32-bits; base (M,) int32. Returns cd0, cd1
    (M, width) int32 uint32-bits and m (M, width) int32 (the count BEFORE
    the depth cut-off: the caller owns depth logic)."""
    lane = torch.arange(width, dtype=torch.int64, device=d0.device)
    idx = (base.to(torch.int64)[:, None] + lane[None, :]) & MASK32
    h0, h1 = child_hash_t(widen(d0)[:, None], widen(d1)[:, None], idx)
    return narrow(h0), narrow(h1), child_count_t(h0, widen(thresholds))


def _launch(entry: str, d0, d1, base, thresholds, width: int):
    """Check the CUDA arguments and launch ``entry`` of the ``uts``
    library (``repro_uts_expand`` or ``repro_uts_expand_lane``) into new
    outputs; returns (cd0, cd1, m). Counts nothing."""
    M = d0.shape[0] if d0.dim() == 1 else -1
    for name, t, shape in (("d0", d0, (M,)), ("d1", d1, (M,)),
                           ("base", base, (M,)),
                           ("thresholds", thresholds, (MAX_CHILD,))):
        if t.dtype != torch.int32 or t.device != d0.device:
            raise TypeError(f"uts_expand: {name} must be int32 on "
                            f"{d0.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"uts_expand: {name} shape {tuple(t.shape)}, "
                             f"want contiguous {shape}")
    if M < 1 or width < 1 or M * width >= 2 ** 31:
        raise ValueError(f"uts_expand: M={M} x width={width} must be "
                         "in [1, 2^31)")
    # one allocation: each output starts 8-byte aligned when the width is
    # even, as the kernel's 8-byte stores need
    out = torch.empty((3, M, width), dtype=torch.int32, device=d0.device)
    cd0, cd1, m = out.unbind(0)
    err = getattr(_build.lib("uts"), entry)(
        d0.data_ptr(), d1.data_ptr(), base.data_ptr(),
        thresholds.data_ptr(), cd0.data_ptr(), cd1.data_ptr(), m.data_ptr(),
        M, width, torch.cuda.current_stream(d0.device).cuda_stream,
    )
    _build.check(err, "uts_expand")
    return cd0, cd1, m


def uts_expand(d0, d1, base, thresholds, *, width: int = 64):
    """Expand M nodes x ``width`` child lanes (arguments as
    ``uts_expand_ref``). A CPU tensor goes to ``uts_expand_ref``; a CUDA
    tensor launches the kernel (or raises). Any M >= 1 is taken."""
    if d0.device.type == "cpu":
        return uts_expand_ref(d0, d1, base, thresholds, width)
    if d0.device.type != "cuda":
        raise ValueError(f"uts_expand: unsupported device {d0.device}")
    out = _launch("repro_uts_expand", d0, d1, base, thresholds, width)
    uts_expand.launches += 1
    return out


uts_expand.launches = 0   # kernel launches (the CPU path never counts)
