"""Grouped matrix product for MoE expert compute.

``gmm`` replaces the Pallas kernel ``repro/kernels/moe_gmm.py:gmm`` with
one kernel of ``csrc/gmm.cu`` per dtype, chosen by the C side from the
dtype code: bfloat16 launches the tensor-core ``gmm_tc_kernel``, float32
the CUDA-core ``gmm_kernel`` (TF32 would not hold float32's parity). An
empty group costs no bytes: its blocks exit before reading its weights. The rows of x (T, D) are grouped
by expert: group e is rows [offs[e], offs[e + 1]) with offs = [0,
cumsum(group_sizes)], and ``out[i] = x[i] @ w[e]`` for its rows, with w
(E, D, F). Products accumulate in float32 and the output is rounded once
to x's dtype. Its plain PyTorch version is ``gmm_ref``.

Rows past ``sum(group_sizes)`` belong to no group. The Pallas kernel
writes zeros there (no expert's mask covers them), while
``repro.kernels.ref.gmm_ref`` clips the expert index and gives them the
last expert's product. The port follows the Pallas kernel, in the kernel
and in ``gmm_ref``: those rows are zeros. (The JAX tests always fill T,
where the two agree.)
"""
from __future__ import annotations

import torch

from . import _build
from .autograd import KernelFunction, needs_grad


def gmm_ref(x, w, group_sizes):
    """Plain grouped matrix product: x (T, D), w (E, D, F), group_sizes
    (E,) int. One float32 product per group on its slice of rows (never
    the per-row weight gather ``w[expert_of]``, which at the MoE prefill
    shape would be a 22 GB tensor); rows past the groups are zeros.

    Sizes on the ``meta`` device have no values to read: there every group
    holds T / E rows, the MoE layer's capacity layout (JAX's einsum
    dispatch over (E, cap, D)), so that a shape-only trace counts its
    work."""
    T = x.shape[0]
    if group_sizes.device.type == "meta":
        E, D, F = w.shape
        return torch.bmm(x.float().reshape(E, T // E, D),
                         w.float()).reshape(T, F).to(x.dtype)
    out = torch.zeros((T, w.shape[2]), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        stop = min(start + max(n, 0), T)
        if stop > start:
            out[start:stop] = x[start:stop].float() @ w[e].float()
        start = stop
    return out.to(x.dtype)


def gmm(x, w, group_sizes):
    """x (T, D) and w (E, D, F) float32 or bfloat16 (one dtype),
    group_sizes (E,) int32 -> (T, F) in x's dtype.

    A CPU tensor goes to ``gmm_ref``; a CUDA tensor launches the kernel
    (or raises). Where autograd needs the gradient, the launch runs
    inside ``KernelFunction``, whose backward is that of ``gmm_ref``
    (``group_sizes`` gets none)."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    if needs_grad(x, w):
        return KernelFunction.apply(_launch, gmm_ref, x, w, group_sizes)
    return _launch(x, w, group_sizes)


def _launch(x, w, group_sizes):
    """One counted launch of the kernel of x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {x.device}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    T, D = x.shape
    E, _, F = w.shape
    code = _build.DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"gmm: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if w.dtype != x.dtype:
        raise TypeError(f"gmm: mixed dtypes {x.dtype} / {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"gmm: tensors on {w.device} and {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm: x and w must be contiguous")
    _build.check_index("gmm", group_sizes, (E,), x.device)
    if min(T, D, F, E) < 1 or E >= 65535:
        raise ValueError(f"gmm: T={T} D={D} F={F} E={E} must be >= 1, "
                         "E < 65535")
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    err = _build.lib("gmm").repro_gmm(
        code, x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), T, D, F, E,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "gmm")
    gmm.launches += 1
    return out


gmm.launches = 0   # launches of either dtype's kernel (never the CPU path)
