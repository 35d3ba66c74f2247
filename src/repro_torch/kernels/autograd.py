"""Gradients through the hand-written kernels.

A kernel writes into a tensor that the wrapper makes with ``torch.empty``,
so its output carries no ``grad_fn``: called as is in training, it would
cut the gradient of every input upstream of it while the loss still
falls through the residual stream. ``KernelFunction`` puts the launch
inside a ``torch.autograd.Function``: the forward is the kernel's launch,
as in serving, and the backward recomputes the kernel's plain PyTorch
version from the saved inputs under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` through it. The JAX package defines no
``custom_vjp`` for its Pallas kernels (JAX differentiates their plain
versions off the TPU), so there is no backward kernel to port; the
backward is that of the plain version, which computes the same function.

A wrapper takes this route only when autograd will need it
(``needs_grad``): under ``torch.inference_mode()`` or ``torch.no_grad()``,
as the serving engine runs, the kernel launches directly.
"""
from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd records and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if torch.is_tensor(t))


class KernelFunction(torch.autograd.Function):
    """``KernelFunction.apply(launch, plain, *args)``: the value of
    ``launch(*args)``, the gradient of ``plain(*args)``. ``args`` may mix
    tensors and constants; integer tensors get no gradient. ``launch`` and
    ``plain`` return one tensor or a tuple of tensors; an output whose
    gradient is None (not used downstream) adds nothing to the backward,
    as zeros would."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, *args):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        ctx.consts = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a in args if torch.is_tensor(a)))
        return launch(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]       # False for every constant
        args = [next(saved).detach().requires_grad_(need) if is_t else c
                for is_t, c, need in zip(ctx.is_tensor, ctx.consts, needs)]
        wrt = [a for a, need in zip(args, needs) if need]
        # The range names the plain version, so that a profile of a
        # training step can sum the device time of each kernel's backward.
        with torch.profiler.record_function(
                f"KernelFunction.backward[{ctx.plain.__name__}]"), \
                torch.enable_grad():
            outs = ctx.plain(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wrt else [None] * len(wrt))
        got = iter(torch.zeros_like(a) if g is None else g
                   for g, a in zip(got, wrt))
        return (None, None, *(next(got) if need else None for need in needs))
