"""GPipe-style pipeline parallelism over a ``stage`` mesh dimension. The
counterpart of ``repro.dist.pipeline``.

``split_layers_into_stages`` cuts the port's per-layer list of blocks into
``n_stages`` contiguous chunks; ``pipeline_forward`` runs the classic
microbatched fill-drain schedule, one stage per rank of the ``stage``
dimension:

  tick t: stage 0 injects microbatch t (while t < M), every stage applies
  its chunk to whatever it holds, and a ``ppermute`` shifts activations
  one stage rightward. After M + S - 1 ticks every microbatch has crossed
  all S stages; the last stage collects the outputs, which a masked
  ``psum`` replicates to every stage.

Ticks where a stage holds no live microbatch (the pipeline's bubbles) run
the stage on zeros, and the result is never collected, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from . import collectives as C


def split_layers_into_stages(blocks: Sequence[Any], n_stages: int) -> list:
    """The per-layer list ``blocks`` as ``n_stages`` contiguous lists of
    L // n_stages layers each."""
    L = len(blocks)
    if L % n_stages != 0:
        raise ValueError(
            f"layer count {L} not divisible into {n_stages} stages")
    per = L // n_stages
    return [list(blocks[s * per:(s + 1) * per]) for s in range(n_stages)]


def pipeline_forward(fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stages: Sequence[Any], x: torch.Tensor, mesh,
                     axis: str = "stage") -> torch.Tensor:
    """Run ``fn(stage_params, h)`` as an S-stage pipeline over
    microbatches, on every rank of ``mesh``'s ``axis`` dimension.

    ``stages``: one entry per stage (from :func:`split_layers_into_stages`);
    the rank of stage s reads only ``stages[s]``. ``x``: (M, ...) stacked
    microbatch inputs, the same on every rank. ``fn`` must keep the shape
    and dtype of its activation. Returns the (M, ...) outputs on every
    rank, those of the sequential schedule."""
    group = mesh.get_group(axis)
    S = C.size(group)
    if len(stages) != S:
        raise ValueError(
            f"stage count {len(stages)} != mesh axis {axis!r} size {S}")
    idx = C.rank(group)
    last = S - 1
    sp = stages[idx]
    M = x.shape[0]
    shift = [(i, i + 1) for i in range(S - 1)]
    state = torch.zeros_like(x[0])
    buf = torch.zeros_like(x)
    for t in range(M + S - 1):
        # stage 0 injects microbatch t; others consume last tick's receive
        h = x[min(t, M - 1)] if idx == 0 else state
        out = fn(sp, h)
        # the last stage finishes microbatch (t - last) on this tick
        slot = t - last
        if idx == last and 0 <= slot < M:
            buf[slot] = out
        # shift activations one stage rightward; stage 0 receives zeros
        (state,) = C.ppermute([out], shift, group)
    # only the last stage holds real outputs -> masked psum replicates
    if idx != last:
        buf.zero_()
    return C.psum(buf, group)
