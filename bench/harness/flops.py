"""Frozen arithmetic: the peaks of the chip, and the operations and bytes
that an engine step's work needs. What one request or one attention call
costs is the model's layout's (``bench/layouts/<layout>.py``: its
``prompt_flops``, ``decode_flops``, ``prefill_attention`` and
``decode_attention``, reckoned from ``d``, its ``dims(cfg)``); here they
are summed over a step.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989e12 FLOP/s in bfloat16 on the tensor cores, 3.35e12 B/s of HBM3.

Model FLOPs (the ``mfu`` yardstick) count the requests' own tokens:
each prompt admitted in the step, and each slot's decoded tokens.

Attention kernels' roofline: for each call, the larger of its FLOPs over
the bf16 peak and its bytes over the HBM bandwidth. A prefill call is
reckoned at the rows it launched, which the engine reports on its
``prefill`` span (``harness.spans.prefill_rows``), never at a padding
rule mirrored here.
"""
from __future__ import annotations

from typing import Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
INT32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def step_attention_bound(layout, d: dict, step, rows: Sequence[int],
                         slots: int, block_size: int, iters: int) -> float:
    """Least seconds the attention calls of one engine step could take:
    each prefill, at the ``rows`` it launched, then each of the ``iters``
    decode iterations that a step with any prefill or running sequence
    launches for all slots (a slot is active in the first ``tokens`` of
    them)."""
    total = sum(bound_s(*layout.prefill_attention(d, r)) for r in rows)
    if not rows and not step.decode:
        return total
    for t in range(iters):
        wins = [c + t + 1 for c, n in step.decode if t < n]
        total += bound_s(*layout.decode_attention(d, wins, slots,
                                                  block_size))
    return total


def step_model_flops(layout, d: dict, step) -> float:
    return (sum(layout.prompt_flops(d, n) for n in step.admitted)
            + sum(layout.decode_flops(d, c, n) for c, n in step.decode))
