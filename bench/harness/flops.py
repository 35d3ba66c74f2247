"""Frozen arithmetic: the peaks of the chip, and the operations and bytes
that the served work needs, reckoned from a configuration's sizes and the
requests' lengths. ``d`` is ``harness.weights.dims(cfg)``.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989e12 FLOP/s in bfloat16 on the tensor cores, 3.35e12 B/s of HBM3.

Model FLOPs (the ``mfu`` yardstick, the same work whatever implements
it): a matrix product of the non-embedding weights is 2 FLOPs a weight a
token; causal attention is 4 * hd FLOPs a head for each (query, visible
key) pair (q.k, then p.v); the head is 2 * D * V at each position whose
token is sampled. A prompt of n tokens is n rows of products, n(n+1)/2
pairs a head and layer, and one head position; a decoded token at cache
length c (it sees c + 1 keys) is one row, c + 1 pairs, one head
position. Bucket padding and logits that nobody samples are not work.

Attention kernels' roofline: for each call, the larger of its FLOPs over
the bf16 peak and its bytes over the HBM bandwidth, where the bytes read
each input once and write the output once. A prefill call of a padded
bucket of S rows (causal over all of them, as launched): q, k, v, out.
A decode call over all slots: each slot's q and output, and each active
slot's keys and values of its window and its block-table entries.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
INT32 = 4


def layer_weights(d: dict) -> int:
    """Non-embedding matrix weights of one layer."""
    D, Hq, Hkv, hd, F = d["D"], d["Hq"], d["Hkv"], d["hd"], d["F"]
    return D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D + 3 * D * F


def prompt_flops(d: dict, n: int) -> float:
    """Model FLOPs of prefilling a prompt of ``n`` tokens and sampling
    its first token."""
    return (2.0 * layer_weights(d) * d["L"] * n
            + 4.0 * d["hd"] * d["Hq"] * d["L"] * n * (n + 1) / 2
            + 2.0 * d["D"] * d["V"])


def decode_flops(d: dict, cache_len: int, tokens: int) -> float:
    """Model FLOPs of ``tokens`` decode steps of one sequence whose cache
    holds ``cache_len`` tokens before the first of them."""
    pairs = tokens * (cache_len + 1) + tokens * (tokens - 1) / 2
    return (tokens * (2.0 * layer_weights(d) * d["L"] + 2.0 * d["D"] * d["V"])
            + 4.0 * d["hd"] * d["Hq"] * d["L"] * pairs)


def prefill_attention(d: dict, S: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the causal attention calls of one prefill of a
    bucket of ``S`` rows, over all layers."""
    Hq, Hkv, hd = d["Hq"], d["Hkv"], d["hd"]
    flops = 4.0 * hd * Hq * S * (S + 1) / 2
    nbytes = BF16 * S * hd * (2 * Hq + 2 * Hkv)
    return flops * d["L"], float(nbytes) * d["L"]


def decode_attention(d: dict, windows: Iterable[int], slots: int,
                     block_size: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode iteration's attention calls (one a
    layer, every slot), over all layers; ``windows`` are the keys each
    active slot sees."""
    Hq, Hkv, hd = d["Hq"], d["Hkv"], d["hd"]
    flops, nbytes = 0.0, float(BF16 * slots * 2 * Hq * hd + INT32 * slots)
    for w in windows:
        flops += 4.0 * hd * Hq * w
        nbytes += BF16 * 2 * w * Hkv * hd + INT32 * -(-w // block_size)
    return flops * d["L"], nbytes * d["L"]


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def step_attention_bound(d: dict, step, slots: int, block_size: int,
                         iters: int) -> float:
    """Least seconds the attention calls of one engine step could take:
    each admission's prefill, then each of the ``iters`` decode
    iterations that a step with any running sequence launches for all
    slots (a slot is active in the first ``tokens`` of them)."""
    total = 0.0
    for _, S in step.admitted:
        total += bound_s(*prefill_attention(d, S))
    if not step.admitted and not step.decode:
        return total
    for t in range(iters):
        wins = [c + t + 1 for c, n in step.decode if t < n]
        total += bound_s(*decode_attention(d, wins, slots, block_size))
    return total


def step_model_flops(d: dict, step) -> float:
    return (sum(prompt_flops(d, n) for n, _ in step.admitted)
            + sum(decode_flops(d, c, n) for c, n in step.decode))
