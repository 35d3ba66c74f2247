"""GLB-MoE: the paper's lifeline load balancing applied to expert placement.

The counterpart of ``repro.models.glb_moe``. The "task items" are expert
shards: each of R expert-parallel ranks owns E/R expert slots, and the
per-expert token counts ``moe_fwd`` returns are the load signal. Between
steps (rarely, on the host) the same deterministic matching as the
replica balancer (``core.lifeline.match_steals``) runs on per-rank loads:
underloaded ranks are hungry thieves, overloaded ranks victims, and a
matched steal swaps the victim's hottest expert with the thief's coldest
(a swap keeps slot counts, and so shapes, static). A logical-expert ->
physical-slot map (``perm``) makes a swap a pure weight permutation: the
layer computes the same function, only placement moves.

The random round's victims are an argument: ``candidates(r, P, w) -> (P,
w)`` for round r, by default drawn from ``numpy.random.default_rng([seed,
r])``. The JAX version folds r into ``key(seed)``, which numpy cannot
replay; a parity test passes those draws in.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import GLBParams, lifeline_buddies, match_steals, random_candidates


class RebalanceResult(NamedTuple):
    perm: np.ndarray          # (E,) logical expert -> physical slot
    loads_before: np.ndarray  # (R,)
    loads_after: np.ndarray   # (R,)
    swaps: list               # [(rank_victim, rank_thief, slot_a, slot_b)]


def _rank_loads(counts, perm, n_ranks):
    E = counts.shape[0]
    per = E // n_ranks
    slot_load = np.zeros(E)
    slot_load[perm] = counts          # load of the slot hosting each expert
    return slot_load.reshape(n_ranks, per).sum(axis=1), slot_load


def glb_expert_rebalance(counts, perm, n_ranks: int, rounds: int = 8,
                         hunger: float = 0.9, seed: int = 0,
                         candidates=None) -> RebalanceResult:
    """counts (E,): tokens routed to each logical expert; perm (E,): the
    current logical -> slot map. A rank is hungry below ``hunger`` x the
    mean load; each round matches thieves to victims and applies the
    swaps that narrow the pair's imbalance."""
    counts = np.asarray(counts, np.float64)
    perm = np.asarray(perm, np.int64).copy()
    E = counts.shape[0]
    assert E % n_ranks == 0
    per = E // n_ranks
    params = GLBParams(w=2)
    if candidates is None:
        candidates = lambda r, P, w: random_candidates(
            np.random.default_rng([seed, r]), P, w)
    buddies = lifeline_buddies(n_ranks, params.resolve_z(n_ranks))
    pending = np.zeros((n_ranks, n_ranks), bool)
    loads0, _ = _rank_loads(counts, perm, n_ranks)
    swaps = []

    for r in range(rounds):
        loads, slot_load = _rank_loads(counts, perm, n_ranks)
        mean = loads.mean()
        hungry = loads < hunger * mean
        if not hungry.any():
            break
        # surplus (integerized) is the "bag size": only above-mean ranks give
        sizes = np.maximum(loads - mean, 0).astype(np.int32)
        cand = np.asarray(candidates(r, n_ranks, params.w),
                          np.int32).reshape(n_ranks, -1)
        m = match_steals(sizes, hungry, pending, cand, buddies, params)
        pending = m.pending
        did = False
        for thief in range(n_ranks):
            victim = int(m.src[thief])
            if victim < 0:
                continue
            # swap victim's hottest expert with thief's coldest
            v_slots = np.arange(victim * per, (victim + 1) * per)
            t_slots = np.arange(thief * per, (thief + 1) * per)
            hot = v_slots[np.argmax(slot_load[v_slots])]
            cold = t_slots[np.argmin(slot_load[t_slots])]
            gain = slot_load[hot] - slot_load[cold]
            if gain <= 0:
                continue
            # apply only if it improves the pairwise imbalance
            if loads[victim] - loads[thief] > gain * 0.5:
                e_hot = int(np.nonzero(perm == hot)[0][0])
                e_cold = int(np.nonzero(perm == cold)[0][0])
                perm[e_hot], perm[e_cold] = cold, hot
                slot_load[hot], slot_load[cold] = slot_load[cold], slot_load[hot]
                loads, _ = _rank_loads(counts, perm, n_ranks)
                swaps.append((victim, thief, int(hot), int(cold)))
                did = True
        if not did and not pending.any():
            break

    loads1, _ = _rank_loads(counts, perm, n_ranks)
    return RebalanceResult(perm=perm, loads_before=loads0, loads_after=loads1,
                           swaps=swaps)


def permute_expert_params(moe_params: dict, perm_old, perm_new) -> dict:
    """Physically move expert weights so logical expert e sits at slot
    perm_new[e]: a gather on the leading expert axis of wg, wi and wo. The
    router stays logical."""
    perm_old = np.asarray(perm_old)
    perm_new = np.asarray(perm_new)
    E = perm_old.shape[0]
    # w_new[perm_new[e]] = w_old[perm_old[e]]  =>  gather index per new slot
    gather = np.empty(E, np.int64)
    gather[perm_new] = perm_old
    out = dict(moe_params)
    for k in ("wg", "wi", "wo"):
        w = moe_params[k]
        out[k] = w[torch.as_tensor(gather, device=w.device)]
    return out
