"""Lifeline topology + deterministic steal matching (paper §2.4), in numpy.

The counterpart of ``repro.core.lifeline``. There every place holds the
same replicated inputs each superstep (the gathered size vector, a
superstep-folded PRNG key and the pending-lifeline matrix), so the
paper's asynchronous request/response protocol collapses into a
deterministic matching computed redundantly on every place. Here P is the
number of serving replicas and the matching runs on the host, in numpy.

Matching passes, in order:
  1. pending-lifeline service — buddies that now have work serve their
     oldest remembered request (the paper's "remember and push later");
  2. random round — each still-hungry thief tries its w random victims;
  3. lifeline round — each still-hungry thief tries its z buddies in
     dimension order; unsatisfied edges are recorded in ``pending``.

The random round's victims are an argument (``cand``, (P, w)) instead of
a JAX key: PyTorch and numpy cannot replay JAX's threefry stream, so the
caller draws them (``random_candidates`` from a ``numpy.random.Generator``)
or, in a parity test, passes in the draws the JAX reference made.

Topology: buddy_i(p) = (p + 2^i) mod P for i < z, the cyclic
generalization of the paper's hypercube.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .params import GLBParams


def terminated(loads) -> bool:
    """GLB termination detection: the load vector every place already
    gathers for the steal matching doubles as the termination detector —
    the computation is over exactly when ``all(load == 0)``."""
    return not bool(np.any(np.asarray(loads)))


def lifeline_buddies(P: int, z: int) -> np.ndarray:
    """Static (P, z) buddy table: buddy_i(p) = (p + 2^i) mod P."""
    p = np.arange(P)[:, None]
    i = np.arange(z)[None, :]
    return ((p + (1 << i)) % P).astype(np.int32)


def lifeline_mask(P: int, z: int) -> np.ndarray:
    """(P, P) bool — m[t, v] iff v is a lifeline buddy of t."""
    buddies = lifeline_buddies(P, z)
    m = np.zeros((P, P), dtype=bool)
    for t in range(P):
        m[t, buddies[t]] = True
    return m


def rewire_lifelines(alive, z: int) -> np.ndarray:
    """Post-failure buddy table: the 2^i circulant rebuilt over the
    surviving place set, with the static (P, z) shape. Dead rows point at
    themselves (inert); alive rows jump 2^i hops along the compacted
    survivor ring, ``buddy_i(p) = survivors[(rank(p) + 2^i) % S]``, and a
    jump that wraps onto p itself takes the ring neighbour instead."""
    alive = np.asarray(alive, dtype=bool)
    P = alive.shape[0]
    survivors = np.flatnonzero(alive)
    S = survivors.size
    if S == 0:
        raise ValueError("rewire_lifelines: no surviving places")
    out = np.repeat(np.arange(P, dtype=np.int32)[:, None], z, axis=1)
    if S > 1:
        for r, p in enumerate(survivors):
            for i in range(z):
                b = survivors[(r + (1 << i)) % S]
                out[p, i] = b if b != p else survivors[(r + 1) % S]
    return out


def diffusion_pairs(costs, threshold: float, eligible=None):
    """Proactive donor -> recipient pairing for cost-modeled balancing:
    every place whose cost exceeds ``mean * (1 + threshold)`` is a donor,
    paired richest-first with the cheapest eligible place strictly below
    the mean, each recipient used once per pass, ties broken by place
    index. Returns ``[(donor, recipient), ...]``; empty when balanced."""
    costs = np.asarray(costs, dtype=np.float64)
    P = costs.shape[0]
    if eligible is None:
        eligible = np.ones(P, dtype=bool)
    eligible = np.asarray(eligible, dtype=bool)
    mean = float(costs.mean())
    if mean <= 0.0:
        return []
    hi = mean * (1.0 + threshold)
    donors = sorted(np.flatnonzero(costs > hi).tolist(),
                    key=lambda p: (-costs[p], p))
    takers = sorted(
        np.flatnonzero(eligible & (costs < mean)).tolist(),
        key=lambda p: (costs[p], p))
    pairs = []
    for d in donors:
        if not takers:
            break
        r = takers.pop(0)
        if r == d:
            if not takers:
                break
            r = takers.pop(0)
        pairs.append((d, r))
    return pairs


def random_candidates(rng: np.random.Generator, P: int,
                      w: int) -> np.ndarray:
    """The random round's (P, w) victims: w places other than the thief,
    ``(t + 1 + randint(0, P - 1)) % P``, as the JAX matching draws them
    (from its own key). Empty (P, 0) when there is nobody to rob."""
    if P < 2 or w <= 0:
        return np.zeros((P, 0), np.int32)
    draws = rng.integers(0, P - 1, (P, w))
    return ((np.arange(P)[:, None] + 1 + draws) % P).astype(np.int32)


class MatchResult(NamedTuple):
    src: np.ndarray           # (P,) i32 — victim each thief receives from, -1 none
    dst: np.ndarray           # (P,) i32 — thief each victim sends to, -1 none
    via_lifeline: np.ndarray  # (P,) bool — thief matched via a lifeline edge
    pending: np.ndarray       # (P, P) bool — updated pending-lifeline matrix


def match_steals(
    sizes,                   # (P,) i32 — STEALABLE sizes
    hungry,                  # (P,) bool — places that want work
    pending,                 # (P, P) bool — pending[t, v]: t waits on buddy v
    cand,                    # (P, w) i32 — random-round victims per thief
    buddies,                 # (P, z) i32 buddy table
    params: GLBParams,
) -> MatchResult:
    sizes = np.asarray(sizes)
    hungry = np.asarray(hungry, dtype=bool)
    pending = np.asarray(pending, dtype=bool)
    buddies = np.asarray(buddies)
    P = sizes.shape[0]
    z = buddies.shape[1]
    neg = np.full((P,), -1, np.int32)
    if params.no_steal:   # static-partitioning baseline: nobody steals
        return MatchResult(src=neg, dst=neg.copy(),
                           via_lifeline=np.zeros((P,), bool),
                           pending=pending.copy())
    claimed = ~(sizes >= max(params.min_give, 1))   # unusable victims
    matched = ~hungry                               # non-hungry never steal
    src, dst = neg.copy(), neg.copy()
    via = np.zeros((P,), bool)

    def claim(t, v, found, via_lifeline):
        """Pair thief t with victim v if ``found`` and t is unmatched."""
        if not (found and not matched[t]):
            return
        v = min(max(int(v), 0), P - 1)
        claimed[v] = True
        matched[t] = True
        src[t] = v
        dst[v] = t
        via[t] = via_lifeline

    # Each pass visits the thieves in place order. Only a visit to t can
    # match t, so the thieves still unmatched when a pass starts are the
    # only ones it can change, and it visits just those (the same order
    # and claims as a visit to every place).
    # pass 1: serve remembered lifeline requests (oldest edge = lowest v)
    for t in np.flatnonzero(~matched & pending.any(axis=1)):
        row = pending[t] & ~claimed
        v = int(np.argmax(row)) if row.any() else P
        claim(t, v, bool(row.any()), True)
    # pass 2: random round — w victims per thief (never itself)
    cand = np.asarray(cand)
    if P > 1 and cand.shape[1] > 0:
        for t in np.flatnonzero(~matched):
            for i in range(cand.shape[1]):
                v = int(cand[t, i])
                claim(t, v, not claimed[v], False)
    # pass 3: lifeline round — buddies in dimension order
    for t in np.flatnonzero(~matched):
        for i in range(z):
            v = int(buddies[t, i])
            claim(t, v, not claimed[v], True)

    # Pending update: unmatched hungry thieves (re-)register their
    # lifelines, from the ``buddies`` argument (self-edges register
    # nothing); thieves that got work clear their outstanding requests.
    ll_mask = np.zeros((P, P), bool)
    ll_mask[np.arange(P)[:, None], buddies] = True
    ll_mask &= ~np.eye(P, dtype=bool)
    unmatched = hungry & ~matched
    new_pending = (pending | (ll_mask & unmatched[:, None])) \
        & ~matched[:, None]
    src = np.where(hungry, src, -1).astype(np.int32)
    return MatchResult(src=src, dst=dst, via_lifeline=via,
                       pending=new_pending)
