"""SSCA2 R-MAT graph generator (paper §2.6.1 references SSCA2 v2.2). A
copy of ``repro.problems.rmat`` (numpy).

Recursive-matrix sampling with the SSCA2 probabilities (a,b,c,d) =
(0.57, 0.19, 0.19, 0.05), N = 2^scale vertices, edgefactor*N directed edges
before dedup/self-loop removal. Deterministic in `seed`.
"""
from __future__ import annotations

import numpy as np


def rmat_graph(
    scale: int,
    edgefactor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 7,
):
    """Returns (adj, n): dense float32 adjacency (row=src, col=dst), no
    self-loops, deduplicated. Dense is deliberate: the paper replicates the
    graph on every place ("small enough to fit in the memory of a single
    place") and the frontier sweeps become dense matrix products."""
    n = 1 << scale
    m = edgefactor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        u = rng.random(m)
        v = rng.random(m)
        # quadrant probabilities: a=TL, b=TR, c=BL, d=BR
        go_right = u >= a + c  # dst high bit
        go_down = np.where(go_right, v >= b / (b + (1 - a - b - c)), v >= a / (a + c))
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    adj = np.zeros((n, n), dtype=np.float32)
    adj[src, dst] = 1.0
    return adj, n


def brandes_bc_oracle(adj: np.ndarray) -> np.ndarray:
    """Exact betweenness centrality, unweighted directed Brandes — the
    reference for the GLB BC problem. O(N*E) python/numpy; test-scale only."""
    n = adj.shape[0]
    neighbors = [np.nonzero(adj[v])[0] for v in range(n)]
    bc = np.zeros(n, dtype=np.float64)
    for s in range(n):
        dist = -np.ones(n, dtype=np.int64)
        sigma = np.zeros(n, dtype=np.float64)
        dist[s] = 0
        sigma[s] = 1.0
        order = [s]
        frontier = [s]
        level = 0
        while frontier:
            nxt = []
            for u in frontier:
                for v in neighbors[u]:
                    if dist[v] < 0:
                        dist[v] = level + 1
                        nxt.append(v)
                        order.append(v)
                    if dist[v] == level + 1:
                        sigma[v] += sigma[u]
            frontier = nxt
            level += 1
        delta = np.zeros(n, dtype=np.float64)
        for v in reversed(order):
            for w in neighbors[v]:
                if dist[w] == dist[v] + 1 and sigma[w] > 0:
                    delta[v] += sigma[v] / sigma[w] * (1.0 + delta[w])
        delta[s] = 0.0
        bc += delta
        bc[s] -= 0.0
    # remove the source's own contribution counted as t==v? Brandes' delta
    # already excludes v==s; pairwise BC(v) excludes v==t by construction.
    return bc
