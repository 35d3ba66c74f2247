"""Unbalanced Tree Search (paper §2.5) as a GLB problem. The counterpart
of ``repro.problems.uts``.

Tree: fixed geometric law, branching factor b0 (paper: 4), splittable-hash
RNG seeded with r (paper: 19), depth cut-off d (paper: 13..20). A node's
child count is geometric with mean b0 (clamped at MAX_CHILD; the tail beyond
32 has probability 0.8^32 ≈ 8e-4). All nodes are treated equally
irrespective of depth, as the paper requires.

A task item is a tree node as the paper's triple ``(descriptor, low,
high)`` (§2.5.2) — the node's hash state (d0, d1) and the interval
[low, high) of its unexplored children — plus the node depth, packed into
one row of five int32 words (the JAX package keeps five fields). Split
halves every (well, the oldest K) node's interval; nodes with a single
child are not split. Merge concatenates.

Descriptors are uint32 values kept in int32 tensors that hold the uint32
bits (PyTorch on the CPU has no uint32 shift, compare or add; see
``kernels.uts_expand``). ``fmix32`` / ``child_hash`` / ``child_count`` /
``root_desc`` take ``xp``: ``numpy`` computes in native uint32 (the oracle,
the breadth-first count), ``torch`` on int64 values in [0, 2^32).

``process`` pops one node per place and expands all P popped nodes with
one call of ``kernels.ops.expand_uts`` (the hand-written CUDA kernel on
the card) per loop iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import taskbag as tb
from ..core.problem import GLBProblem, masked_while
from ..kernels import ops
from ..kernels.uts_expand import (C1 as _C1, C2 as _C2, C3 as _C3,
                                  C4 as _C4, MAX_CHILD, child_count_t,
                                  child_hash_t, fmix32_t)

# One item is a row of five int32 words, packed so that every bag
# operation is one gather or scatter instead of five: the descriptor
# (d0, d1) as uint32 bits, the depth, and the child interval [lo, hi).
D0, D1, DEPTH, LO, HI = range(5)
ITEM_SPEC = {"node": ((5,), torch.int32)}

__all__ = ["MAX_CHILD", "ITEM_SPEC", "D0", "D1", "DEPTH", "LO", "HI",
           "fmix32", "child_hash", "geom_thresholds", "child_count",
           "root_desc", "uts_problem", "uts_oracle", "uts_count_bfs"]


# ---------------------------------------------------------------- hashing
def fmix32(h, xp):
    """32-bit finalizer (splitmix/murmur-style avalanche)."""
    if xp is torch:
        return fmix32_t(h)
    u = np.uint32
    h = h ^ (h >> u(16))
    h = h * u(_C1)
    h = h ^ (h >> u(15))
    h = h * u(_C2)
    h = h ^ (h >> u(16))
    return h


def child_hash(d0, d1, i, xp):
    """Splittable RNG: descriptor of child `i` of node (d0, d1)."""
    if xp is torch:
        return child_hash_t(d0, d1, i & 0xFFFFFFFF)
    u = np.uint32
    i = np.asarray(i).astype(np.uint32)
    h0 = fmix32(d0 + i * u(_C3), np)
    h1 = fmix32((d1 ^ h0) + i * u(_C4), np)
    h0 = fmix32(h0 ^ h1, np)
    return h0, h1


def geom_thresholds(b0: float) -> np.ndarray:
    """T_k = floor(((b0/(1+b0))^k) * 2^32): child count = #{k: u < T_k}.

    Integer compares keep every implementation bit-identical;
    E[count] ~= b0."""
    p_cont = b0 / (1.0 + b0)
    t = np.floor((p_cont ** np.arange(1, MAX_CHILD + 1)) * 2.0**32)
    return np.minimum(t, 2.0**32 - 1).astype(np.uint32)


def child_count(h0, thresholds, xp):
    if xp is torch:
        return child_count_t(h0, thresholds)
    u = np.asarray(h0)[..., None]
    return (u < thresholds).sum(axis=-1).astype(np.int32)


def root_desc(seed: int, xp=np):
    """The root's descriptor (d0, d1) as numpy uint32 scalars (``xp=np``)
    or int64 tensors in [0, 2^32) (``xp=torch``)."""
    u = np.uint32
    with np.errstate(over="ignore"):
        d0 = fmix32(u(seed) * u(_C3) + u(0x12345678), np)
        d1 = fmix32((u(seed) ^ u(0xDEADBEEF)) * u(_C4) + u(1), np)
    if xp is torch:
        return torch.tensor(int(d0)), torch.tensor(int(d1))
    return d0, d1


def _bits(v) -> int:
    """A uint32 value as the int32 holding its bits."""
    return int(np.uint32(v).view(np.int32))


# ------------------------------------------------------------ GLB problem
def uts_problem(
    b0: float = 4.0,
    depth: int = 8,
    seed: int = 19,
    capacity: int = 8192,
    gen_width: int = 0,  # child-gen vector width; 0 => GLB n at call time
    impl: str = "auto",  # node expansion: ops.expand_uts's impl
) -> GLBProblem:
    thresholds_bits = geom_thresholds(b0).view(np.int32)
    thresholds = {}     # device -> (MAX_CHILD,) int32 tensor

    # UTS convention: the root has exactly round(b0) children (a geometric
    # draw would make ~1/(1+b0) of all trees trivially empty).
    root_children = max(1, int(round(b0)))
    r0, r1 = root_desc(seed, np)

    def init_place(P, device):
        bag = tb.make_bag(ITEM_SPEC, capacity, P, device)
        m_root = root_children if depth > 0 else 0
        root = torch.tensor([_bits(r0), _bits(r1), 0, 0, m_root],
                            dtype=torch.int32, device=device)
        bag = tb.push_one(bag, {"node": root.expand(P, 5)})
        first = torch.arange(P, device=device) == 0
        bag["size"] = torch.where(first & (m_root > 0), bag["size"], 0)
        # The root itself counts as one visited node (at place 0).
        state = {"count": first.to(torch.int32)}
        return state, bag

    def process(state, bag, budget: int, mask):
        width = gen_width or budget  # block width for child hashing
        dev = bag["size"].device
        if dev not in thresholds:
            thresholds[dev] = torch.as_tensor(thresholds_bits, device=dev)
        thr = thresholds[dev]
        P = mask.shape[0]
        lane = torch.arange(width, dtype=torch.int32, device=dev)
        zeros = torch.zeros((P, width), dtype=torch.int32, device=dev)
        count = state["count"]

        # left is 0 outside the mask from the start and only falls, so
        # left > 0 implies the mask.
        def cond(left):
            size = bag["size"]
            room = size <= capacity - width - 1
            return (left > 0) & (size > 0) & room

        def body(left, act):
            nonlocal count
            _, item = tb.pop_tail(bag, act)
            node = item["node"]
            d0, d1, _, lo, hi = node.t().contiguous()   # (P,) rows
            c_total = hi - lo
            g = torch.minimum(c_total, left)
            valid = lane[None, :] < g[:, None]
            cd0, cd1, m = ops.expand_uts(d0, d1, lo, thr, width=width,
                                         impl=impl)
            child_depth = node[:, DEPTH] + 1
            m = torch.where((child_depth < depth)[:, None] & valid, m, 0)

            # Parent remainder goes back first; children land on top (DFS).
            # One push of [parent, children]: the loop's room condition
            # keeps both at offset size, as JAX's two pushes place them.
            parent = node.clone()
            parent[:, LO] = lo + g
            child = torch.stack([cd0, cd1,
                                 child_depth[:, None].expand(P, width),
                                 zeros, m], dim=-1)
            block = torch.cat([parent[:, None], child], dim=1)
            keep = torch.cat([(c_total > g)[:, None], valid & (m > 0)],
                             dim=1)
            block, n_new = tb.compact_block({"node": block}, keep)
            tb.push_block(bag, block, torch.where(act, n_new, 0))

            g = torch.where(act, g, 0)
            count = count + g
            return left - g

        left0 = torch.where(mask, budget, 0).to(torch.int32)
        left = masked_while(cond, body, left0, budget)
        return {"count": count}, bag, left0 - left

    def split(bag, k: int, mask):
        blk = tb.read_front(bag, k)["node"]
        lane = torch.arange(blk.shape[1], dtype=torch.int32,
                            device=mask.device)
        in_bag = lane[None, :] < torch.clamp(bag["size"], max=k)[:, None]
        lo, hi = blk[..., LO], blk[..., HI]
        c = hi - lo
        splittable = in_bag & (c >= 2)  # paper: single-child nodes not split
        mid = lo + (c + 1) // 2         # keep ceil, give floor
        keep, give = blk.clone(), blk.clone()
        keep[..., HI] = torch.where(splittable, mid, hi)
        give[..., LO] = mid
        tb.write_front(bag, {"node": keep}, mask)
        items, count = tb.compact_block({"node": give}, splittable)
        return bag, {"items": items,
                     "count": torch.where(mask, count, 0)}

    return GLBProblem(
        name=f"uts-b{b0}-d{depth}",
        item_spec=ITEM_SPEC,
        capacity=capacity,
        init_place=init_place,
        process=process,
        split=split,
        merge=tb.merge_packet,
        result=lambda st: st["count"],
        reduce_op="sum",
    )


# ------------------------------------------------------------------ oracle
def uts_oracle(b0: float = 4.0, depth: int = 8, seed: int = 19) -> int:
    """Sequential pure-python/numpy tree count, bit-identical hashing."""
    thr = geom_thresholds(b0)
    with np.errstate(over="ignore"):
        d0, d1 = root_desc(seed, np)
        count = 1
        if depth <= 0:
            return count
        m_root = max(1, int(round(b0)))  # fixed root branching, as above
        stack = [(np.uint32(d0), np.uint32(d1), 0, m_root)]
        while stack:
            p0, p1, dep, m = stack.pop()
            idx = np.arange(m, dtype=np.uint32)
            c0, c1 = child_hash(p0, p1, idx, np)
            count += m
            if dep + 1 < depth:
                mc = child_count(c0, thr, np)
                for i in range(m):
                    if mc[i] > 0:
                        stack.append(
                            (np.uint32(c0[i]), np.uint32(c1[i]), dep + 1, int(mc[i]))
                        )
        return count


def uts_count_bfs(b0: float = 4.0, depth: int = 8, seed: int = 19,
                  chunk: int = 1 << 22) -> int:
    """The same count as ``uts_oracle``, level by level in vectorized
    numpy (the same hashing helpers), for trees too large for the
    sequential oracle: the paper's depth-13 tree has 125,350,485 nodes.
    Nodes are expanded ``chunk`` children at a time to bound memory."""
    thr = geom_thresholds(b0)
    count = 1
    if depth <= 0:
        return count
    with np.errstate(over="ignore"):
        d0, d1 = root_desc(seed, np)
        d0 = np.asarray([d0], np.uint32)
        d1 = np.asarray([d1], np.uint32)
        m = np.asarray([max(1, int(round(b0)))], np.int64)
        for dep in range(depth):
            count += int(m.sum())
            if dep + 1 >= depth:
                break
            nxt = ([], [], [])
            # expand parents in slices of about `chunk` children
            ends = np.cumsum(m)
            start = 0
            while start < len(m):
                stop = int(np.searchsorted(ends, ends[start] - m[start]
                                           + chunk, side="right"))
                stop = max(stop, start + 1)
                mm = m[start:stop]
                parent = np.repeat(np.arange(start, stop), mm)
                first = np.repeat(np.cumsum(mm) - mm, mm)
                idx = (np.arange(parent.size) - first).astype(np.uint32)
                c0, c1 = child_hash(d0[parent], d1[parent], idx, np)
                mc = child_count(c0, thr, np)
                keep = mc > 0
                nxt[0].append(c0[keep])
                nxt[1].append(c1[keep])
                nxt[2].append(mc[keep].astype(np.int64))
                start = stop
            d0, d1, m = (np.concatenate(a) for a in nxt)
    return count
