"""Betweenness Centrality (paper §2.6) as a GLB problem. The counterpart of
``repro.problems.bc``.

Exact Brandes on an SSCA2 R-MAT graph that is replicated on every place —
the paper's "very strong assumption" that the graph fits in one place's
memory, which makes tasks relocatable. A task item is a vertex interval
(low, high) (§2.6.2); split halves every interval; merge concatenates; the
result is the betweenness map, reduced element-wise.

The per-vertex computation is the paper's *interruptable state machine*:
the Brandes forward/backward sweeps live in ``state`` and
``process(budget)`` advances a bounded number of frontier sweeps, yielding
between sweeps. The in-progress vertex is reported via ``work_in_state``.

The sweeps of all P places are two dense products against the replicated
adjacency, (P, N) @ (N, N) forward and (P, N) @ (N, N)^T backward. They run
in full float32 (TF32 off): ``sigma`` counts shortest paths and
``reach > 0`` decides the frontier. Where ``vmap`` of ``lax.cond`` selects
per place, both branches are computed and selected, as JAX does.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import taskbag as tb
from ..core.problem import GLBProblem, masked_while

ITEM_SPEC = {
    "lo": ((), torch.int32),
    "hi": ((), torch.int32),
}


@contextlib.contextmanager
def _f32_matmul():
    """Full float32 products on the card for the duration (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sel(cond, a: dict, b: dict) -> dict:
    """Per-place select over dicts of tensors with a leading P axis."""
    return {k: torch.where(cond.reshape((-1,) + (1,) * (a[k].dim() - 1)),
                           a[k], b[k]) for k in a}


def bc_problem(adj: np.ndarray, capacity: int = 512,
               static_init: bool = True) -> GLBProblem:
    """adj: dense (N, N) float32 adjacency, row=src col=dst, replicated."""
    n = adj.shape[0]
    adj_np = np.asarray(adj, np.float32)
    adj_dev = {}        # device -> (N, N) float32 tensor

    def init_place(P, device):
        bag = tb.make_bag(ITEM_SPEC, capacity, P, device)
        p = torch.arange(P, dtype=torch.int32, device=device)
        if static_init:
            # Paper BC: vertices statically partitioned, GLB rebalances.
            lo = (p * n) // P
            hi = ((p + 1) * n) // P
            bag = tb.push_one(bag, {"lo": lo, "hi": hi})
            bag["size"] = torch.where(hi > lo, bag["size"], 0)
        else:
            bag = tb.push_one(bag, {"lo": torch.zeros_like(p),
                                    "hi": torch.full_like(p, n)})
            bag["size"] = torch.where(p == 0, bag["size"], 0)
        z = lambda dt, v=0: torch.full((P, n), v, dtype=dt, device=device)
        state = {
            "bc": z(torch.float32),
            "cur": torch.full((P,), -1, dtype=torch.int32, device=device),
            "phase": torch.zeros((P,), dtype=torch.int32, device=device),
            "level": torch.zeros((P,), dtype=torch.int32, device=device),
            "dist": z(torch.int32, -1),
            "sigma": z(torch.float32),
            "delta": z(torch.float32),
        }
        return state, bag

    def process(state, bag, budget: int, mask):
        dev = bag["size"].device
        if dev not in adj_dev:
            adj_dev[dev] = torch.as_tensor(adj_np, device=dev)
        A = adj_dev[dev]
        verts = torch.arange(n, device=dev)[None, :]

        def start_vertex(st, act):
            _, item = tb.pop_tail(bag, act)
            v = item["lo"]
            rest = {"lo": (item["lo"] + 1)[:, None],
                    "hi": item["hi"][:, None]}
            tb.push_block(bag, rest, act & (item["hi"] - item["lo"] > 1))
            src = verts == v[:, None]
            return dict(
                st,
                cur=v,
                phase=torch.zeros_like(v),
                level=torch.zeros_like(v),
                dist=torch.where(src, 0, -1).to(torch.int32),
                sigma=src.to(torch.float32),
                delta=torch.zeros_like(st["delta"]),
            )

        def forward_sweep(st):
            level = st["level"][:, None]
            frontier = (st["dist"] == level).to(torch.float32)
            reach = (st["sigma"] * frontier) @ A       # contributions to dst
            new = (st["dist"] < 0) & (reach > 0)
            any_new = new.any(dim=1)
            return dict(
                st,
                dist=torch.where(new, level + 1, st["dist"]),
                sigma=st["sigma"] + reach * new,
                level=torch.where(any_new, st["level"] + 1, st["level"]),
                phase=(~any_new).to(torch.int32),
            )

        def backward_sweep(st):
            # Predecessor accumulation from depth `level` to `level - 1`.
            level = st["level"][:, None]
            at_l = (st["dist"] == level).to(torch.float32)
            coef = torch.where(
                at_l > 0,
                (1.0 + st["delta"]) / torch.clamp(st["sigma"], min=1e-30),
                0.0)
            contrib = coef @ A.T                        # sum over successors
            at_prev = (st["dist"] == level - 1).to(torch.float32)
            delta = st["delta"] + st["sigma"] * contrib * at_prev
            lvl = st["level"] - 1
            finished = lvl <= 0
            own = verts == st["cur"][:, None]           # exclude the source
            fin = finished[:, None]
            return dict(
                st,
                delta=torch.where(fin, 0.0, delta),
                level=torch.where(finished, 0, lvl),
                bc=torch.where(fin, st["bc"] + torch.where(own, 0.0, delta),
                               st["bc"]),
                cur=torch.where(finished, -1, st["cur"]),
                phase=torch.where(finished, 0, st["phase"]),
            )

        # left is 0 outside the mask from the start and only falls, so
        # left > 0 implies the mask.
        def cond(left):
            has_work = (state["cur"] >= 0) | (bag["size"] > 0)
            return (left > 0) & has_work

        def body(left, act):
            nonlocal state
            need_start = act & (state["cur"] < 0)
            s = _sel(need_start, start_vertex(state, need_start), state)
            s2 = _sel(s["phase"] == 0, forward_sweep(s), backward_sweep(s))
            state = _sel(act, s2, s)
            return left - act.to(torch.int32)

        left0 = torch.where(mask, budget, 0).to(torch.int32)
        with _f32_matmul():
            left = masked_while(cond, body, left0, budget)
        return state, bag, left0 - left

    def split(bag, k: int, mask):
        blk = tb.read_front(bag, k)
        kk = blk["lo"].shape[1]
        lane = torch.arange(kk, dtype=torch.int32, device=mask.device)
        in_bag = lane[None, :] < torch.clamp(bag["size"], max=k)[:, None]
        c = blk["hi"] - blk["lo"]
        splittable = in_bag & (c >= 2)
        mid = blk["lo"] + (c + 1) // 2
        keep = dict(blk, hi=torch.where(splittable, mid, blk["hi"]))
        tb.write_front(bag, keep, mask)
        items, count = tb.compact_block({"lo": mid, "hi": blk["hi"]},
                                        splittable)
        return bag, {"items": items, "count": torch.where(mask, count, 0)}

    def evacuate(state, bag, mask):
        # Crash recovery: re-bag the in-progress source vertex as a width-1
        # interval and reset the sweep. Exact, because ``bc`` only
        # accumulates when a backward sweep FINISHES — a restarted vertex
        # recomputes from scratch on the survivor and contributes once.
        cur = state["cur"]
        v = cur.clamp(min=0)
        tb.push_block(bag, {"lo": v[:, None], "hi": (v + 1)[:, None]},
                      mask & (cur >= 0))
        state = dict(state,
                     cur=torch.where(mask, -1, cur),
                     phase=torch.where(mask, 0, state["phase"]),
                     level=torch.where(mask, 0, state["level"]))
        return state, bag

    return GLBProblem(
        name=f"bc-n{n}",
        item_spec=ITEM_SPEC,
        capacity=capacity,
        init_place=init_place,
        process=process,
        split=split,
        merge=tb.merge_packet,
        result=lambda st: st["bc"],
        reduce_op="sum",
        work_in_state=lambda st: (st["cur"] >= 0).to(torch.int32),
        evacuate=evacuate,
    )
