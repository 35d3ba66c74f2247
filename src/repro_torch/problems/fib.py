"""Naive recursive Fibonacci as a GLB problem — the paper's appendix
example. The counterpart of ``repro.problems.fib``.

A task is an integer i. Processing pops the newest task (the X10 code's
``removeLast``): i < 2 adds i to the local result; otherwise tasks i-1 and
i-2 are pushed. The bag is the paper's default ArrayList bag (split = half
off the end). The root task lives at place 0 (``init`` at the root place).
"""
from __future__ import annotations

import torch

from ..core import taskbag as tb
from ..core.problem import GLBProblem, masked_while

ITEM_SPEC = {"n": ((), torch.int32)}


def fib_problem(n: int, capacity: int = 4096) -> GLBProblem:
    def init_place(P, device):
        bag = tb.make_bag(ITEM_SPEC, capacity, P, device)
        bag = tb.push_one(bag, {"n": torch.full((P,), n, dtype=torch.int32,
                                                device=device)})
        first = torch.arange(P, device=device) == 0
        bag["size"] = torch.where(first, bag["size"], 0)  # root at place 0
        state = {"result": torch.zeros((P,), dtype=torch.int32,
                                       device=device)}
        return state, bag

    def process(state, bag, budget: int, mask):
        result = state["result"]

        # left is 0 outside the mask from the start and only falls, so
        # left > 0 implies the mask.
        def cond(left):
            size = bag["size"]
            return (left > 0) & (size > 0) & (size + 2 <= capacity)

        def body(left, act):
            nonlocal result
            _, item = tb.pop_tail(bag, act)
            x = item["n"]
            leaf = x < 2
            result = result + torch.where(act & leaf, x, 0)
            block = {"n": torch.stack([x - 1, x - 2], dim=1)}
            tb.push_block(bag, block, torch.where(act & ~leaf, 2, 0))
            return left - act.to(torch.int32)

        left0 = torch.where(mask, budget, 0).to(torch.int32)
        left = masked_while(cond, body, left0, budget)
        return {"result": result}, bag, left0 - left

    def split(bag, k: int, mask):
        return tb.split_tail_half(bag, k, mask)

    return GLBProblem(
        name="fib",
        item_spec=ITEM_SPEC,
        capacity=capacity,
        init_place=init_place,
        process=process,
        split=split,
        merge=tb.merge_packet,
        result=lambda st: st["result"],
        reduce_op="sum",
    )


def fib_oracle(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a
