"""The GLB user contract — the paper's TaskQueue/TaskBag interface (§2.3).
The counterpart of ``repro.core.problem``.

The paper asks users for sequential pieces of code:
  process(n)  — compute up to n task items, return whether work remains;
  split()     — give away part of the bag (None if too small);
  merge(tb)   — absorb an incoming bag;
  getResult() — local result;
  reduce()    — associative+commutative reduction across places;
plus an optional ``init`` that seeds the root task at place 0.

The JAX package writes these for ONE place and ``vmap``s them over the P
simulated places. PyTorch has no ``vmap`` over data-dependent loops, so
here the batching is explicit: every callable takes and returns the state
and bag of all P places (tensors with a leading P axis, see
``core.taskbag``), and a (P,) bool ``mask`` says which places the call may
change. ``vmap`` of a ``lax.while_loop`` runs the body for every place
while ANY place's condition holds and keeps the carry of the others
unchanged; ``masked_while`` below is that loop written out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .taskbag import ItemSpec

State = Any
Bag = Dict[str, Any]
Packet = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GLBProblem:
    """A GLB-schedulable problem over P places at once.

    init_place(P, device)        -> (state, bag) of all P places.
                                    Root-style problems put the root task
                                    at place 0; statically-partitionable
                                    problems pre-split.
    process(state, bag, n, mask) -> (state, bag, processed (P,) i32).
                                    Each place in ``mask`` handles at most
                                    n work units; the others are left
                                    untouched and report 0. Must be a
                                    no-op on an empty bag.
    split(bag, K, mask)          -> (bag, packet). Each place in ``mask``
                                    gives <= K items (count 0: the paper's
                                    ``split() == null``); the others give
                                    nothing and keep their bag.
    merge(bag, packet)           -> bag. A no-op where count == 0.
    result(state)                -> per-place results (leading P axis),
                                    reduced across places.
    reduce_op                    — 'sum' | 'max' | 'min' (assoc.+comm.).
    capacity                     — bag capacity incl. slack for one packet.
    work_in_state(state)         -> (P,) i32 in-progress, non-stealable
                                    work held in ``state`` (the paper's
                                    §2.6 interruptable state machine
                                    mid-vertex). Counted for hunger and
                                    termination, but not stealable.
    evacuate(state, bag, mask)   -> (state, bag). Crash recovery: push the
                                    in-progress work of the places in
                                    ``mask`` back into their bags and
                                    leave their work_in_state at 0.
                                    Required for fault injection whenever
                                    work_in_state is set.

    State and bag tensors are updated in place; the returned objects are
    the ones to use afterwards.
    """

    name: str
    item_spec: ItemSpec
    capacity: int
    init_place: Callable[[int, torch.device], Tuple[State, Bag]]
    process: Callable[[State, Bag, int, torch.Tensor],
                      Tuple[State, Bag, torch.Tensor]]
    split: Callable[[Bag, int, torch.Tensor], Tuple[Bag, Packet]]
    merge: Callable[[Bag, Packet], Bag]
    result: Callable[[State], Any]
    reduce_op: str = "sum"
    work_in_state: Optional[Callable[[State], torch.Tensor]] = None
    evacuate: Optional[Callable[[State, Bag, torch.Tensor],
                                Tuple[State, Bag]]] = None


def masked_while(cond: Callable[[Any], torch.Tensor],
                 body: Callable[[Any, torch.Tensor], Any], carry: Any,
                 max_iters: int) -> Any:
    """``vmap(lax.while_loop)`` over places, written out: while any place's
    ``cond(carry)`` ((P,) bool) holds, ``body(carry, active)`` advances
    the active places and must leave the others unchanged. A place that
    falls out never comes back (its carry no longer changes), so the
    result equals P independent loops.

    ``max_iters`` bounds the loop: it is the budget n of ``process``, and
    every iteration consumes at least one unit of every active place's
    budget. One host read of "any place active" per iteration ends the
    loop early."""
    for _ in range(max_iters):
        active = cond(carry)
        if not bool(active.any()):
            break
        carry = body(carry, active)
    return carry
