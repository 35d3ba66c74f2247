"""Global-view GLB superstep scheduler (simulated places). The counterpart
of ``repro.core.scheduler``.

Runs P *virtual places* on one device: every per-place tensor carries a
leading P axis, the problem's callables work on all places at once
(``core.problem``), and the balance phase is plain indexing.

One superstep (DESIGN.md §2 maps X10 onto it):
  1. every place runs ``process(n)``           (paper: work between probes)
  2. bag sizes are gathered to the host        (paper: steal requests)
  3. deterministic matching pairs thieves/victims (random + lifeline rounds)
  4. victims ``split``, packets routed, thieves ``merge``
  5. global termination check (sum of sizes == 0)

The loop over supersteps runs on the host. Per superstep one
device-to-host copy brings the bag sizes (and the in-state work) to the
numpy matching of ``core.lifeline``, and one host-to-device copy brings
the matching back; process, split, routing, merge and the counters stay
on the device. The JAX package's untraced run is one jitted
``lax.while_loop``; its traced and faulted runs are host loops of the same
body. This loop is all three, with the same results.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import taskbag as tb
from .lifeline import (lifeline_buddies, match_steals, random_candidates,
                       rewire_lifelines)
from .params import GLBParams
from .problem import GLBProblem
from .stats import init_stats, update_stats

PHASES = ("process", "match", "transfer")


class GLBRun(NamedTuple):
    result: Any                      # reduced result (the paper's `reduce()`)
    per_place: Any                   # per-place results, leading P axis
    stats: Dict[str, Any]            # per-place counters, leading P axis
    supersteps: int
    converged: bool                  # False only if max_supersteps hit
    host_ms: Optional[Dict[str, float]] = None   # host clock per phase
                                                 # (PHASES), summed over
                                                 # supersteps


def reduce_result(per_place: Any, op: str) -> Any:
    if op == "sum":
        return per_place.sum(dim=0)
    if op == "max":
        return per_place.max(dim=0).values
    if op == "min":
        return per_place.min(dim=0).values
    raise ValueError(f"unknown reduce op {op!r}")


def _place(bag, p: int):
    """Place p's bag as a one-place bag whose items are views."""
    return {"items": {k: v[p:p + 1] for k, v in bag["items"].items()},
            "size": bag["size"][p:p + 1].clone()}


def run_sim(
    problem: GLBProblem,
    P: int,
    params: GLBParams = GLBParams(),
    seed: int = 0,
    max_supersteps: Optional[int] = None,
    tracer=None,
    faults=None,
    candidates: Optional[Callable[[int, int, int], Any]] = None,
    device="cuda",
) -> GLBRun:
    """Execute ``problem`` on P simulated places of ``device`` (CUDA unless
    asked otherwise; asking for CUDA without a card raises).

    ``candidates(step, P, w)`` gives the random round's (P, w) victims at
    superstep ``step``; by default they come from
    ``np.random.default_rng([seed, step])``. The JAX package draws them
    from ``fold_in(key(seed), step)``, which numpy cannot replay: a parity
    test passes those draws in here.

    With an enabled ``tracer`` (``repro_torch.obs.Tracer``) each superstep
    emits one ``superstep`` span and a ``glb_load`` counter (one more
    device-to-host copy each); results are unchanged.

    With a ``faults`` injector (``repro_torch.serve.faults.FaultInjector``)
    the loop also runs the failure protocol: per superstep each place is
    asked for a heartbeat; a place missing ``params.heartbeat_misses``
    consecutive gathers is declared dead — its in-state work is evacuated
    back into its bag (``problem.evacuate``), the bag is drained wholesale
    into the survivors with the most headroom, its pending rows/columns
    are cleared, and the lifeline table is rebuilt over the survivors
    (``rewire_lifelines``). Faulted-but-undeclared places are frozen (not
    processed, not matched): their unchanged bag size keeps termination
    from firing while they hold work. Accumulated per-place results
    survive a death."""
    dev = resolve_device(device)
    z = params.resolve_z(P)
    max_steps = max_supersteps or params.max_supersteps
    if faults is not None and problem.work_in_state is not None \
            and problem.evacuate is None:
        raise ValueError(
            f"problem {problem.name!r} holds in-state work but defines "
            f"no evacuate hook; its mid-item window is not survivable"
        )
    if candidates is None:
        candidates = lambda step, P, w: random_candidates(
            np.random.default_rng([seed, step]), P, w)
    traced = tracer is not None and getattr(tracer, "enabled", False)
    if traced:
        tracer.process_name(0, f"GLB sim ({P} places)")
        tracer.thread_name(0, 0, "supersteps")

    state, bag = problem.init_place(P, dev)
    stats = init_stats(P, dev)
    pending = np.zeros((P, P), bool)
    bud = lifeline_buddies(P, z)
    alive = np.ones(P, bool)
    misses = np.zeros(P, np.int32)
    ones = np.ones(P, bool)
    host_ms = dict.fromkeys(PHASES, 0.0)
    step, done = 0, False

    def on_death(state, bag, p):
        """Failure recovery for place p (host-driven; deaths are rare):
        evacuate in-state work, drain the bag wholesale into the
        survivors with the most headroom. Whole ITEMS move (the generic
        tail split), never problem.split — interval-halving can refuse
        single-child items, which would strand work on a corpse."""
        if problem.evacuate is not None:
            state, bag = problem.evacuate(
                state, bag, torch.arange(P, device=dev) == p)
        moved = 0
        while True:
            sizes = bag["size"].cpu().numpy()
            if sizes[p] == 0:
                break
            surv = np.flatnonzero(alive)
            tgt = int(surv[np.argmin(sizes[surv])])
            take = min((int(sizes[p]) + 1) // 2, params.steal_k)
            if int(sizes[tgt]) + take > problem.capacity:
                raise RuntimeError(
                    f"place {p} died with {int(sizes[p])} items but no "
                    f"survivor has headroom for a {take}-item packet"
                )
            bag_p, pkt = tb.split_tail_half(_place(bag, p), params.steal_k)
            bag_t = problem.merge(_place(bag, tgt), pkt)
            size = bag["size"].clone()
            size[p], size[tgt] = bag_p["size"][0], bag_t["size"][0]
            bag["size"] = size
            moved += int(pkt["count"][0])
        pending[p, :] = False
        pending[:, p] = False
        if traced:
            tracer.instant("bag_recovered", pid=0,
                           args={"place": p, "items": moved})
        return state, bag

    while not done and step < max_steps:
        proc, active = ones, ones
        if faults is not None:
            faults.begin_superstep(step)
            for p in range(P):
                if not alive[p]:
                    continue
                if faults.responsive(p):
                    misses[p] = 0
                    continue
                misses[p] += 1
                if misses[p] >= params.heartbeat_misses:
                    alive[p] = False
                    misses[p] = 0
                    if not alive.any():
                        raise RuntimeError("every place has died")
                    if traced:
                        tracer.instant(
                            "place_dead", pid=0,
                            args={"place": p, "superstep": step,
                                  "window": params.heartbeat_misses},
                        )
                    state, bag = on_death(state, bag, p)
                    bud = rewire_lifelines(alive, z)
            proc = alive & np.asarray(
                [faults.should_step(p) for p in range(P)])
            active = alive & np.asarray(
                [faults.responsive(p) for p in range(P)])
        span = (tracer.span("superstep", pid=0, args={"n": step})
                if traced else contextlib.nullcontext())
        with span:
            # 1. process (frozen places keep their state and bag)
            t0 = time.perf_counter()
            state, bag, processed = problem.process(
                state, bag, params.n, torch.as_tensor(proc, device=dev))
            t1 = time.perf_counter()
            # 2-3. gather the loads, match thieves to victims on the host.
            # In-progress, non-stealable work held in state (paper §2.6)
            # counts for hunger and termination.
            if problem.work_in_state is not None:
                pend_d = problem.work_in_state(state).to(torch.int32)
            else:
                pend_d = torch.zeros_like(bag["size"])
            sizes, pend = torch.stack([bag["size"], pend_d]).cpu().numpy()
            # Dead/unresponsive places neither give nor take this round,
            # but their (frozen) work still blocks termination below.
            hungry = ((sizes + pend) == 0) & active
            m = match_steals(np.where(active, sizes, 0), hungry, pending,
                             candidates(step, P, params.w), bud, params)
            registered = (m.pending & ~pending).any(axis=1)
            host = torch.as_tensor(np.stack([
                m.src, m.dst, m.via_lifeline, hungry, registered,
            ]).astype(np.int32)).to(dev)
            src, dst = host[0], host[1]
            t2 = time.perf_counter()
            # 4. transfer: victims split, packets routed, thieves merge
            bag, packets = problem.split(bag, params.steal_k, dst >= 0)
            srcc = src.clamp(0, P - 1).to(torch.int64)
            recv = {"items": {k: v[srcc]
                              for k, v in packets["items"].items()},
                    "count": torch.where(src >= 0, packets["count"][srcc],
                                         0)}
            bag = problem.merge(bag, recv)
            # 5. termination: if no work existed post-process, none was
            # transferred either (victims need size > 0), so this is exact.
            done = int(sizes.sum() + pend.sum()) == 0
            stats = update_stats(
                stats,
                processed=processed,
                hungry=host[3] > 0,
                src=src,
                via_lifeline=host[2] > 0,
                dst=dst,
                sent=packets["count"],
                recv=recv["count"],
                registered=host[4] > 0,
                sizes=bag["size"],
            )
            pending = m.pending
            step += 1
            t3 = time.perf_counter()
            for name, dt in zip(PHASES, (t1 - t0, t2 - t1, t3 - t2)):
                host_ms[name] += dt * 1e3
            if traced:
                sizes = bag["size"].cpu().numpy()
                vals = {"total": float(sizes.sum()),
                        "hungry": float((sizes == 0).sum())}
                if P <= 16:
                    vals.update({f"place{i}": float(v)
                                 for i, v in enumerate(sizes)})
                tracer.counter("glb_load", vals, pid=0)

    per_place = problem.result(state)
    return GLBRun(
        result=reduce_result(per_place, problem.reduce_op),
        per_place=per_place,
        stats=stats,
        supersteps=step,
        converged=done,
        host_ms=host_ms,
    )
