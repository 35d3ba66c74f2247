"""Distributed GLB executor — one place per process, collectives between
them. The counterpart of ``repro.core.executor``.

Same superstep semantics as ``scheduler.run_sim`` (held equal in tests),
in the per-place view with explicit collectives over the process group of
one mesh dimension (``dist.collectives``), which is the paper's own
setting: places are processes.

  sizes    : ``all_gather`` of one (size, in-state work) pair per place
             (the steal requests);
  matching : replicated-deterministic: ``match_steals`` on the host, on
             the gathered pairs and ``candidates(step, P, w)``, identical
             on every rank;
  packets  : one tiled ``all_to_all`` of a (P, K, item) buffer per item
             field (``dense``; every unmatched row is zeros), or one
             masked ``ppermute`` per lifeline dimension plus the dense
             buffer for random-round steals only (``lifeline``; with
             w == 0 the dense buffer disappears);
  result   : ``psum`` / ``pmax`` / ``pmin`` — the paper's ``reduce()``.

The port's ``GLBProblem`` is batched over places, so a rank runs its place
as a batch of one: row ``me`` of ``init_place(P, device)`` (every leaf of
state and bag, ``size`` included; UTS puts its root at place 0 only, and
BC partitions its sources by place), then ``process`` / ``split`` /
``merge`` on that row with ``mask=[True]``. Every rank leaves the loop at
the same superstep: the termination test reads only gathered values.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dist import collectives as C
from .lifeline import lifeline_buddies, match_steals, random_candidates
from .params import GLBParams
from .problem import GLBProblem
from .stats import FIELDS, init_stats, update_stats

PHASES = ("process", "gather", "match", "route", "merge")
ROUTINGS = ("dense", "lifeline")


class GLBDistRun(NamedTuple):
    result: Any                      # reduced result, on every rank
    per_place: Any                   # per-place results, leading P axis
    stats: Dict[str, Any]            # per-place counters, leading P axis
    supersteps: int
    converged: bool                  # False only if max_supersteps hit
    host_ms: Optional[Dict[str, float]] = None   # this rank's host clock
                                                 # per phase (PHASES),
                                                 # summed over supersteps
    wire_bytes: int = 0              # bytes this rank handed to the
                                     # superstep loop's collectives


def _row(tree, me: int):
    """Row ``me`` of every leaf (leading P axis), as a batch of one."""
    if isinstance(tree, dict):
        return {k: _row(v, me) for k, v in tree.items()}
    return tree[me:me + 1].clone()


def _route_dense(packet, dst_mine: int, src_mine: int, give: bool, group,
                 P: int):
    """Baseline routing: (P, K, item) all_to_all, zeros off the matched
    row."""
    dstc = min(max(dst_mine, 0), P - 1)
    srcc = min(max(src_mine, 0), P - 1)
    items = {}
    for k, v in packet["items"].items():                # (1, K, ...)
        buf = torch.zeros((P,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        if give:
            buf[dstc] = v[0]
        items[k] = C.all_to_all(buf, group)[srcc:srcc + 1]
    count = packet["count"]
    buf = torch.zeros((P,), dtype=count.dtype, device=count.device)
    if give:
        buf[dstc] = count[0]
    got = C.all_to_all(buf, group)[srcc:srcc + 1]
    return {"items": items,
            "count": got if src_mine >= 0 else torch.zeros_like(got)}


def _route_lifeline_split(packet_ll, packet_rd, m, me: int, give_ll: bool,
                          give_rd: bool, group, P: int, z: int):
    """Lifeline steals travel along a static edge: thief t's buddy i sits
    at (t + 2^i) mod P, so the packet hops exactly -2^i. One masked
    ``ppermute`` per lifeline dimension routes all lifeline traffic
    (in-degree one per dimension); every rank sends on every dimension,
    zeros where it gives nothing. Only random-round steals keep the dense
    all_to_all, over their own packet."""
    t_of_me = int(m.dst[me])                  # thief I serve (-1 none)
    dim_dist = (me - t_of_me) % P             # lifeline jump if serving one
    src_me = int(m.src[me])
    i_receive_ll = src_me >= 0 and bool(m.via_lifeline[me])
    keys = list(packet_ll["items"])
    sends = [packet_ll["items"][k] for k in keys] + [packet_ll["count"]]
    acc = [torch.zeros_like(v) for v in sends]

    for i in range(z):
        # z <= ceil(log2 P) keeps every jump 2^i < P, so jumps are distinct
        # and a receiver has in-degree exactly one per dimension.
        perm = [(p, (p - (1 << i)) % P) for p in range(P)]
        send_i = give_ll and dim_dist == (1 << i)
        got = C.ppermute([v if send_i else torch.zeros_like(v)
                          for v in sends], perm, group)
        # My buddy i is (me + 2^i); it sent iff it serves me via a lifeline.
        if i_receive_ll and src_me == (me + (1 << i)) % P:
            acc = [a + g for a, g in zip(acc, got)]
    inpkt_ll = {"items": dict(zip(keys, acc[:-1])), "count": acc[-1]}

    if packet_rd is None:  # pure-lifeline mode (w == 0)
        return inpkt_ll, None
    # Random-round remainder via the dense buffer, narrow packet.
    src_rd = -1 if bool(m.via_lifeline[me]) else src_me
    inpkt_rd = _route_dense(packet_rd, t_of_me, src_rd, give_rd, group, P)
    return inpkt_ll, inpkt_rd


def build_place_fn(problem: GLBProblem, mesh, params: GLBParams,
                   axis: str = "place", routing: str = "dense",
                   device="cuda") -> Callable[..., GLBDistRun]:
    """This rank's GLB loop over the ``axis`` dimension of ``mesh`` (a
    ``DeviceMesh``); call the returned ``place_fn(seed=0,
    candidates=None)`` on every rank of that dimension. ``candidates``
    is ``run_sim``'s hook, by default ``np.random.default_rng([seed,
    step])``'s draws; it must give every rank the same victims."""
    dev = resolve_device(device)
    if routing not in ROUTINGS:
        raise ValueError(f"unknown routing {routing!r}")
    group = mesh.get_group(axis)
    P = C.size(group)
    me = C.rank(group)
    z = params.resolve_z(P)
    bud = lifeline_buddies(P, z)
    max_steps = params.max_supersteps
    one = torch.ones((1,), dtype=torch.bool, device=dev)

    def place_fn(seed: int = 0, candidates=None) -> GLBDistRun:
        if candidates is None:
            candidates = lambda step, P, w: random_candidates(
                np.random.default_rng([seed, step]), P, w)
        state, bag = problem.init_place(P, dev)
        state, bag = _row(state, me), _row(bag, me)
        stats = init_stats(1, dev)
        pending = np.zeros((P, P), bool)
        host_ms = dict.fromkeys(PHASES, 0.0)
        wire0 = sum(C.wire_bytes().values())
        step, done = 0, False

        while not done and step < max_steps:
            t0 = time.perf_counter()
            state, bag, processed = problem.process(state, bag, params.n,
                                                    one)
            t1 = time.perf_counter()
            # One gather carries both the stealable size and in-progress
            # work.
            if problem.work_in_state is not None:
                my_pend = problem.work_in_state(state).to(torch.int32)
            else:
                my_pend = torch.zeros_like(bag["size"])
            gathered = C.all_gather(torch.cat([bag["size"], my_pend]),
                                    group).cpu().numpy()
            sizes, pend = gathered[:, 0], gathered[:, 1]
            t2 = time.perf_counter()
            hungry_all = (sizes + pend) == 0
            m = match_steals(sizes, hungry_all, pending,
                             candidates(step, P, params.w), bud, params)
            t3 = time.perf_counter()

            thief = int(m.dst[me])
            give = thief >= 0
            mask = lambda b: torch.full((1,), b, dtype=torch.bool,
                                        device=dev)
            if routing == "dense":
                bag, packet = problem.split(bag, params.steal_k, mask(give))
                sent = packet["count"]
                inpkt = _route_dense(packet, thief, int(m.src[me]), give,
                                     group, P)
                t4 = time.perf_counter()
                bag = problem.merge(bag, inpkt)
                recv = inpkt["count"]
            else:
                k_rand = params.steal_k_random or params.steal_k
                thief_c = min(max(thief, 0), P - 1)
                give_ll = give and bool(m.via_lifeline[thief_c])
                give_rd = give and not bool(m.via_lifeline[thief_c])
                # The two splits are exclusive: a masked-off split leaves
                # the bag as it was and gives count 0.
                bag, packet_ll = problem.split(bag, params.steal_k,
                                               mask(give_ll))
                if params.w == 0:
                    # pure-lifeline mode: every steal is single-hop static
                    # and the dense dynamic-routing buffer disappears
                    sent = packet_ll["count"]
                    inpkt_ll, _ = _route_lifeline_split(
                        packet_ll, None, m, me, give_ll, False, group, P, z)
                    t4 = time.perf_counter()
                    bag = problem.merge(bag, inpkt_ll)
                    recv = inpkt_ll["count"]
                else:
                    bag, packet_rd = problem.split(bag, k_rand,
                                                   mask(give_rd))
                    sent = packet_ll["count"] + packet_rd["count"]
                    inpkt_ll, inpkt_rd = _route_lifeline_split(
                        packet_ll, packet_rd, m, me, give_ll, give_rd,
                        group, P, z)
                    t4 = time.perf_counter()
                    bag = problem.merge(problem.merge(bag, inpkt_ll),
                                        inpkt_rd)
                    recv = inpkt_ll["count"] + inpkt_rd["count"]

            # If no work existed post-process, none was transferred either
            # (victims need size > 0), so this is exact.
            done = int(sizes.sum() + pend.sum()) == 0
            flags = torch.as_tensor(np.asarray([
                m.src[me], m.dst[me], m.via_lifeline[me], hungry_all[me],
                (m.pending[me] & ~pending[me]).any()], np.int32)).to(dev)
            stats = update_stats(
                stats, processed=processed, hungry=flags[3:4] > 0,
                src=flags[0:1], via_lifeline=flags[2:3] > 0,
                dst=flags[1:2], sent=sent, recv=recv,
                registered=flags[4:5] > 0, sizes=bag["size"])
            pending = m.pending
            step += 1
            t5 = time.perf_counter()
            for name, dt in zip(PHASES, (t1 - t0, t2 - t1, t3 - t2,
                                         t4 - t3, t5 - t4)):
                host_ms[name] += dt * 1e3
        wire = sum(C.wire_bytes().values()) - wire0

        local = problem.result(state)[0]
        if problem.reduce_op not in C.REDUCE:
            raise ValueError(problem.reduce_op)
        result = C.REDUCE[problem.reduce_op](local, group)
        per_place = C.all_gather(local, group)
        counters = C.all_gather(torch.stack([stats[f][0] for f in FIELDS]),
                                group)
        return GLBDistRun(
            result=result,
            per_place=per_place,
            stats={f: counters[:, i] for i, f in enumerate(FIELDS)},
            supersteps=step,
            converged=done,
            host_ms=host_ms,
            wire_bytes=wire,
        )

    return place_fn


def run_shardmap(
    problem: GLBProblem,
    mesh,
    params: GLBParams = GLBParams(),
    seed: int = 0,
    axis: str = "place",
    routing: str = "dense",
    candidates=None,
    device="cuda",
) -> GLBDistRun:
    """Run ``problem`` with one place per rank of ``mesh``'s ``axis``
    dimension; every rank of it calls this with the same arguments and
    gets the same result, counters and supersteps."""
    return build_place_fn(problem, mesh, params, axis, routing,
                          device)(seed, candidates)
