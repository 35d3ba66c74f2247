"""The port's copies of the host-side serving modules (``serve.kvpool``,
``serve.radix``, ``serve.scheduler``) against ``repro``'s: the same
sequence of operations must give equal block tables, refcounts, stats,
prefix-cache results and step plans in both packages."""
import dataclasses
from collections import deque

import numpy as np

from repro.serve.kvpool import KVPool as JPool
from repro.serve.kvpool import PoolExhausted as JExhausted
from repro.serve.radix import RadixPrefixCache as JRadix
from repro.serve.scheduler import ContinuousBatchingScheduler as JSched
from repro_torch.serve.kvpool import KVPool as TPool
from repro_torch.serve.kvpool import PoolExhausted as TExhausted
from repro_torch.serve.radix import RadixPrefixCache as TRadix
from repro_torch.serve.scheduler import ContinuousBatchingScheduler as TSched


def _pool_state(pool, rids):
    return ([pool.block_table(r) if pool.has_seq(r) else None
             for r in rids],
            [pool.refcount(b) for b in range(pool.num_blocks)],
            pool.free_blocks, pool.cached_blocks, pool.available_blocks,
            dataclasses.astuple(pool.stats()))


def test_kvpool_and_radix_same_operation_sequence():
    """Random alloc / reserve / advance / fork / free / cache insert and
    probe sequence, replayed on both packages step by step."""
    rng = np.random.default_rng(0)
    sides = []
    for Pool, Radix in ((JPool, JRadix), (TPool, TRadix)):
        pool = Pool(24, 4)
        sides.append((pool, Radix(pool)))
    live, toks, nxt = [], {}, 0
    for _ in range(300):
        op = rng.integers(0, 5)
        outs = []
        if op == 0 or not live:                     # admit, maybe a hit
            base = [1, 2, 3, 4, 5, 6, 7, 8][: rng.integers(0, 9)]
            t = base + [int(x) for x in rng.integers(9, 50, rng.integers(
                1, 9))]
            rid = nxt
            nxt += 1
            for pool, cache in sides:
                try:
                    if cache.probe(t)[0] > 0:
                        hit = cache.fork(rid, t)
                    else:
                        hit = 0
                        pool.alloc(rid, len(t))
                    outs.append(("ok", hit, pool.reserve(rid, len(t) + 2)))
                except (JExhausted, TExhausted):
                    if pool.has_seq(rid):
                        pool.free(rid)
                    outs.append(("full",))
            if outs[0][0] == "ok":
                live.append(rid)
                toks[rid] = t
                for pool, _ in sides:
                    pool.advance(rid, len(t))
        elif op in (1, 2):                          # grow a live seq
            rid = live[rng.integers(0, len(live))]
            target = len(toks[rid]) + int(rng.integers(1, 6))
            for pool, _ in sides:
                try:
                    outs.append(pool.reserve(rid, target))
                    pool.advance(rid, target)
                except (JExhausted, TExhausted):
                    outs.append("full")
            if outs[0] != "full":
                toks[rid] = toks[rid] + [int(x) for x in rng.integers(
                    9, 50, target - len(toks[rid]))]
        else:                                       # finish: cache + free
            rid = live.pop(rng.integers(0, len(live)))
            for pool, cache in sides:
                cache.insert(toks[rid], pool.block_table(rid),
                             len(toks[rid]))
                pool.free(rid)
                outs.append((cache.hits, cache.misses, cache.evictions))
        assert outs[0] == outs[1], (op, outs)
        rids = list(range(nxt))
        assert _pool_state(sides[0][0], rids) == _pool_state(
            sides[1][0], rids)


class _Req:
    def __init__(self, rid, prompt, max_new):
        self.rid, self.prompt, self.max_new = rid, prompt, max_new
        self.out, self.t_queued = [], 0.0


def test_scheduler_same_plans():
    """Drive both schedulers through admission, chunked prefill, decode
    reservation, watermark preemption and release with the same queue
    and step lengths; every StepPlan must be equal."""
    rng = np.random.default_rng(1)
    scheds = []
    for Pool, Radix, Sched in ((JPool, JRadix, JSched),
                               (TPool, TRadix, TSched)):
        pool = Pool(11, 4)
        scheds.append(Sched(pool, 3, lookahead=4, max_seq=40,
                            watermark_blocks=2, token_budget=12,
                            prefill_chunk=5, cache=Radix(pool)))
    prompts = [[1, 2, 3] + [int(x) for x in rng.integers(
        4, 30, rng.integers(2, 14))] for _ in range(8)]
    reqs = [[_Req(i, p, 24) for i, p in enumerate(prompts)] for _ in (0, 1)]
    queues = [deque(r) for r in reqs]
    slots = [[None] * 3, [None] * 3]
    lens = [np.full(3, -1, np.int32), np.full(3, -1, np.int32)]
    prefix = lambda r: list(r.prompt) + list(r.out[:-1])
    for step in range(200):
        plans = [s.plan_step(q, sl, ln, prefix)
                 for s, q, sl, ln in zip(scheds, queues, slots, lens)]
        a, b = plans
        key = lambda p: (
            [(s, r.rid) for s, r in p.admit],
            [(s, r.rid, st, e, la) for s, r, st, e, la in p.prefill],
            [(s, r.rid) for s, r in p.preempted], p.copies,
            p.active.tolist(), p.granted.tolist(), p.quota.tolist())
        assert key(a) == key(b), step
        for s, q, sl, ln, plan in zip(scheds, queues, slots, lens, plans):
            for slot, _ in plan.preempted:
                ln[slot] = -1
            for slot, r, st, e, last in plan.prefill:
                s.pool.advance(r.rid, e)
                ln[slot] = e
            for i, r in enumerate(sl):
                if r is None or s.mid_prefill(i) or not plan.active[i]:
                    continue
                n = min(int(plan.quota[i]), int(plan.granted[i] - ln[i]))
                ln[i] += n
                r.out.extend([7] * n)
                s.pool.advance(r.rid, int(ln[i]))
                if len(r.out) >= r.max_new:
                    s.cache.insert(prefix(r)[: int(ln[i])],
                                   s.pool.block_table(r.rid), int(ln[i]))
                    s.release(r.rid)
                    s.slot_released(i)
                    sl[i] = None
                    ln[i] = -1
        if not any(queues[0]) and all(x is None for x in slots[0]):
            break
    assert (scheds[0].admissions, scheds[0].preemptions,
            scheds[0].chunks_scheduled) == (
        scheds[1].admissions, scheds[1].preemptions,
        scheds[1].chunks_scheduled)
    # the run exercised every path: re-admissions after preemption,
    # chunked prefill and prefix-cache hits
    assert scheds[0].preemptions > 0 and scheds[0].admissions > 8
    assert scheds[0].chunks_scheduled > 8 and scheds[0].cache.hits > 0
    assert all(x is None for x in slots[0]) and not queues[0]
