"""Continuous-batching scheduler: admission, lookahead block reservation,
prefix-cache-aware admission, chunked prefill, and preempt-and-requeue
over the paged KV pool.

This is the serving analogue of the GLB runtime loop the paper argues for
(§1-2): the *runtime*, not the request stream, decides what occupies the
accelerator each superstep. Per engine step the scheduler produces a
``StepPlan``:

* **token budget** — one pool of ``token_budget`` positions per step,
  shared by decode and prefill. Occupied slots are visited oldest-first:
  a mid-prefill slot claims its next chunk (at most ``prefill_chunk``
  tokens), a decoding slot claims up to ``lookahead`` positions
  (``plan.quota``); when the pool runs dry the rest pause this step. A
  long admission therefore costs at most the budget per step instead of
  stalling every co-scheduled decode for one giant prefill;
* **prefix cache** — on admission the radix cache (``serve.radix``) is
  probed for the longest cached prefix of the request's tokens; a hit
  forks the covering blocks into the new sequence (``KVPool.adopt``) and
  prefill starts at the matched offset — zero recompute for the hit, COW
  on the shared partial tail via the ordinary ``reserve`` path. All
  free-block arithmetic uses ``pool.available_blocks`` (free + cache-only
  blocks), so cached prefixes are evicted on demand rather than ever
  blocking admission — eviction and preemption share one accounting;
* **lookahead reservation** — every *active* sequence gets pool capacity
  for the full ``lookahead`` (= steps_per_sync) tokens the device decode
  loop will write, so the loop never runs out of blocks mid-flight. COW
  copies surfaced by ``KVPool.reserve`` are returned for the engine to
  apply before decoding;
* **watermark preemption** — when a reservation (or admission) would
  leave fewer than ``watermark_blocks`` available, the *youngest* running
  sequence is preempted: its blocks are freed and the request goes back
  to the FRONT of the queue with its generated tokens kept. Re-admission
  recomputes the cache by prefilling prompt + generated-so-far (resume by
  recompute — and, when the prompt's blocks survived in the prefix
  cache, the recompute is itself a hit). A sequence never preempts
  *itself*: with no younger victim it takes a partial reservation (the
  engine clamps that step's writes to the granted capacity), and the
  oldest sequence may consume the watermark headroom outright — so
  progress is guaranteed and a too-tight watermark degrades throughput,
  never liveness;
* **admission** — while a slot is free, the head of the queue fits under
  the watermark, and the token budget has room, requests are admitted
  strictly FIFO (head-of-line blocking preserves arrival order rather
  than back-filling around a big request). In chunked mode (prefix cache
  or ``prefill_chunk`` set) an admission enters the plan's ``prefill``
  list and decodes only after its last chunk lands; otherwise it takes
  the legacy single-shot ``admit`` path.

The scheduler owns every ``KVPool`` mutation; the engine owns the device
side (prefill scatter, COW block copies, chunk forwards, the decode
loop).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import NULL_TRACER, MetricsRegistry, now_us

from .kvpool import KVPool, PoolExhausted

_INF = 1 << 30


@dataclasses.dataclass
class StepPlan:
    """One engine step's worth of scheduling decisions: who prefills
    (single-shot or chunked), who was preempted, which COW copies the
    engine must apply, and each slot's decode mask/reservation/quota.
    Produced by :meth:`ContinuousBatchingScheduler.plan_step`; the
    engine applies the device-side effects."""

    admit: List[Tuple[int, object]]          # (slot, request) single-shot
                                             # prefill (legacy path)
    prefill: List[Tuple[int, object, int, int, bool]]
                                             # (slot, req, start, end, last)
                                             # chunk of tokens [start, end)
                                             # to prefill this step
    preempted: List[Tuple[int, object]]      # (slot, request) freed+requeued
    copies: List[Tuple[int, int]]            # COW (src, dst) block copies
    active: np.ndarray                       # (slots,) bool decode mask
    granted: np.ndarray                      # (slots,) i32 token capacity
                                             # reserved per slot; the engine
                                             # clamps each slot's step budget
                                             # to granted - lens so a partial
                                             # reservation can never be
                                             # overrun by the decode loop
    quota: np.ndarray                        # (slots,) i32 decode positions
                                             # this slot may emit this step
                                             # (its slice of token_budget)


class ContinuousBatchingScheduler:
    """Plans one engine step over a shared KVPool. ``lookahead`` is how
    many tokens the device decode loop writes per step (steps_per_sync);
    ``watermark_blocks`` is the available-block floor that triggers
    preemption instead of reservation; ``token_budget`` caps positions
    (decode + prefill-chunk) scheduled per step (None = unlimited);
    ``prefill_chunk`` caps one sequence's prefill tokens per step;
    ``cache`` is the radix prefix cache (None = no prefix reuse)."""

    def __init__(self, pool: KVPool, max_slots: int, lookahead: int,
                 max_seq: int, watermark_blocks: int = 0,
                 token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 cache=None, shed_policy: str = "youngest",
                 tracer=None, metrics=None, slo=None,
                 slo_admission: bool = False, cost_model=None,
                 pid: int = 0):
        assert shed_policy in ("youngest", "budget"), shed_policy
        # SLO-aware admission (DESIGN.md §16): order the queue by TTFT
        # slack and pace non-urgent admissions. Off by default — the
        # default path must stay strictly FIFO, byte-identical to a
        # scheduler built without the flag.
        if slo_admission:
            if slo is None:
                raise ValueError("slo_admission requires an SLOMonitor")
            tgt = slo.target_ms("ttft_ms")
            if tgt is None:
                tgt = slo.target_ms("queue_wait_ms")
            if tgt is None:
                raise ValueError(
                    "slo_admission needs a ttft_ms or queue_wait_ms "
                    "target on the SLOMonitor")
            self._slo_target_ms = tgt
        self.slo_admission = slo_admission
        self.cost_model = cost_model
        self.paced_deferrals = 0               # admissions delayed by pacing
        # Observability: the engine hands down its tracer/registry so
        # admission/preemption events land on the owning replica's track
        # (pid) and queue-wait is observed where the commit happens.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.slo = slo
        self.pid = pid
        self.pool = pool
        self.max_slots = max_slots
        self.lookahead = lookahead
        self.max_seq = max_seq
        self.watermark = watermark_blocks
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk
        self.cache = cache
        self.shed_policy = shed_policy
        self._admit_seq = 0                    # monotonic admission clock
        self._order = [-1] * max_slots         # slot -> admission seqno
        self._prefill: Dict[int, List[int]] = {}   # slot -> [done, total]
        self.preemptions = 0
        self.admissions = 0
        self.chunks_scheduled = 0
        self.adoptions = 0                     # migrated-in sequences

    # --------------------------------------------------------------- helpers
    @property
    def chunked_mode(self) -> bool:
        """Admissions prefill via StepPlan.prefill chunks (budget-charged,
        decode-interleaved) instead of the legacy single-shot path."""
        return self.cache is not None or self.prefill_chunk is not None

    def mid_prefill(self, slot: int) -> bool:
        """True while ``slot`` still owes prefill chunks (it must not
        decode, and the engine's finish checks must skip it)."""
        return slot in self._prefill

    def _occupied_oldest_first(self, slots) -> List[int]:
        occ = [i for i in range(self.max_slots) if slots[i] is not None]
        return sorted(occ, key=lambda i: self._order[i])

    def _youngest(self, slots) -> Optional[int]:
        occ = [i for i in range(self.max_slots) if slots[i] is not None]
        if not occ:
            return None
        return max(occ, key=lambda i: self._order[i])

    def shed_candidates(self, slots: List, budgets) -> List[int]:
        """Live sequences the replica balancer may migrate out, best
        victim first (DESIGN.md §9). Mid-prefill slots are excluded —
        their KV is half-written and a migrated chunk plan would dangle.
        Policies: ``youngest`` (least cache invested: the cheapest
        transfer, and the mirror of preemption's victim order) or
        ``budget`` (largest remaining token budget: the move that
        offloads the most future work per transferred byte)."""
        occ = [i for i in range(self.max_slots)
               if slots[i] is not None and i not in self._prefill]
        if self.shed_policy == "budget":
            return sorted(occ, key=lambda i: (-int(budgets[i]),
                                              -self._order[i]))
        return sorted(occ, key=lambda i: -self._order[i])

    def adopt(self, slot: int) -> None:
        """Register a migrated-in sequence as a running slot WITHOUT
        passing through admission: the engine has already injected its
        blocks and host state. It takes the youngest admission seqno —
        it is the newest arrival here, so watermark preemption and a
        subsequent shed pass both see it as the natural first victim."""
        self._order[slot] = self._admit_seq
        self._admit_seq += 1
        self.adoptions += 1

    def _admission_slack_ms(self, req, prefix_len: int,
                            now_ref: float) -> float:
        """TTFT budget left for a queued request: declared target minus
        time already queued minus the cost model's predicted prefill
        service time (0 without a model). Negative = the target is
        already blown; smallest slack = most urgent."""
        waited = ((now_ref - req.t_queued) / 1e3
                  if getattr(req, "t_queued", 0.0) else 0.0)
        predicted = (self.cost_model.prefill_ms(prefix_len)
                     if self.cost_model is not None else 0.0)
        return self._slo_target_ms - waited - predicted

    def can_admit(self, prefix_len: int, engine_empty: bool) -> bool:
        """The balancer's hunger signal (``Engine.can_accept``): does a
        ``prefix_len`` admission plus decode lookahead fit, leaving the
        watermark headroom available — or, on an empty engine, fit at
        all? Counts cache-only blocks as available (they evict on
        demand) but assumes no prefix hit, so it is CONSERVATIVE
        relative to plan_step's own admission check, which additionally
        credits matched cache blocks (and un-credits the ones the fork
        would pin). A replica may therefore report not-hungry for a
        request plan_step would admit via a hit — safe in that
        direction; keep the two checks reviewed together."""
        target = min(prefix_len + self.lookahead, self.max_seq)
        need = self.pool.blocks_for(target)
        floor = 0 if engine_empty else self.watermark
        avail = self.pool.available_blocks
        return need <= avail and avail - need >= floor

    def _preempt(self, victim: int, slots, queue: Deque,
                 plan: StepPlan) -> None:
        req = slots[victim]
        self.pool.free(req.rid)
        plan.preempted.append((victim, req))
        # A half-prefilled victim restarts from scratch on re-admission
        # (its written blocks are gone); drop any chunk already planned
        # for it this step — the engine must not prefill a freed seq.
        self._prefill.pop(victim, None)
        plan.prefill = [e for e in plan.prefill if e[0] != victim]
        req.t_queued = now_us()
        if self.tracer.enabled:
            self.tracer.instant("preempt", pid=self.pid,
                                args={"slot": victim, "rid": req.rid})
            self.tracer.req_instant(req.rid, "preempted", pid=self.pid,
                                    args={"slot": victim})
            self.tracer.req_phase(req.rid, "queued", pid=self.pid)
        queue.appendleft(req)
        slots[victim] = None
        self._order[victim] = -1
        self.preemptions += 1

    def _plan_chunk(self, plan: StepPlan, slot: int, req,
                    budget_left: int) -> int:
        """Schedule the next prefill chunk for ``slot``; returns tokens
        charged against the step budget (0 = budget dry, no chunk)."""
        done, total = self._prefill[slot]
        # A zero-token prefill could never take its "last chunk" and
        # would wedge the slot mid-prefill forever; the engine rejects
        # empty prompts at submit, so this is unreachable — keep it loud.
        assert done < total, (slot, done, total)
        chunk = min(total - done, self.prefill_chunk or _INF, budget_left)
        if chunk <= 0:
            return 0
        end = done + chunk
        last = end >= total
        plan.prefill.append((slot, req, done, end, last))
        if last:
            del self._prefill[slot]
        else:
            self._prefill[slot][0] = end
        self.chunks_scheduled += 1
        return chunk

    # ------------------------------------------------------------------ plan
    def plan_step(self, queue: Deque, slots: List, lens: np.ndarray,
                  prefix_tokens_of) -> StepPlan:
        """Mutates ``queue``/``slots`` for preemptions and admissions
        (the engine applies the device-side effects afterwards).
        ``prefix_tokens_of(req)`` gives the token sequence an admission
        must have in cache before decoding (prompt, plus generated tokens
        when resuming) — the prefix-cache lookup key and the chunked
        prefill work list.

        Liveness: the oldest running sequence reserves below the
        watermark, shrinking to a partial reservation when no *younger*
        victim exists (it never preempts itself), and an empty engine
        admits the queue head on raw available blocks — so some sequence
        always makes progress and a too-tight watermark degrades to
        smaller steps instead of deadlock."""
        plan = StepPlan(admit=[], prefill=[], preempted=[], copies=[],
                        active=np.zeros(self.max_slots, bool),
                        granted=np.zeros(self.max_slots, np.int32),
                        quota=np.zeros(self.max_slots, np.int32))
        budget_left = (self.token_budget if self.token_budget is not None
                       else _INF)
        bs = self.pool.block_size

        # 1) oldest-first over occupied slots: mid-prefill slots claim
        #    their next chunk, decoding slots reserve lookahead capacity
        #    (preempting youngest-first at the watermark).
        for rank, i in enumerate(self._occupied_oldest_first(slots)):
            if slots[i] is None:
                continue                        # preempted above
            req = slots[i]
            if i in self._prefill:
                budget_left -= self._plan_chunk(plan, i, req, budget_left)
                continue                        # no decode while prefilling
            if budget_left <= 0:
                plan.granted[i] = min(self.pool.capacity(req.rid),
                                      self.max_seq)
                continue                        # paused: over token budget
            target = min(int(lens[i]) + self.lookahead, self.max_seq)
            # The oldest sequence may dip into the watermark headroom —
            # that headroom exists to protect *its* growth.
            floor = 0 if rank == 0 else self.watermark
            ok = False
            while True:
                try:
                    # blocks_needed counts COW copies too, so the floor
                    # check can't be sidestepped by a forked tail block.
                    need = self.pool.blocks_needed(req.rid, target)
                    if need > 0 and (self.pool.available_blocks - need
                                     < floor):
                        raise PoolExhausted("watermark")
                    _, copies = self.pool.reserve(req.rid, target)
                    plan.copies.extend(copies)
                    ok = True
                    break
                except PoolExhausted:
                    victim = self._youngest(slots)
                    if victim is not None and victim != i:
                        self._preempt(victim, slots, queue, plan)
                        continue
                    # No younger victim: shrink to what fits instead of
                    # preempting ourselves (which could never help).
                    usable = max(self.pool.available_blocks - floor, 0)
                    cur = len(self.pool.block_table(req.rid))
                    shrunk = min(target, (cur + usable) * bs)
                    if shrunk >= target:
                        break   # can't shrink further (e.g. COW starved)
                    target = shrunk
            granted = min(self.pool.capacity(req.rid), self.max_seq)
            plan.granted[i] = granted
            if ok and granted > int(lens[i]):
                plan.active[i] = True
                plan.quota[i] = min(self.lookahead, budget_left)
                budget_left -= int(plan.quota[i])

        # 2) FIFO admission while slots, blocks, and token budget allow.
        free_slots = deque(i for i in range(self.max_slots)
                           if slots[i] is None)
        # SLO-aware mode replaces arrival order with slack order (most
        # urgent first, rid tie-break — stable and deterministic) and
        # paces the relaxed tail: once one non-urgent request (slack >
        # half the target) has been admitted this step while work is
        # already running, further non-urgent admissions wait a step so
        # running decodes keep their token-budget share. Urgent requests
        # are never paced. Everything here is behind the flag: with
        # slo_admission off this block is dead code and admission stays
        # strictly FIFO.
        relaxed_admitted = 0
        now_ref = now_us() if self.slo_admission else 0.0
        if self.slo_admission and len(queue) > 1:
            ordered = sorted(
                queue,
                key=lambda r: (self._admission_slack_ms(
                    r, len(prefix_tokens_of(r)), now_ref), r.rid))
            queue.clear()
            queue.extend(ordered)
        while queue and free_slots and budget_left > 0:
            req = queue[0]
            ptoks = prefix_tokens_of(req)
            prefix = len(ptoks)
            if self.slo_admission:
                slack = self._admission_slack_ms(req, prefix, now_ref)
                relaxed = slack > 0.5 * self._slo_target_ms
                if (relaxed and relaxed_admitted >= 1
                        and any(s is not None for s in slots)):
                    self.paced_deferrals += 1
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "admission_paced", pid=self.pid,
                            args={"rid": req.rid,
                                  "slack_ms": round(slack, 3)})
                    break
            target = min(prefix + self.lookahead, self.max_seq)
            floor = (0 if all(s is None for s in slots)
                     else self.watermark)
            avail = self.pool.available_blocks
            # Probe the prefix cache: a hit needs that many fewer fresh
            # blocks (plus one COW for a partially-matched tail block) —
            # but the matched blocks that are currently cache-only stop
            # being reclaimable the moment the fork pins them, so they
            # must come OUT of the available headroom too (counting them
            # on both sides would admit, fail in reserve, and retry the
            # queue head forever). When the hit-credited admission does
            # NOT fit, fall back to a plain miss admission — evicting the
            # prefix is better than never admitting the queue head.
            probe = (self.cache.probe(ptoks) if self.cache
                     else (0, [], []))
            matched, mblocks = probe[0], probe[1]
            pinned = sum(1 for b in mblocks
                         if self.pool.refcount(b) == 1)
            need_hit = (self.pool.blocks_for(target) - len(mblocks)
                        + (1 if matched % bs else 0))
            use_cache = (
                matched > 0
                and need_hit <= avail - pinned
                and (avail - pinned) - need_hit >= floor
            )
            need_miss = self.pool.blocks_for(target)
            # An idle engine admits on raw available blocks (progress
            # beats headroom when nothing is running to free any).
            if not use_cache and (need_miss > avail
                                  or avail - need_miss < floor):
                break                           # head-of-line: stay FIFO
            slot = free_slots[0]
            forked = 0
            try:
                if use_cache:
                    forked = self.cache.fork(req.rid, ptoks, probe=probe)
                elif self.cache is not None:
                    self.cache.misses += 1      # hit skipped or no match
                matched = forked
                if matched == 0:
                    # chunked mode starts at written=0 and prefills via
                    # chunks; the legacy path writes the whole prefix in
                    # its admission step.
                    self.pool.alloc(req.rid,
                                    0 if self.chunked_mode else prefix)
                _, copies = self.pool.reserve(req.rid, target)
            except PoolExhausted:
                # Cache eviction under-delivered (reclaimable blocks
                # pinned by live forks): undo the half-admission — blocks
                # AND hit/miss stats — and leave the head queued.
                if self.pool.has_seq(req.rid):
                    self.pool.free(req.rid)
                if self.cache is not None:
                    if forked:
                        self.cache.hits -= 1
                        self.cache.tokens_reused -= forked
                    else:
                        self.cache.misses -= 1
                break
            plan.copies.extend(copies)
            queue.popleft()
            free_slots.popleft()
            slots[slot] = req
            self._order[slot] = self._admit_seq
            self._admit_seq += 1
            self.admissions += 1
            if self.slo_admission and relaxed:
                relaxed_admitted += 1
            # Admission commit: the request leaves the queue here, for
            # both the chunked and legacy paths — the one site where
            # queue wait ends and the prefill phase begins.
            t_adm = now_us()
            if getattr(req, "t_queued", 0.0):
                wait_ms = (t_adm - req.t_queued) / 1e3
                self.metrics.histogram("queue_wait_ms").observe(wait_ms)
                if self.slo is not None:
                    self.slo.observe("queue_wait_ms", wait_ms)
            if self.tracer.enabled:
                self.tracer.req_phase(req.rid, "prefill", pid=self.pid,
                                      args={"slot": slot,
                                            "cached": matched})
            plan.granted[slot] = min(self.pool.capacity(req.rid),
                                     self.max_seq)
            if self.chunked_mode:
                self._prefill[slot] = [matched, prefix]
                budget_left -= self._plan_chunk(plan, slot, req,
                                                budget_left)
            else:
                plan.admit.append((slot, req))
                plan.active[slot] = True
                plan.quota[slot] = min(self.lookahead, budget_left)
                budget_left -= int(plan.quota[slot])
        if self.tracer.enabled:
            # The step's token-budget split: decode positions granted vs
            # prefill-chunk tokens scheduled — the per-step timeline a
            # cost-modeled balancer will read.
            self.tracer.counter(
                "token_budget",
                {"decode": float(plan.quota.sum()),
                 "prefill": float(sum(e[3] - e[2] for e in plan.prefill))},
                pid=self.pid,
            )
        return plan

    def release(self, rid: int) -> None:
        """A sequence finished: return its blocks to the pool (the engine
        threads its prefix into the radix cache first, so cached blocks
        survive the free at refcount 1)."""
        self.pool.free(rid)

    def slot_released(self, slot: int) -> None:
        self._order[slot] = -1
        self._prefill.pop(slot, None)
