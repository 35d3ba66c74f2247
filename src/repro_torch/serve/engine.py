"""Serving engine: continuous batching over decode slots, on the device.

The PyTorch counterpart of ``repro.serve.engine.Engine`` (one replica).
Each replica owns a fixed pool of decode slots. New requests prefill into
a free slot (prompts padded to a bucket of ``pad_len`` tokens, KV written
straight into the slot's cache rows); all active slots then advance
``steps_per_sync`` tokens per engine step in a loop on the device:
sampling happens on the device, per-slot done masks gate cache writes and
length/budget accounting, and each step fills an (N, slots) token buffer
the host drains with ONE device->host copy. (The JAX version runs that
loop as one jitted ``lax.fori_loop``; here it is a Python loop of
``steps_per_sync`` iterations that only enqueues device work.) Per-slot
cache lengths (-1 marks an idle slot) flow through to the flash-decode
kernel. ``step_legacy`` is the one-token-per-sync baseline.

``paged=True`` swaps the contiguous per-slot rows for the paged subsystem:
flat block pools (``models.make_paged_cache``) mapped per sequence by
``serve.kvpool``, every step planned by the continuous-batching scheduler
(lookahead reservation, watermark preemption with resume-by-recompute,
token budget, FIFO admission), decode through the paged kernel.
``prefix_cache=True`` adds the radix prefix cache and ``prefill_chunk=N``
chunked prefill (the paged_prefill kernel attends chunk [s, e) to the pool
window [0, e)). Both are attention-family features: the ssm family's
recurrent state cannot be forked or resumed mid-prompt, so they raise.

The ssm family (mamba2) keeps its conv/ssm state per decode slot in both
cache layouts. Every admission zeroes the slot's recurrent rows before
its prefill (prefill reads the conv state), and, as in the JAX engine,
the prompt's padding to the ``pad_len`` bucket runs through the
recurrence.

The moe family runs as the dense one does. Its capacity drops are
batch-global, so a token depends on what every other row of the same
forward routes: each decode step runs all ``max_slots`` rows (idle ones
included, with their last token) and each admission its whole padded
bucket, as the JAX engine does.

``GLBReplicaBalancer`` drives a fabric of engines with the GLB lifeline
protocol, tier 1 (queued requests) only.

Not ported yet: live migration (``migrate_out`` / ``migrate_in``, the
balancer's tier 2), replica faults, the cost model and predictive
balancing, SLO monitoring and SLO-aware admission; the options that
would select them raise.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import (GLBParams, fabric_summary, lifeline_buddies,
                              match_steals, merge_place_stats,
                              random_candidates, terminated)
from repro_torch.models import (decode_step, forward, make_cache,
                                make_paged_cache, sample_tokens)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.obs import NULL_TRACER, MetricsRegistry, now_us

from .kvpool import KVPool
from .radix import RadixPrefixCache
from .scheduler import ContinuousBatchingScheduler

KV_LEAVES = ("k", "v")       # attention caches; every other leaf is
                             # recurrent per-slot state

# Default KV block size of the paged pool, chosen for the H100: 16 tokens
# of one KV head at head dim 64 in bf16 is 2 KiB, small enough that the
# last, partly filled block wastes little, and the kernel walks the table
# per key so the block size does not set its tile. (The JAX engine's
# default comes from a table tuned for the TPU.)
DEFAULT_BLOCK_SIZE = 16


@dataclasses.dataclass
class Request:
    """One serving request: prompt tokens in, up to ``max_new`` decoded
    tokens out, plus the lifecycle stamps the observability layer reads."""

    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    tenant: str = ""
    # Observability stamps (obs clock domain, us): submission, the last
    # time the request entered a queue, and the first output token.
    t_submit: float = 0.0
    t_queued: float = 0.0
    t_first: float = 0.0


class Engine:
    """One serving replica: continuous batching over a fixed pool of
    decode slots, multi-token decode on the device between host syncs,
    and, with ``paged=True``, the paged KV subsystem (block pool,
    scheduler, radix prefix cache, chunked prefill). ``params`` come from
    ``models.init_lm`` or ``weights.params_from_jax`` on ``device``."""

    def __init__(self, cfg: ModelConfig, params, max_slots: int = 4,
                 max_seq: int = 256, pad_len: int = 32,
                 steps_per_sync: int = 8, temperature: float = 0.0,
                 seed: int = 0, paged: bool = False,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 watermark_blocks: int = 0,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 shed_policy: str = "youngest",
                 tracer=None, metrics=None, slo=None,
                 slo_admission: bool = False, cost_model=None,
                 replica_id: int = 0, device=None):
        for name, val in (("cost_model", cost_model), ("slo", slo)):
            if val is not None:
                raise NotImplementedError(f"{name} is not ported yet")
        if slo_admission:
            raise NotImplementedError("slo_admission is not ported yet")
        if cfg.family == "ssm" and (prefix_cache
                                    or prefill_chunk is not None):
            # Recurrent conv/ssm state is not block-addressable: a cached
            # prefix (or an earlier chunk) carries hidden state the pool
            # cannot fork.
            raise ValueError(
                "prefix cache / chunked prefill need stateless attention "
                f"KV, not family={cfg.family!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.temperature = temperature
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.replica_id = replica_id
        if self.tracer.enabled:
            self.tracer.process_name(replica_id, f"replica {replica_id}")
            self.tracer.thread_name(replica_id, 0, "engine")
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.pad_len = pad_len
        self.steps_per_sync = steps_per_sync
        self.paged = paged
        self.prefix_cache = None       # set below for paged engines
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.lens = np.full(max_slots, -1, np.int32)    # -1 => idle slot
        self.budget = np.zeros(max_slots, np.int32)     # tokens still owed
        self.tokens = np.zeros((max_slots, 1), np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.steps = 0
        self.tokens_out = 0
        self.host_syncs = 0    # blocking device->host transfer points
        self.peak_running = 0  # max concurrent sequences observed
        self.peak_occupancy = 0.0   # paged: max pool occupancy observed
        self.peak_fragmentation = 0.0
        if paged:
            bs = block_size or DEFAULT_BLOCK_SIZE
            assert max_seq % bs == 0, (max_seq, bs)
            self.block_size = bs
            self.max_blocks = max_seq // bs
            self.num_blocks = num_blocks or max_slots * self.max_blocks
            assert self.num_blocks >= self.max_blocks, \
                "pool must fit at least one full-length sequence"
            self.pool = KVPool(self.num_blocks, bs)
            if prefix_cache:
                self.prefix_cache = RadixPrefixCache(
                    self.pool, tracer=self.tracer, pid=replica_id
                )
            self.sched = ContinuousBatchingScheduler(
                self.pool, max_slots, lookahead=steps_per_sync,
                max_seq=max_seq, watermark_blocks=watermark_blocks,
                token_budget=token_budget, prefill_chunk=prefill_chunk,
                cache=self.prefix_cache, shed_policy=shed_policy,
                tracer=self.tracer, metrics=self.metrics,
                pid=replica_id,
            )
            self.cache = make_paged_cache(cfg, self.num_blocks, bs,
                                          max_slots, device=self.device)
            # Reused prefill row: the single-shot paged admission prefills
            # here, then copies the prompt's blocks into the pool.
            self._row = make_cache(cfg, 1, max_seq, device=self.device)
        else:
            assert not prefix_cache and prefill_chunk is None, \
                "prefix cache / chunked prefill require paged=True"
            self.cache = make_cache(cfg, max_slots, max_seq,
                                    device=self.device)

    # ------------------------------------------------------------ helpers
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @staticmethod
    def _scrub(row) -> None:
        """Zero the recurrent leaves of a prefill row, in place: the conv
        state feeds prefill directly and must not carry the previous
        request's inputs (attention k/v tails are masked by length)."""
        for name, leaf in row.items():
            if name not in KV_LEAVES:
                leaf.zero_()

    def _sample(self, logits):
        return sample_tokens(logits[..., :self.cfg.vocab], self._gen,
                             self.temperature)

    def _decode_n(self, bt, lens, budget) -> np.ndarray:
        """steps_per_sync decode steps on the device (one recurrence for
        both cache layouts; ``bt`` is None for contiguous). Carries
        per-slot done masks (idle: lens < 0; finished: budget == 0) and
        fills an (N, slots) token buffer (-1 where a slot emitted nothing)
        that the host drains with one sync."""
        tokens = self._dev(self.tokens)
        lens = self._dev(lens)
        budget = self._dev(budget)
        buf = torch.full((self.steps_per_sync, self.max_slots), -1,
                         dtype=torch.int32, device=self.device)
        for t in range(self.steps_per_sync):
            active = (lens >= 0) & (budget > 0)
            step_lens = torch.where(active, lens, -1)
            logits, _ = decode_step(self.params, self.cfg, tokens,
                                    self.cache, step_lens, block_tables=bt)
            nxt = torch.where(active, self._sample(logits[:, 0]), -1)
            buf[t] = nxt
            lens = torch.where(active, lens + 1, lens)
            budget = torch.where(active, budget - 1, budget)
            budget = torch.where(lens >= self.max_seq - 1, 0, budget)
            tokens = torch.where(active[:, None], nxt[:, None], tokens)
        buf = buf.cpu().numpy()             # the single drain
        self.host_syncs += 1
        return buf

    def submit(self, req: Request):
        # An empty prompt has no position to sample a first token from.
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if not req.t_submit:
            req.t_submit = now_us()
            self.metrics.counter("requests_submitted").inc()
        req.t_queued = now_us()
        if self.tracer.enabled:
            self.tracer.req_begin(req.rid, pid=self.replica_id,
                                  args={"prompt_tokens": len(req.prompt),
                                        "max_new": req.max_new})
            self.tracer.req_phase(req.rid, "queued", pid=self.replica_id)
        self.queue.append(req)

    @property
    def load(self) -> int:
        return len(self.queue) + sum(s is not None for s in self.slots)

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    @property
    def pool_occupancy(self) -> float:
        """Fraction of KV capacity in use (paged: live pool blocks;
        contiguous: busy slots)."""
        if self.paged:
            return self.pool.occupancy
        return 1.0 - self.free_slots / self.max_slots

    def can_accept(self) -> bool:
        """A free slot and, for paged caches, room for a prompt-bucket
        admission under the scheduler's own predicate."""
        if self.free_slots == 0:
            return False
        if not self.paged:
            return True
        return self.sched.can_admit(
            self.pad_len, all(s is None for s in self.slots)
        )

    def _observe_ttft(self, req: Request) -> None:
        req.t_first = now_us()
        if req.t_submit:
            self.metrics.histogram("ttft_ms").observe(
                (req.t_first - req.t_submit) / 1e3)

    def _admit(self):
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                t_adm = now_us()
                if req.t_queued:
                    self.metrics.histogram("queue_wait_ms").observe(
                        (t_adm - req.t_queued) / 1e3)
                if self.tracer.enabled:
                    self.tracer.req_phase(req.rid, "prefill",
                                          pid=self.replica_id,
                                          args={"slot": i})
                    self.tracer.begin("prefill", pid=self.replica_id,
                                      args={"rid": req.rid})
                true_len = min(len(req.prompt), self.pad_len)
                toks = np.zeros((1, self.pad_len), np.int32)
                toks[0, :true_len] = req.prompt[:true_len]
                # Prefill writes the prompt's k/v (or recurrent state)
                # straight into the slot's rows (a view of the cache).
                row = {n: c[:, i:i + 1] for n, c in self.cache.items()}
                self._scrub(row)
                logits, _, _ = forward(self.params, self.cfg,
                                       self._dev(toks), cache=row,
                                       cache_len=0, mode="prefill")
                first = int(self._sample(logits[0, true_len - 1]))
                self.host_syncs += 1        # one sync per admission
                req.out.append(first)
                self.slots[i] = req
                self.lens[i] = true_len
                self.budget[i] = req.max_new
                self.tokens[i, 0] = first
                self.tokens_out += 1
                self._observe_ttft(req)
                self.metrics.histogram("prefill_chunk_ms").observe(
                    (req.t_first - t_adm) / 1e3)
                if self.tracer.enabled:
                    self.tracer.end(pid=self.replica_id)
                    self.tracer.req_phase(req.rid, "decode",
                                          pid=self.replica_id)

    def _finish_check(self, i: int, req: Request):
        if (len(req.out) > req.max_new
                or self.lens[i] >= self.max_seq - 1
                or self.budget[i] <= 0):
            req.done = True
            t_fin = now_us()
            self.metrics.counter("requests_finished").inc()
            if req.t_first:
                # Steady-state decode pace: TTFT is excluded.
                self.metrics.histogram("tpot_ms").observe(
                    (t_fin - req.t_first) / 1e3 / max(len(req.out) - 1, 1))
            if self.tracer.enabled:
                self.tracer.req_end(req.rid, pid=self.replica_id,
                                    args={"tokens": len(req.out)})
            if self.paged and self.prefix_cache is not None:
                # Thread the written prefix into the radix cache BEFORE
                # freeing: the tree takes refs, free drops the seq's.
                toks = (list(req.prompt[: self.pad_len])
                        + list(req.out[:-1]))[: int(self.lens[i])]
                self.prefix_cache.insert(
                    toks, self.pool.block_table(req.rid), int(self.lens[i])
                )
            self.slots[i] = None
            self.lens[i] = -1
            self.budget[i] = 0
            if self.paged:
                self.sched.release(req.rid)
                self.sched.slot_released(i)

    def _drain(self, buf: np.ndarray):
        """Extend per-request outputs from the (N, slots) token buffer and
        mirror the device lens/budget recurrence on the host. Mid-prefill
        slots emitted nothing and skip their finish checks."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self.paged and self.sched.mid_prefill(i):
                continue
            toks = buf[:, i]
            toks = toks[toks >= 0]
            req.out.extend(int(t) for t in toks)
            n = len(toks)
            if n:
                self.tokens[i, 0] = toks[-1]
            self.lens[i] += n
            self.budget[i] -= n
            self.tokens_out += n
            if self.paged and n:
                self.pool.advance(req.rid, int(self.lens[i]))
            self._finish_check(i, req)

    # ------------------------------------------------------------ paged path
    def _prefix_tokens(self, req: Request) -> List[int]:
        """Tokens an admission must have in cache before decoding: the
        (bucket-truncated) prompt, plus all-but-the-last generated token
        when resuming a preempted request."""
        return list(req.prompt[: self.pad_len]) + list(req.out[:-1])

    def _arm_decode(self, slot: int, req: Request, first):
        """Make a slot decodable once its prefill has landed: a resumed
        request re-feeds its last generated token; a fresh one syncs the
        prefill's sampled first token."""
        if req.out:                     # resume after preemption
            self.tokens[slot, 0] = req.out[-1]
            self.budget[slot] = req.max_new - (len(req.out) - 1)
            if self.tracer.enabled:
                self.tracer.req_instant(req.rid, "resumed",
                                        pid=self.replica_id,
                                        args={"slot": slot,
                                              "out": len(req.out)})
        else:
            first = int(first)          # one sync per fresh admission
            self.host_syncs += 1
            req.out.append(first)
            self.tokens[slot, 0] = first
            self.budget[slot] = req.max_new
            self.tokens_out += 1
            self._observe_ttft(req)
        if self.tracer.enabled:
            self.tracer.req_phase(req.rid, "decode", pid=self.replica_id)

    def _span_begin(self, name: str, slot: int, args: dict) -> None:
        if self.tracer.enabled:
            self.tracer.thread_name(self.replica_id, 1 + slot,
                                    f"slot {slot}")
            self.tracer.begin(name, pid=self.replica_id, tid=1 + slot,
                              args=args)

    def _admit_paged(self, slot: int, req: Request):
        """Prefill a scheduler-admitted request into ``slot``: prefill the
        padded bucket into the reused row, then copy the prefix's k/v
        blocks into the pool blocks the scheduler allocated; recurrent
        leaves are slot-dense and land at ``slot``."""
        prefix = self._prefix_tokens(req)
        true_len = len(prefix)
        bucket = min(-(-true_len // self.pad_len) * self.pad_len,
                     self.max_seq)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :true_len] = prefix
        t0 = now_us()
        self._span_begin("prefill", slot,
                         {"rid": req.rid, "tokens": true_len})
        self._scrub(self._row)
        logits, _, _ = forward(self.params, self.cfg, self._dev(toks),
                               cache=self._row, cache_len=0, mode="prefill")
        n_pb = -(-true_len // self.block_size)
        ids = self._dev(np.asarray(self.pool.block_table(req.rid)[:n_pb],
                                   np.int64))
        for name, pool in self.cache.items():
            if name not in KV_LEAVES:
                pool[:, slot] = self._row[name][:, 0]
                continue
            rb = self._row[name][:, 0].view(
                pool.shape[0], self.max_blocks, self.block_size,
                *pool.shape[3:])
            pool[:, ids] = rb[:, :n_pb]            # in place
        first = self._sample(logits[0, true_len - 1])
        self._arm_decode(slot, req, first)
        if self.tracer.enabled:
            self.tracer.end(pid=self.replica_id, tid=1 + slot)
        self.metrics.histogram("prefill_chunk_ms").observe(
            (now_us() - t0) / 1e3)
        self.lens[slot] = true_len

    def _run_prefill_chunk(self, slot: int, req: Request, start: int,
                           end: int, last: bool):
        """Prefill tokens [start, end) of the slot's prefix straight into
        the pool blocks (exact shapes, no bucket padding). On the final
        chunk the sequence becomes decodable."""
        prefix = self._prefix_tokens(req)
        toks = np.asarray([prefix[start:end]], np.int32)
        table = self.pool.block_table(req.rid)
        bt = np.full((1, self.max_blocks), self.num_blocks, np.int32)
        bt[0, : len(table)] = table
        t0 = now_us()
        self._span_begin("prefill_chunk", slot,
                         {"rid": req.rid, "start": start, "end": end,
                          "last": last})
        logits, _, _ = forward(self.params, self.cfg, self._dev(toks),
                               cache=self.cache, cache_len=start,
                               mode="prefill", block_tables=self._dev(bt))
        if self.tracer.enabled:
            self.tracer.end(pid=self.replica_id, tid=1 + slot)
        self.metrics.histogram("prefill_chunk_ms").observe(
            (now_us() - t0) / 1e3)
        self.pool.advance(req.rid, end)
        self.lens[slot] = end
        if not last:
            self.budget[slot] = 0           # not decodable yet
            return
        self._arm_decode(slot, req, self._sample(logits[0, -1]))

    def _device_tables(self) -> torch.Tensor:
        bt = np.zeros((self.max_slots, self.max_blocks), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            t = self.pool.block_table(req.rid)
            bt[i, : len(t)] = t
        return self._dev(bt)

    def _step_paged(self):
        plan = self.sched.plan_step(self.queue, self.slots, self.lens,
                                    self._prefix_tokens)
        for slot, _req in plan.preempted:
            self.lens[slot] = -1
            self.budget[slot] = 0
            self.tokens[slot, 0] = 0
        for src, dst in plan.copies:
            for name in KV_LEAVES:                 # COW copy, in place
                if name in self.cache:
                    self.cache[name][:, dst] = self.cache[name][:, src]
        for slot, req in plan.admit:
            self._admit_paged(slot, req)
        for slot, req, start, end, last in plan.prefill:
            self._run_prefill_chunk(slot, req, start, end, last)
        running = sum(s is not None for s in self.slots)
        self.peak_running = max(self.peak_running, running)
        s = self.pool.stats()
        self.peak_occupancy = max(self.peak_occupancy, s.occupancy)
        self.peak_fragmentation = max(self.peak_fragmentation,
                                      s.fragmentation)
        if running == 0:
            return
        if plan.active.any():
            step_lens = np.where(plan.active, self.lens,
                                 -1).astype(np.int32)
            # A partial reservation caps this step's writes at the granted
            # capacity, and plan.quota at the slot's share of the token
            # budget; the drain decrements the real budget.
            cap_left = np.maximum(plan.granted - self.lens, 0)
            step_budget = np.where(
                plan.active,
                np.minimum(np.minimum(self.budget, cap_left), plan.quota),
                self.budget,
            ).astype(np.int32)
            buf = self._decode_n(self._device_tables(), step_lens,
                                 step_budget)
            self._drain(buf)
        self.steps += 1

    # ------------------------------------------------------------------ step
    def step(self):
        """One engine iteration: admit, then ``steps_per_sync`` batched
        decode steps on the device with ONE host drain at the end."""
        if not self.tracer.enabled:
            return self._step_impl()
        with self.tracer.span("engine_step", pid=self.replica_id,
                              args={"step": self.steps}):
            self._step_impl()
            self.tracer.counter(
                "load",
                {"running": float(sum(s is not None for s in self.slots)),
                 "queued": float(len(self.queue))},
                pid=self.replica_id,
            )

    @torch.inference_mode()
    def _step_impl(self):
        if self.paged:
            return self._step_paged()
        self._admit()
        if all(s is None for s in self.slots):
            return
        self.peak_running = max(
            self.peak_running, sum(s is not None for s in self.slots)
        )
        buf = self._decode_n(None, self.lens, self.budget)
        self._drain(buf)
        self.steps += 1

    @torch.inference_mode()
    def step_legacy(self):
        """ONE decode step and one host round-trip per token (greedy): the
        baseline the multi-token loop is held against."""
        assert not self.paged, "step_legacy is the contiguous baseline"
        self._admit()
        if all(s is None for s in self.slots):
            return
        logits, _ = decode_step(self.params, self.cfg,
                                self._dev(self.tokens), self.cache,
                                self._dev(self.lens))
        nxt = torch.argmax(logits[:, 0, :self.cfg.vocab].float(), dim=-1)
        nxt = nxt.cpu().numpy()
        self.host_syncs += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            self.tokens[i, 0] = tok
            self.lens[i] += 1
            self.budget[i] -= 1
            self.tokens_out += 1
            self._finish_check(i, req)
        self.steps += 1

    def stats(self) -> dict:
        """Per-replica counters: a view over the metrics registry (engine
        / scheduler / prefix-cache counters sync into gauges)."""
        m = self.metrics
        sync = dict(tokens_out=self.tokens_out, steps=self.steps,
                    host_syncs=self.host_syncs,
                    peak_running=self.peak_running)
        if self.paged:
            sync.update(
                admissions=self.sched.admissions,
                preemptions=self.sched.preemptions,
                chunks_scheduled=self.sched.chunks_scheduled,
                peak_occupancy_pct=round(100 * self.peak_occupancy, 1),
            )
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            sync.update(
                cache_hits=pc.hits,
                cache_misses=pc.misses,
                tokens_reused=pc.tokens_reused,
                cache_evictions=pc.evictions,
                prefix_hit_rate_pct=round(100 * pc.hit_rate, 1),
            )
        for name, v in sync.items():
            m.gauge(name).set(v)
        return m.snapshot()


def _seeded_candidates(step: int, P: int, w: int) -> np.ndarray:
    """Default random-round victims of superstep ``step``: drawn from a
    generator seeded from 17 and the superstep (the JAX balancer folds the
    superstep into ``key(17)``; numpy cannot replay that stream)."""
    return random_candidates(np.random.default_rng([17, step]), P, w)


class GLBReplicaBalancer:
    """GLB over replicas: the paper's lifeline protocol applied to
    serving, tier 1. The counterpart of ``repro.serve.engine.
    GLBReplicaBalancer`` with queued-request stealing only.

    Per balance pass the per-replica loads are the GLB size vector and
    hungry replicas (a free slot and, for paged engines, room for a
    bucket-sized admission, with an empty local queue) are matched to
    victims by the deterministic lifeline matching (``core.lifeline``). A
    matched thief steals half of the victim's queue, oldest first. The
    load vector gathered for the matching doubles as the GLB termination
    detector, and ``collect`` merges per-replica stats into one fabric
    report.

    ``candidates(step, P, w) -> (P, w)`` supplies the random round's
    victims of each superstep; by default they come from a generator
    seeded from 17 and the superstep. A parity test passes the JAX
    reference's draws in. Tier 2 (``migrate``), replica faults, the cost
    model and predictive balancing, and SLO monitoring are not ported yet
    and raise."""

    def __init__(self, engines: List[Engine],
                 params: GLBParams = GLBParams(),
                 migrate: bool = False, tracer=None, slo=None,
                 faults=None, cost_model=None, predictive: bool = False,
                 candidates=None):
        for name, val in (("migrate", migrate), ("slo", slo),
                          ("faults", faults), ("cost_model", cost_model),
                          ("predictive", predictive)):
            if val:
                raise NotImplementedError(f"{name} is not ported yet")
        self.engines = engines
        self.params = params
        self.candidates = candidates or _seeded_candidates
        # Decision log: one tuple per steal, in execution order.
        self.decisions: List[tuple] = []
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._fabric_pid = 1 + max(
            (e.replica_id for e in engines), default=-1
        )
        if self.tracer.enabled:
            self.tracer.process_name(self._fabric_pid, "fabric balancer")
            self.tracer.thread_name(self._fabric_pid, 0, "balance")
        P = len(engines)
        self._buddies = lifeline_buddies(P, params.resolve_z(P))
        self._pending = np.zeros((P, P), bool)
        self._step = 0
        self._rr = 0                   # submission counter: placement must
                                       # not depend on rid density
        self.queue_moves = 0           # tier-1: queued requests stolen
        self.supersteps = 0
        self.terminated = False

    @property
    def moves(self) -> int:
        """Requests moved between replicas (tier 1 only here)."""
        return self.queue_moves

    def submit(self, req: Request, rr: Optional[int] = None):
        """Round-robin placement by an internal submission counter (``rid
        % P`` skews when rids are strided); ``rr`` overrides it for
        adversarial test placement."""
        P = len(self.engines)
        if rr is None:
            i = self._rr % P
            self._rr += 1
        else:
            i = rr % P
        self.engines[i].submit(req)

    @staticmethod
    def _stealable(e: Engine) -> int:
        """One replica's entry in the GLB size vector: its queue depth."""
        return len(e.queue)

    def balance(self) -> bool:
        """One balancing pass. Returns True when the fabric is done: the
        load vector gathered for the steal matching is the termination
        detector."""
        loads = np.asarray([e.load for e in self.engines], np.int32)
        if self.tracer.enabled:
            self.tracer.counter(
                "fabric_load",
                {f"replica{i}": int(v) for i, v in enumerate(loads)},
                pid=self._fabric_pid,
            )
        if terminated(loads):
            self.terminated = True
            if self.tracer.enabled:
                self.tracer.instant("terminated", pid=self._fabric_pid,
                                    args={"superstep": self.supersteps})
            return True
        sizes = np.asarray([self._stealable(e) for e in self.engines],
                           np.int32)
        hungry = np.asarray([e.can_accept() and len(e.queue) == 0
                             for e in self.engines])
        P = len(self.engines)
        cand = np.asarray(self.candidates(self._step, P, self.params.w),
                          np.int32).reshape(P, -1)
        m = match_steals(sizes, hungry, self._pending, cand, self._buddies,
                         self.params)
        self._pending = m.pending
        for thief, victim in enumerate(m.src):
            if victim < 0:
                continue
            v = self.engines[int(victim)]
            if not v.queue:
                continue
            # Steal half the queue, oldest first: stolen requests keep
            # their arrival order on the thief.
            took = min(max(1, len(v.queue) // 2), len(v.queue))
            for _ in range(took):
                self.engines[thief].submit(v.queue.popleft())
                self.queue_moves += 1
            self.decisions.append(("q", v.replica_id,
                                   self.engines[thief].replica_id, took))
            if self.tracer.enabled:
                self.tracer.instant(
                    "steal_queued", pid=self._fabric_pid,
                    args={"victim": v.replica_id,
                          "thief": self.engines[thief].replica_id,
                          "n": took},
                )
        self._step += 1
        return False

    def run(self, max_steps: int = 10_000) -> str:
        """Drive the fabric to completion: balance, superstep every
        engine, repeat until the balance pass reports termination.
        Returns ``"terminated"`` or ``"wedged"`` (``max_steps`` exhausted
        with work outstanding)."""
        while max_steps > 0:
            with self.tracer.span("superstep", pid=self._fabric_pid,
                                  args={"n": self.supersteps}):
                if self.balance():
                    break
                for e in self.engines:
                    e.step()
                self.supersteps += 1
            max_steps -= 1
        if self.terminated:
            return "terminated"
        if self.tracer.enabled:
            self.tracer.instant(
                "fabric_wedged", pid=self._fabric_pid,
                args={"supersteps": self.supersteps,
                      "loads": [e.load for e in self.engines]},
            )
        return "wedged"

    def collect(self) -> dict:
        """Fabric-level result collection: per-replica stats merged into
        one report (total/mean/max per field) plus the balancer's own
        counters, with the JAX balancer's keys (the unported tiers count
        0)."""
        merged = merge_place_stats([e.stats() for e in self.engines])
        merged["_balancer"] = {
            "moves": self.moves,
            "queue_moves": self.queue_moves,
            "migrations": 0,
            "diffusion_moves": 0,
            "sterile_steals": 0,
            "supersteps": self.supersteps,
            "replicas_dead": 0,
            "readmitted_queued": 0,
            "readmitted_running": 0,
            "mig_live": 0,
            "mig_seeded": 0,
            "mig_recompute": 0,
        }
        return merged

    def merged_metrics(self) -> MetricsRegistry:
        """Fabric-level metrics registry: counters add, gauges keep the
        high-water mark, histograms merge bucket counts (quantiles of the
        merged distribution)."""
        for e in self.engines:
            e.stats()               # sync attr-backed gauges first
        return MetricsRegistry.merged([e.metrics for e in self.engines])

    def report(self) -> str:
        """Human-readable fabric summary plus the balancer counters."""
        lines = [fabric_summary(self.collect(), title="replica fabric",
                                places=len(self.engines))]
        lines.append(
            f"  balancer: {self.moves} moves ({self.queue_moves} queued "
            f"+ 0 live migrations: 0 live / 0 seeded / 0 recompute), "
            f"{self.supersteps} supersteps, terminated={self.terminated}"
        )
        return "\n".join(lines)
