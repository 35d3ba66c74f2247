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
window [0, e)). Both are attention-family features: the recurrent state
of the ssm and hybrid families cannot be forked or resumed mid-prompt, so
they raise.

The ssm (mamba2) and hybrid (zamba2) families keep their conv/ssm state
per decode slot in both cache layouts; the hybrid family's k/v caches
hold one layer per application of its shared attention block. Every admission zeroes the slot's recurrent rows before
its prefill (prefill reads the conv state), and, as in the JAX engine,
the prompt's padding to the ``pad_len`` bucket runs through the
recurrence.

The moe family runs as the dense one does. Its capacity drops are
batch-global, so a token depends on what every other row of the same
forward routes: each decode step runs all ``max_slots`` rows (idle ones
included, with their last token) and each admission its whole padded
bucket, as the JAX engine does.

``GLBReplicaBalancer`` drives a fabric of engines with the GLB lifeline
protocol in two tiers: queued requests first, then, with
``migrate=True``, live sequences. A live sequence's written KV blocks are
gathered on the victim's device into a transfer buffer in host memory
(``Migration.kv``, CPU tensors: one device->host copy, one host sync),
and the thief copies the buffer to its own device and scatters it into
fresh pool blocks (``KVPool.extract`` / ``inject``), so a Migration can
land on any replica on any card. Where the thief's pool is tight the
sequence lands radix-seeded or by recompute; the recurrent family
always resumes by recompute. The balancer also detects and recovers from
replica faults (``serve.faults``), balances predictively on a cost model
(``serve.cost``), and feeds an SLO monitor (``obs.slo``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import (GLBParams, diffusion_pairs, fabric_summary,
                              lifeline_buddies, match_steals,
                              merge_place_stats, random_candidates,
                              rewire_lifelines, terminated)
from repro_torch.models import (decode_step, forward, make_cache,
                                make_paged_cache, sample_tokens)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.obs import (DEFAULT_BYTE_BUCKETS, NULL_TRACER,
                             MetricsRegistry, now_us)

from .kvpool import KVPool, PoolExhausted
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


class _Phases:
    """An engine's phase spans while its tracer is on. Each span also
    opens a host-only profiler range ``engine.<phase>`` (a plain
    ``cpu_op`` under ``torch.profiler``, not a user annotation, which the
    profiler would mirror on the device's timeline), so a profile's idle
    gaps can be put down to the phase the host was in. On a CUDA device a
    timed span records a CUDA event on the stream at each edge; the pair
    is read into the span's end event as ``device_ms`` only once a drain
    has synchronised the stream after both were recorded, so tracing adds
    no synchronisation. Events are recycled."""

    def __init__(self, tracer, pid: int, device: torch.device):
        self.tracer, self.pid = tracer, pid
        self.device = device if device.type == "cuda" else None
        self._range = torch._C._profiler._RecordFunctionFast
        self._open = {}         # tid -> [[range, start, stop, seq], ...]
        self._pending = []      # (end event, start, stop, seq)
        self._free = []
        self._seq = 0           # stop events recorded so far
        self._synced = 0        # of which the stream has finished

    def _record(self):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def begin(self, name: str, tid: int = 0, args: Optional[dict] = None,
              timed: bool = False) -> None:
        self.tracer.begin(name, pid=self.pid, tid=tid, args=args)
        rng = self._range("engine." + name.replace("engine_", ""))
        rng.__enter__()
        start = self._record() if timed and self.device else None
        self._open.setdefault(tid, []).append([rng, start, None, 0])

    def stop_clock(self, tid: int = 0) -> None:
        """Record the device edge of the innermost open timed span on
        ``tid`` now, ahead of the synchronisation that ends it."""
        top = self._open.get(tid)
        if top and top[-1][1] is not None and top[-1][2] is None:
            self._seq += 1
            top[-1][2:] = [self._record(), self._seq]

    def end(self, tid: int = 0, args: Optional[dict] = None) -> None:
        self.stop_clock(tid)
        rng, start, stop, seq = self._open[tid].pop()
        rng.__exit__(None, None, None)
        ev = self.tracer.end(pid=self.pid, tid=tid, args=args)
        if start is not None:
            self._pending.append((ev, start, stop, seq))

    def unwind(self) -> None:
        """End every span still open, innermost first: after a step, its
        own; after an error inside it, the phases it was in as well."""
        for tid in sorted(self._open, reverse=True):
            while self._open[tid]:
                self.end(tid)

    def synced(self) -> None:
        """The stream has finished everything enqueued so far."""
        self._synced = self._seq

    def resolve(self) -> None:
        """Fill in ``device_ms`` of every span whose stop event the
        stream has passed; the rest wait for a later drain."""
        wait = []
        for ev, start, stop, seq in self._pending:
            if seq > self._synced:
                wait.append((ev, start, stop, seq))
                continue
            if ev is not None:
                ev.setdefault("args", {})["device_ms"] = \
                    start.elapsed_time(stop)
            self._free += (start, stop)
        self._pending = wait


@dataclasses.dataclass
class Request:
    """One serving request: prompt tokens in, up to ``max_new`` decoded
    tokens out, plus the lifecycle stamps the observability and cost
    layers read. The same object travels with the request through
    steals, migrations and crash re-admission."""

    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Cost-model inputs: the tenant keys the per-tenant decode-length
    # histogram; predicted_decode is the at-submit length prediction (-1
    # = never stamped), kept across re-submits like t_submit.
    tenant: str = ""
    predicted_decode: float = -1.0
    # Observability stamps (obs clock domain, us): submission, the last
    # time the request entered a queue, and the first output token.
    t_submit: float = 0.0
    t_queued: float = 0.0
    t_first: float = 0.0


@dataclasses.dataclass
class Migration:
    """A live sequence in flight between replicas. The victim's
    ``migrate_out`` owns the only copy of the request and its packed KV
    until the thief's ``migrate_in`` lands it (the victim has already
    freed its blocks and slot). ``kv`` is the transfer buffer in host
    memory: CPU tensors ``{"k", "v"}`` of shape (layers, n, bs, kv_heads,
    hd), the pool blocks covering exactly the WRITTEN tokens in logical
    order (None for the recurrent family, which resumes by recompute)."""
    req: Request
    tokens: List[int]          # cache contents = prompt bucket + out[:-1]
    written: int               # == len(tokens), the cache fill level
    block_size: int
    kv: Optional[dict]


def gather_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
              ids: torch.Tensor):
    """The pool blocks ``ids`` (int64, on the pools' device) of both
    (layers, num_blocks + 1, bs, kv_heads, hd) pools, in ``ids`` order."""
    return cache_k.index_select(1, ids), cache_v.index_select(1, ids)


def scatter_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
               ids: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor):
    """Write blocks ``bk`` / ``bv`` (already on the pools' device and
    dtype) into pool blocks ``ids``, in place."""
    cache_k.index_copy_(1, ids, bk)
    cache_v.index_copy_(1, ids, bv)


class Engine:
    """One serving replica: continuous batching over a fixed pool of
    decode slots, multi-token decode on the device between host syncs,
    and, with ``paged=True``, the paged KV subsystem (block pool,
    scheduler, radix prefix cache, chunked prefill, live migration).
    ``params`` come from ``models.init_lm`` or ``weights.params_from_jax``
    on ``device``. ``slo`` (an ``obs.SLOMonitor``) is fed the per-request
    latencies the histograms get; ``cost_model`` (a ``serve.CostModel``)
    stamps a decode-length prediction at submit and scores it at
    finish; ``slo_admission`` orders paged admissions by TTFT slack."""

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
        if slo_admission and not paged:
            raise ValueError("slo_admission needs the paged scheduler")
        if cfg.family in ("ssm", "hybrid") and (
                prefix_cache or prefill_chunk is not None):
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
        self.slo = slo
        self.cost_model = cost_model
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
        # rows the prefill forwards ran (bucket padding included), and
        # the prefix rows among them
        self.prefill_rows = 0
        self.prefill_tokens = 0
        self._phases = (_Phases(self.tracer, replica_id, self.device)
                        if self.tracer.enabled else None)
        self.peak_running = 0  # max concurrent sequences observed
        self.peak_occupancy = 0.0   # paged: max pool occupancy observed
        self.peak_fragmentation = 0.0
        self.migrations_out = 0     # live sequences shipped to a peer
        self.migrations_in = 0      # live sequences landed with their KV
        self.migrations_seeded = 0  # landed via a planted radix prefix
        self.migrations_recompute = 0   # landed WITHOUT KV (recompute)
        self._seed_sid = -1         # temp seq ids for radix seeding
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
                tracer=self.tracer, metrics=self.metrics, slo=self.slo,
                slo_admission=slo_admission, cost_model=cost_model,
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
        if self.tracer.enabled:
            self._phases.stop_clock()
        buf = buf.cpu().numpy()             # the single drain
        self.host_syncs += 1
        if self.tracer.enabled:
            self._phases.synced()
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
        if self.cost_model is not None:
            self.cost_model.stamp(req)
        self.queue.append(req)

    @property
    def load(self) -> int:
        return len(self.queue) + sum(s is not None for s in self.slots)

    # --------------------------------------------------------- cost model
    def request_cost(self, req: Request, queued: bool) -> float:
        """Predicted remaining block-seconds for one request ON THIS
        replica (requires a cost model): a queued request at its
        recompute prefix minus this replica's radix-cache hit plus its
        predicted decode; a running one at its remaining decode only."""
        cm = self.cost_model
        bs = self.block_size if self.paged else self.max_seq
        if queued:
            ptoks = self._prefix_tokens(req)
            cached = (self.prefix_cache.hit_length(ptoks)
                      if self.prefix_cache is not None else 0)
            return cm.estimate(len(ptoks), cached, 0, req.tenant,
                               req.max_new, bs)
        return cm.estimate(min(len(req.prompt), self.pad_len), 0,
                           len(req.out), req.tenant, req.max_new, bs)

    @property
    def predicted_cost(self) -> float:
        """This replica's entry in the predictive load vector: summed
        predicted remaining block-seconds over its queue and running
        slots (0.0 without a cost model)."""
        if self.cost_model is None:
            return 0.0
        cost = sum(self.request_cost(r, True) for r in self.queue)
        cost += sum(self.request_cost(r, False)
                    for r in self.slots if r is not None)
        return cost

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
            ttft_ms = (req.t_first - req.t_submit) / 1e3
            self.metrics.histogram("ttft_ms").observe(ttft_ms)
            if self.slo is not None:
                self.slo.observe("ttft_ms", ttft_ms)

    def _admit(self):
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                t_adm = now_us()
                if req.t_queued:
                    wait_ms = (t_adm - req.t_queued) / 1e3
                    self.metrics.histogram("queue_wait_ms").observe(
                        wait_ms)
                    if self.slo is not None:
                        self.slo.observe("queue_wait_ms", wait_ms)
                if self.tracer.enabled:
                    self.tracer.req_phase(req.rid, "prefill",
                                          pid=self.replica_id,
                                          args={"slot": i})
                    self.tracer.begin("prefill", pid=self.replica_id,
                                      args={"rid": req.rid})
                true_len = min(len(req.prompt), self.pad_len)
                self.prefill_rows += self.pad_len
                self.prefill_tokens += true_len
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
                tpot_ms = ((t_fin - req.t_first) / 1e3
                           / max(len(req.out) - 1, 1))
                self.metrics.histogram("tpot_ms").observe(tpot_ms)
                if self.slo is not None:
                    self.slo.observe("tpot_ms", tpot_ms)
            if self.cost_model is not None:
                # Score the stamped prediction and feed the actual length
                # back; the cost_sample instant is what the analyzer's
                # prediction-error attribution reads.
                err = self.cost_model.observe_finish(req)
                if self.tracer.enabled and err is not None:
                    self.tracer.instant(
                        "cost_sample", pid=self.replica_id,
                        args={"rid": req.rid, "tenant": req.tenant,
                              "predicted": round(req.predicted_decode, 1),
                              "actual": len(req.out),
                              "err": round(err, 1)})
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
            self._phases.begin(name, tid=1 + slot, args=args, timed=True)

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
        self.prefill_rows += bucket
        self.prefill_tokens += true_len
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
            self._phases.end(tid=1 + slot,
                             args={"rows": bucket, "tokens": true_len})
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
        self.prefill_rows += end - start
        self.prefill_tokens += end - start
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
            self._phases.end(tid=1 + slot)
        self.metrics.histogram("prefill_chunk_ms").observe(
            (now_us() - t0) / 1e3)
        self.pool.advance(req.rid, end)
        self.lens[slot] = end
        if not last:
            self.budget[slot] = 0           # not decodable yet
            return
        self._arm_decode(slot, req, self._sample(logits[0, -1]))

    # ------------------------------------------------------- live migration
    def can_host(self, written: int) -> bool:
        """Whether a migrated sequence with ``written`` cache tokens can
        run here at all: it needs a free position below ``max_seq`` to
        decode into, whatever the landing mode."""
        return self.paged and written < self.max_seq

    def migratable_slots(self) -> List[int]:
        """Slots the balancer may shed, best victim first (the
        scheduler's shed policy). Empty for contiguous engines, and
        mid-prefill slots are excluded."""
        if not self.paged:
            return []
        return self.sched.shed_candidates(self.slots, self.budget)

    @torch.inference_mode()
    def migrate_out(self, slot: int) -> Migration:
        """Ship the live sequence in ``slot`` to a peer replica: gather its
        written KV blocks on this device and copy them into a transfer
        buffer in host memory (one host sync), free its blocks and slot
        here, and hand ownership of the request to the returned
        Migration. The buffer holds exactly the cache positions [0,
        written): the thief re-feeds the last generated token at
        ``written``, as a preemption resume does. Mid-prefill slots are
        rejected."""
        assert self.paged, "live migration needs the paged KV pool"
        req = self.slots[slot]
        assert req is not None, f"slot {slot} is idle"
        if self.sched.mid_prefill(slot):
            raise ValueError(
                f"slot {slot} is mid-prefill and cannot migrate")
        tokens = self._prefix_tokens(req)
        written = int(self.lens[slot])
        assert len(tokens) == written, (len(tokens), written)
        t0 = now_us()
        if self.tracer.enabled:
            self.tracer.begin("migrate_out", pid=self.replica_id,
                              args={"rid": req.rid, "written": written})
        kv = None
        if self.cfg.family not in ("ssm", "hybrid"):
            blocks, _ = self.pool.extract(req.rid)
            ids = self._dev(np.asarray(blocks, np.int64))
            bk, bv = gather_kv(self.cache["k"], self.cache["v"], ids)
            kv = {"k": bk.cpu(), "v": bv.cpu()}
            self.host_syncs += 1
        mig = Migration(req=req, tokens=tokens, written=written,
                        block_size=self.block_size, kv=kv)
        self.slots[slot] = None
        self.lens[slot] = -1
        self.budget[slot] = 0
        self.tokens[slot, 0] = 0
        self.sched.release(req.rid)
        self.sched.slot_released(slot)
        self.migrations_out += 1
        nbytes = sum(b.nbytes for b in kv.values()) if kv else 0
        self.metrics.histogram("migrate_pack_ms").observe(
            (now_us() - t0) / 1e3)
        self.metrics.histogram("migration_bytes",
                               DEFAULT_BYTE_BUCKETS).observe(nbytes)
        if self.tracer.enabled:
            self.tracer.end(pid=self.replica_id)
            self.tracer.req_instant(req.rid, "migrated_out",
                                    pid=self.replica_id,
                                    args={"written": written,
                                          "bytes": nbytes})
            # The victim opens the migrate phase; the thief's landing
            # closes it (span ownership travels with the request).
            self.tracer.req_phase(req.rid, "migrate", pid=self.replica_id)
        return mig

    def _requeue_migrated(self, req: Request) -> None:
        # Front of the queue: the sequence was already running and must
        # not wait behind fresh arrivals (same rule as preemption).
        req.t_queued = now_us()
        if self.tracer.enabled:
            self.tracer.req_phase(req.rid, "queued", pid=self.replica_id)
        self.queue.appendleft(req)

    def migrate_in(self, mig: Migration) -> str:
        """Land a migrated sequence (span and landing metrics around
        :meth:`_migrate_in`, which picks the mode)."""
        t0 = now_us()
        if self.tracer.enabled:
            self.tracer.begin("migrate_in", pid=self.replica_id,
                              args={"rid": mig.req.rid,
                                    "written": mig.written})
        try:
            with torch.inference_mode():
                mode = self._migrate_in(mig)
        finally:
            if self.tracer.enabled:
                self.tracer.end(pid=self.replica_id)
        self.metrics.histogram("migrate_land_ms").observe(
            (now_us() - t0) / 1e3)
        if self.tracer.enabled:
            self.tracer.req_instant(mig.req.rid, "migrated_in",
                                    pid=self.replica_id,
                                    args={"mode": mode})
        return mode

    def _migrate_in(self, mig: Migration) -> str:
        """Land a migrated sequence. Three outcomes, best first:

        * ``"live"`` — a free slot and enough pool blocks: inject fresh
          blocks, copy the transfer buffer to this device and scatter it
          into them, and adopt the sequence as a running slot;
        * ``"seeded"`` — the pool cannot fit the whole sequence but a
          prefix cache exists: inject the full blocks that DO fit under a
          temporary seq id, seed them into the radix tree, and requeue, so
          the resume admission hits the planted prefix;
        * ``"recompute"`` — no KV came along (recurrent family), block
          sizes differ, or nothing fits: plain resume-by-recompute.

        Every path preserves greedy token identity."""
        assert self.paged, "live migration needs the paged KV pool"
        req = mig.req
        if not self.can_host(mig.written):
            # The caller still owns the Migration and must pick a
            # compatible host.
            raise ValueError(
                f"sequence with {mig.written} cache tokens cannot run "
                f"under max_seq={self.max_seq}; check can_host() first")
        if mig.kv is None or mig.block_size != self.block_size:
            self._requeue_migrated(req)
            self.migrations_recompute += 1
            return "recompute"
        slot = next((i for i in range(self.max_slots)
                     if self.slots[i] is None), None)
        if slot is not None and self.pool.can_alloc(mig.written):
            try:
                table = self.pool.inject(req.rid, mig.written)
            except PoolExhausted:   # eviction under-delivered (pinned)
                table = None
            if table is not None:
                self._scatter_migrated(table, mig.kv)
                self.sched.adopt(slot)
                self.slots[slot] = req
                self.lens[slot] = mig.written
                # req.out is non-empty (mid-decode): the resume branch.
                self._arm_decode(slot, req, None)
                self.peak_running = max(
                    self.peak_running,
                    sum(s is not None for s in self.slots))
                self.migrations_in += 1
                return "live"
        if self.prefix_cache is not None:
            full = mig.written // self.block_size
            fit = min(full, self.pool.available_blocks)
            if fit > 0:
                sid = self._seed_sid
                self._seed_sid -= 1
                seeded = fit * self.block_size
                try:
                    table = self.pool.inject(sid, seeded)
                except PoolExhausted:   # reclaimables pinned mid-evict
                    table = None
                if table is not None:
                    self._scatter_migrated(
                        table, {n: b[:, :fit] for n, b in mig.kv.items()})
                    self.prefix_cache.seed(mig.tokens[:seeded], table,
                                           seeded)
                    self.pool.free(sid)  # tree refs keep blocks cached
                    self._requeue_migrated(req)
                    self.migrations_seeded += 1
                    return "seeded"
        self._requeue_migrated(req)
        self.migrations_recompute += 1
        return "recompute"

    def _scatter_migrated(self, table: List[int], kv: dict) -> None:
        """Copy a transfer buffer to this device and scatter it into pool
        blocks ``table`` (never the sink block: the pool hands out ids
        below ``num_blocks``)."""
        ids = self._dev(np.asarray(table, np.int64))
        ck, cv = self.cache["k"], self.cache["v"]
        scatter_kv(ck, cv, ids, kv["k"].to(self.device, ck.dtype),
                   kv["v"].to(self.device, cv.dtype))

    def _device_tables(self) -> torch.Tensor:
        bt = np.zeros((self.max_slots, self.max_blocks), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            t = self.pool.block_table(req.rid)
            bt[i, : len(t)] = t
        return self._dev(bt)

    def _step_paged(self):
        if self.tracer.enabled:
            self._phases.begin("plan")
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
        if self.tracer.enabled:
            self._phases.end()
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
            if self.tracer.enabled:
                self._phases.begin("decode_loop", timed=True)
            buf = self._decode_n(self._device_tables(), step_lens,
                                 step_budget)
            if self.tracer.enabled:
                self._phases.end(args={"iters": self.steps_per_sync,
                                       "active": int(plan.active.sum())})
                self._phases.begin("drain")
            self._drain(buf)
            if self.tracer.enabled:
                self._phases.end()
        self.steps += 1

    # ------------------------------------------------------------------ step
    def step(self):
        """One engine iteration: admit, then ``steps_per_sync`` batched
        decode steps on the device with ONE host drain at the end."""
        if not self.tracer.enabled:
            return self._step_impl()
        self._phases.begin("engine_step", args={"step": self.steps})
        try:
            self._step_impl()
            self.tracer.counter(
                "load",
                {"running": float(sum(s is not None for s in self.slots)),
                 "queued": float(len(self.queue))},
                pid=self.replica_id,
            )
        finally:
            self._phases.unwind()
        self._phases.resolve()

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
                    prefill_rows=self.prefill_rows,
                    prefill_tokens=self.prefill_tokens,
                    peak_running=self.peak_running,
                    migrations_out=self.migrations_out,
                    migrations_in=self.migrations_in,
                    migrations_seeded=self.migrations_seeded,
                    migrations_recompute=self.migrations_recompute)
        if self.paged:
            sync.update(
                admissions=self.sched.admissions,
                preemptions=self.sched.preemptions,
                adoptions=self.sched.adoptions,
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
                seeded_tokens=pc.seeded_tokens,
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
    """GLB over replicas: the paper's two-tier lifeline protocol applied
    to serving. The counterpart of ``repro.serve.engine.
    GLBReplicaBalancer``: steal *unstarted* work first, then *work in
    progress*.

    Per balance pass the per-replica loads are the GLB size vector and
    hungry replicas (a free slot and, for paged engines, room for a
    bucket-sized admission, with an empty local queue) are matched to
    victims by the deterministic lifeline matching (``core.lifeline``). A
    matched thief steals in two tiers:

    * **tier 1 — queued requests**: half of the victim's queue, oldest
      first;
    * **tier 2 — live sequences** (``migrate=True``, paged engines): when
      the victim's queue is empty but its slots are saturated, its shed
      policy picks running sequences and their KV migrates block for
      block (``Engine.migrate_out`` -> ``Engine.migrate_in``). The victim
      always keeps one running sequence.

    The load vector gathered for the matching doubles as the GLB
    termination detector and, with a ``faults`` injector attached, as the
    heartbeat: a replica that misses ``heartbeat_misses`` consecutive
    gathers is declared dead and fenced forever, its lifelines re-wired
    over the survivors, and its lost requests re-admitted from the
    balancer's submission ledger (queued ones re-submitted, running ones
    landed as recompute resumes). ``cost_model`` with ``predictive=True``
    adds a diffusive pre-pass on predicted block-seconds before the
    reactive matching; ``predictive=False`` takes exactly the reactive
    code path. ``slo`` is attached to every engine without its own and
    checked once per pass.

    ``candidates(step, P, w) -> (P, w)`` supplies the random round's
    victims of each superstep; by default they come from a generator
    seeded from 17 and the superstep. A parity test passes the JAX
    reference's draws in."""

    def __init__(self, engines: List[Engine],
                 params: GLBParams = GLBParams(),
                 migrate: bool = False, tracer=None, slo=None,
                 faults=None, heartbeat_misses: Optional[int] = None,
                 cost_model=None, predictive: bool = False,
                 imbalance_threshold: float = 0.25, candidates=None):
        self.engines = engines
        self.params = params
        self.migrate = migrate
        self.faults = faults
        if predictive and cost_model is None:
            raise ValueError("predictive balancing requires a cost_model")
        self.cost_model = cost_model
        self.predictive = predictive
        self.imbalance_threshold = imbalance_threshold
        self.diffusion_moves = 0       # moves made by the diffusive pass
        self.candidates = candidates or _seeded_candidates
        # Decision log: one tuple per steal/shed/diffusion decision, in
        # execution order.
        self.decisions: List[tuple] = []
        if cost_model is not None:
            for e in engines:
                if e.cost_model is None:
                    e.cost_model = cost_model
        self.heartbeat_misses = (heartbeat_misses if heartbeat_misses
                                 is not None else params.heartbeat_misses)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._fabric_pid = 1 + max(
            (e.replica_id for e in engines), default=-1
        )
        if self.tracer.enabled:
            self.tracer.process_name(self._fabric_pid, "fabric balancer")
            self.tracer.thread_name(self._fabric_pid, 0, "balance")
        self.slo = slo
        if slo is not None:
            slo.bind(tracer=self.tracer, pid=self._fabric_pid)
            for e in engines:
                if e.slo is None:
                    e.slo = slo
                    if e.paged:
                        e.sched.slo = slo
        P = len(engines)
        self._buddies = lifeline_buddies(P, params.resolve_z(P))
        self._pending = np.zeros((P, P), bool)
        self._step = 0
        self._rr = 0                   # submission counter: placement must
                                       # not depend on rid density
        self.queue_moves = 0           # tier-1: queued requests stolen
        self.migrations = 0            # tier-2: live sequences migrated
        self.sterile_steals = 0        # matched pairs where nothing moved
        self.migration_modes = {"live": 0, "seeded": 0, "recompute": 0}
        self.supersteps = 0
        self.terminated = False
        # ---------------------------- failure detection / recovery state
        self.metrics = MetricsRegistry()
        self._alive = [True] * P
        self._misses = [0] * P          # consecutive missed heartbeats
        self._last_load = [0] * P       # load at last answered gather
        self._last_cost = [0.0] * P     # predicted cost, same stand-in rule
        self._ledger: dict = {}         # rid -> Request, every submission
        self.replicas_dead = 0
        self.readmitted_queued = 0
        self.readmitted_running = 0

    @property
    def moves(self) -> int:
        """Requests moved between replicas: tier-1 queue steals plus
        tier-2 live migrations."""
        return self.queue_moves + self.migrations

    @property
    def alive(self) -> List[bool]:
        return list(self._alive)

    def submit(self, req: Request, rr: Optional[int] = None):
        """Round-robin placement over the live replicas by an internal
        submission counter (``rid % P`` skews when rids are strided);
        ``rr`` overrides it for adversarial test placement. Every
        submission is recorded in the recovery ledger."""
        self._ledger[req.rid] = req
        alive = [i for i in range(len(self.engines)) if self._alive[i]]
        if not alive:
            raise RuntimeError("replica fabric has no surviving replica")
        if rr is None:
            i = alive[self._rr % len(alive)]
            self._rr += 1
        else:
            i = alive[rr % len(alive)]
        self.engines[i].submit(req)
        # A submission is balancer-local knowledge: keep the stand-in
        # load fresh.
        self._last_load[i] = self.engines[i].load

    def _stealable(self, e: Engine, thieves: List[Engine]) -> int:
        """One replica's entry in the GLB size vector: its queue depth,
        or, in the migration tier, the number of its shed candidates that
        some hungry thief ``can_host`` when the queue is empty and every
        slot is busy (less the one sequence a victim keeps)."""
        q = len(e.queue)
        if q:
            return q
        if self.migrate and e.paged and e.free_slots == 0:
            cands = [s for s in e.migratable_slots()
                     if any(t.can_host(int(e.lens[s])) for t in thieves
                            if t is not e)]
            return max(len(cands) - 1, 0)
        return 0

    def _migrate(self, src: Engine, dst: Engine, slot: int) -> str:
        mode = dst.migrate_in(src.migrate_out(slot))
        self.migrations += 1
        self.migration_modes[mode] += 1
        return mode

    def _steal_live(self, thief: Engine, victim: Engine) -> None:
        """Tier 2: migrate running sequences victim -> thief, up to half
        of the victim's running set (the GLB steal-half rule), bounded by
        what it may shed and the thief's free slots."""
        cands = [s for s in victim.migratable_slots()
                 if thief.can_host(int(victim.lens[s]))]
        if self.predictive:
            # Cost-weighted shedding: the sequences with the most
            # predicted work left first (rid tie-break).
            cands = sorted(
                cands,
                key=lambda s: (-victim.request_cost(victim.slots[s],
                                                    False),
                               victim.slots[s].rid))
        running = sum(s is not None for s in victim.slots)
        sheddable = max(len(cands) - 1, 0)      # victim keeps one running
        take = min(running // 2, sheddable, thief.free_slots)
        if take == 0:
            self.sterile_steals += 1
        for slot in cands[:take]:
            rid = victim.slots[slot].rid
            mode = self._migrate(victim, thief, slot)
            self.decisions.append(("live", victim.replica_id,
                                   thief.replica_id, rid, mode))
            if self.tracer.enabled:
                self.tracer.instant(
                    "steal_live", pid=self._fabric_pid,
                    args={"victim": victim.replica_id,
                          "thief": thief.replica_id, "mode": mode},
                )

    # ------------------------------------------- predictive diffusion
    def _fabric_costs(self) -> np.ndarray:
        """The predictive load vector, gathered with the integer loads'
        stand-in rule (an unresponsive replica's last-known cost holds; a
        dead one reads 0)."""
        costs = np.zeros(len(self.engines))
        for i, e in enumerate(self.engines):
            if not self._alive[i]:
                continue
            if self._responsive(i):
                self._last_cost[i] = e.predicted_cost
            costs[i] = self._last_cost[i]
        return costs

    def _diffuse(self, active: List[bool]) -> None:
        """The diffusive pre-pass: pair replicas whose predicted cost
        exceeds the fabric mean by ``imbalance_threshold`` with
        under-mean recipients (``core.diffusion_pairs``) and move work
        toward the mean, before the reactive matching."""
        costs = self._fabric_costs()
        if self.tracer.enabled:
            self.tracer.counter(
                "fabric_cost",
                {f"replica{i}": round(float(c), 3)
                 for i, c in enumerate(costs)},
                pid=self._fabric_pid,
            )
        eligible = np.asarray(
            [active[i] and self.engines[i].can_accept()
             for i in range(len(self.engines))]
        )
        pairs = diffusion_pairs(costs, self.imbalance_threshold, eligible)
        mean = float(costs.mean())
        for d, r in pairs:
            if active[d]:
                self._diffuse_pair(d, r, costs, mean)

    def _diffuse_pair(self, d: int, r: int, costs: np.ndarray,
                      mean: float) -> None:
        """Move work donor ``d`` -> recipient ``r`` until the donor drops
        under the threshold: queued requests first (each pick minimizes
        ``|donor-mean| + |recipient-mean|`` after the move, rid
        tie-break, and must strictly improve it), then at most one live
        sequence when the queue gave nothing."""
        donor, recip = self.engines[d], self.engines[r]
        hi = mean * (1.0 + self.imbalance_threshold)
        moved = 0
        while donor.queue and costs[d] > hi and recip.can_accept():
            cur = abs(costs[d] - mean) + abs(costs[r] - mean)
            best = best_c = best_key = None
            for req in donor.queue:
                c = donor.request_cost(req, True)
                gain = cur - (abs(costs[d] - c - mean)
                              + abs(costs[r] + c - mean))
                key = (gain, -req.rid)
                if gain > 1e-9 and (best_key is None or key > best_key):
                    best, best_c, best_key = req, c, key
            if best is None:
                break
            donor.queue.remove(best)
            recip.submit(best)
            costs[d] -= best_c
            costs[r] += best_c
            self.queue_moves += 1
            self.diffusion_moves += 1
            moved += 1
            self.decisions.append(("diffuse", d, r, best.rid))
            if self.tracer.enabled:
                self.tracer.instant(
                    "diffuse_queued", pid=self._fabric_pid,
                    args={"donor": donor.replica_id,
                          "recipient": recip.replica_id,
                          "rid": best.rid, "cost": round(best_c, 3)})
        if (moved == 0 and costs[d] > hi and self.migrate
                and donor.paged and recip.paged and recip.free_slots > 0
                and donor.free_slots == 0 and not donor.queue):
            cands = [s for s in donor.migratable_slots()
                     if recip.can_host(int(donor.lens[s]))]
            if len(cands) > 1:          # the donor keeps one running
                slot = min(cands,
                           key=lambda s: (-donor.request_cost(
                               donor.slots[s], False),
                               donor.slots[s].rid))
                rid = donor.slots[slot].rid
                c = donor.request_cost(donor.slots[slot], False)
                mode = self._migrate(donor, recip, slot)
                costs[d] -= c
                costs[r] += c
                self.diffusion_moves += 1
                self.decisions.append(("diffuse_live", d, r, rid, mode))
                if self.tracer.enabled:
                    self.tracer.instant(
                        "diffuse_live", pid=self._fabric_pid,
                        args={"donor": donor.replica_id,
                              "recipient": recip.replica_id,
                              "rid": rid, "mode": mode,
                              "cost": round(c, 3)})

    # ------------------------------------------------- failure detection
    def _responsive(self, i: int) -> bool:
        return self.faults is None or self.faults.responsive(i)

    def _observed_load(self, i: int) -> int:
        """Replica i's load-vector entry: its real load when it answers
        the gather, its last-known load while unresponsive (a wedged
        replica holding all remaining work must not read as 0), and 0
        once declared dead."""
        if not self._alive[i]:
            return 0
        if self._responsive(i):
            self._last_load[i] = self.engines[i].load
        return self._last_load[i]

    def _detect_failures(self) -> None:
        """Heartbeat bookkeeping riding the load gather: ``heartbeat_
        misses`` CONSECUTIVE missed gathers declare a replica dead; one
        answered gather resets the window."""
        if self.faults is None:
            return
        for i in range(len(self.engines)):
            if not self._alive[i]:
                continue
            if self.faults.responsive(i):
                self._misses[i] = 0
                continue
            self._misses[i] += 1
            if self._misses[i] >= self.heartbeat_misses:
                self._declare_dead(i)

    def _declare_dead(self, i: int) -> None:
        """Fence replica i forever (a zombie that wakes up later is never
        gathered or stepped again), re-wire the lifelines over the
        survivors, clear its pending rows and columns, and re-admit its
        lost requests."""
        self._alive[i] = False
        self._misses[i] = 0
        if not any(self._alive):
            raise RuntimeError("every replica has died")
        self.replicas_dead += 1
        self.metrics.counter("replicas_dead").inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "replica_dead", pid=self._fabric_pid,
                args={"replica": self.engines[i].replica_id,
                      "superstep": self.supersteps,
                      "window": self.heartbeat_misses},
            )
        z = int(self._buddies.shape[1])
        self._buddies = rewire_lifelines(np.asarray(self._alive), z)
        self._pending = self._pending.copy()
        self._pending[i, :] = False    # its remembered requests die with it
        self._pending[:, i] = False    # nobody waits on a dead buddy
        self._recover(i)

    def _recover(self, dead: int) -> None:
        """Re-admit every request lost with replica ``dead``: in the
        ledger, not finished, and not observed on any survivor (computed
        without reading the dead engine). Queued casualties re-enter a
        survivor's queue; running ones (``req.out`` non-empty) land as
        recompute resumes through the migration path with ``kv=None``,
        greedy-token-identical to a crash-free run."""
        live_rids = set()
        for j, e in enumerate(self.engines):
            if not self._alive[j]:
                continue
            live_rids.update(r.rid for r in e.queue)
            live_rids.update(r.rid for r in e.slots if r is not None)
        lost = sorted(
            (r for rid, r in self._ledger.items()
             if not r.done and rid not in live_rids),
            key=lambda r: r.rid,
        )
        for req in lost:
            if req.out:
                self._readmit_running(req, dead)
            else:
                self._readmit_queued(req, dead)

    def _trace_readmit(self, req: Request, dead: int, mode: str,
                       to: int) -> None:
        if not self.tracer.enabled:
            return
        self.tracer.req_instant(
            req.rid, "readmitted", pid=self._fabric_pid,
            args={"from": self.engines[dead].replica_id, "mode": mode},
        )
        self.tracer.instant(
            "request_readmitted", pid=self._fabric_pid,
            args={"rid": req.rid, "mode": mode,
                  "from": self.engines[dead].replica_id,
                  "to": self.engines[to].replica_id},
        )

    def _readmit_queued(self, req: Request, dead: int) -> None:
        alive = [i for i in range(len(self.engines)) if self._alive[i]]
        to = alive[self._rr % len(alive)]
        self._trace_readmit(req, dead, "queued", to)
        self.submit(req)        # advances _rr, lands on `to`
        self.readmitted_queued += 1
        self.metrics.counter("requests_readmitted").inc()

    def _readmit_running(self, req: Request, dead: int) -> None:
        target = next(
            (j for j, e in enumerate(self.engines)
             if self._alive[j] and e.paged
             and e.can_host(len(e._prefix_tokens(req)))), None)
        if target is None:
            # A running sequence needs a paged survivor whose max_seq fits
            # the recompute prefix; contiguous engines cannot resume.
            raise RuntimeError(
                f"request {req.rid} ({len(req.out)} tokens in) lost with "
                f"replica {dead}: no surviving paged replica can host "
                f"its recompute resume"
            )
        eng = self.engines[target]
        tokens = eng._prefix_tokens(req)
        self._trace_readmit(req, dead, "recompute", target)
        eng.migrate_in(Migration(req=req, tokens=tokens,
                                 written=len(tokens), block_size=0,
                                 kv=None))   # recompute requeue, front
        self.readmitted_running += 1
        self.metrics.counter("requests_readmitted").inc()

    # ---------------------------------------------------------- balancing
    def balance(self) -> bool:
        """One balancing pass. Returns True when the fabric is done: the
        load vector gathered for the steal matching is the termination
        detector (and, with a fault injector, the heartbeat)."""
        if self.faults is not None:
            self.faults.begin_superstep(self.supersteps)
        self._detect_failures()
        loads = np.asarray(
            [self._observed_load(i) for i in range(len(self.engines))],
            np.int32,
        )
        if self.slo is not None:
            self.slo.check()
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
        # Dead and unresponsive replicas neither give nor take.
        active = [self._alive[i] and self._responsive(i)
                  for i in range(len(self.engines))]
        if self.predictive:
            self._diffuse(active)
        hungry = np.asarray([active[i] and e.can_accept()
                             and len(e.queue) == 0
                             for i, e in enumerate(self.engines)])
        thieves = [e for i, e in enumerate(self.engines) if hungry[i]]
        sizes = np.asarray(
            [self._stealable(e, thieves) if active[i] else 0
             for i, e in enumerate(self.engines)],
            np.int32,
        )
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
            t = self.engines[thief]
            if v.queue:
                self._steal_queued(t, v)
            elif self.migrate and v.paged and t.paged:
                self._steal_live(t, v)
        self._step += 1
        return False

    def _steal_queued(self, thief: Engine, victim: Engine) -> None:
        """Tier 1: half of the victim's queue, oldest first (stolen
        requests keep their arrival order on the thief); predictive
        balancing ships the most expensive ones instead (rid
        tie-break)."""
        took = min(max(1, len(victim.queue) // 2), len(victim.queue))
        if self.predictive:
            ranked = sorted(victim.queue,
                            key=lambda q: (-victim.request_cost(q, True),
                                           q.rid))
            for q in ranked[:took]:
                victim.queue.remove(q)
                thief.submit(q)
        else:
            for _ in range(took):
                thief.submit(victim.queue.popleft())
        self.queue_moves += took
        self.decisions.append(("q", victim.replica_id, thief.replica_id,
                               took))
        if self.tracer.enabled:
            self.tracer.instant(
                "steal_queued", pid=self._fabric_pid,
                args={"victim": victim.replica_id,
                      "thief": thief.replica_id, "n": took},
            )

    def run(self, max_steps: int = 10_000) -> str:
        """Drive the fabric to completion: balance, superstep every live
        engine the fault injector lets progress, repeat until the balance
        pass reports termination. Returns ``"terminated"`` or
        ``"wedged"`` (``max_steps`` exhausted with work outstanding,
        also traced as a ``fabric_wedged`` instant)."""
        while max_steps > 0:
            with self.tracer.span("superstep", pid=self._fabric_pid,
                                  args={"n": self.supersteps}):
                if self.balance():
                    break
                for i, e in enumerate(self.engines):
                    if not self._alive[i]:
                        continue
                    if self.faults is not None \
                            and not self.faults.should_step(i):
                        continue
                    e.step()
                self.supersteps += 1
            max_steps -= 1
        if self.terminated:
            return "terminated"
        if self.tracer.enabled:
            self.tracer.instant(
                "fabric_wedged", pid=self._fabric_pid,
                args={"supersteps": self.supersteps,
                      "loads": [int(self._observed_load(i))
                                for i in range(len(self.engines))]},
            )
        return "wedged"

    # ------------------------------------------------------ result collection
    def collect(self) -> dict:
        """Fabric-level result collection: per-replica stats merged into
        one report (total/mean/max per field) plus the balancer's own
        counters, and the SLO monitor's and cost model's snapshots."""
        merged = merge_place_stats([e.stats() for e in self.engines])
        merged["_balancer"] = {
            "moves": self.moves,
            "queue_moves": self.queue_moves,
            "migrations": self.migrations,
            "diffusion_moves": self.diffusion_moves,
            "sterile_steals": self.sterile_steals,
            "supersteps": self.supersteps,
            "replicas_dead": self.replicas_dead,
            "readmitted_queued": self.readmitted_queued,
            "readmitted_running": self.readmitted_running,
            **{f"mig_{k}": v for k, v in self.migration_modes.items()},
        }
        if self.slo is not None:
            merged["_slo"] = self.slo.snapshot()
        if self.cost_model is not None:
            merged["_cost"] = self.cost_model.snapshot()
        return merged

    def merged_metrics(self) -> MetricsRegistry:
        """Fabric-level metrics registry: counters add, gauges keep the
        high-water mark, histograms merge bucket counts (quantiles of the
        merged distribution)."""
        for e in self.engines:
            e.stats()               # sync attr-backed gauges first
        return MetricsRegistry.merged(
            [e.metrics for e in self.engines] + [self.metrics])

    def report(self) -> str:
        """Human-readable fabric summary plus the balancer counters and,
        where they apply, the predictive, failure and SLO lines."""
        lines = [fabric_summary(self.collect(), title="replica fabric",
                                places=len(self.engines))]
        lines.append(
            f"  balancer: {self.moves} moves ({self.queue_moves} queued "
            f"+ {self.migrations} live migrations: "
            f"{self.migration_modes['live']} live / "
            f"{self.migration_modes['seeded']} seeded / "
            f"{self.migration_modes['recompute']} recompute), "
            f"{self.supersteps} supersteps, terminated={self.terminated}"
        )
        if self.predictive:
            cm = self.cost_model
            lines.append(
                f"  predictive: {self.diffusion_moves} diffusion moves "
                f"(threshold {self.imbalance_threshold:g}), "
                f"{len(cm.errors)} predictions scored, "
                f"mean |err| {cm.mean_abs_error():.1f} tokens"
            )
        if self.replicas_dead:
            lines.append(
                f"  failures: {self.replicas_dead} replica(s) dead, "
                f"{self.readmitted_queued + self.readmitted_running} "
                f"requests re-admitted ({self.readmitted_queued} queued "
                f"/ {self.readmitted_running} recompute)"
            )
        if self.slo is not None:
            lines += [f"  {ln}" for ln in self.slo.report_lines()]
        return "\n".join(lines)
