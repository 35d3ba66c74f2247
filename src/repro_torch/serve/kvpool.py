"""Block-granular KV-cache pool: the host-side allocator behind paged
serving (vLLM's PagedAttention memory model applied to this stack).

The device holds one flat pool of KV blocks per attention layer
(``models.make_paged_cache``); this module owns the *mapping* — which
physical block backs logical block ``i`` of sequence ``s``. Key
properties:

* **free-list allocator** — a min-heap of free physical block ids, so
  allocation order is deterministic (lowest id first) and test-stable
  regardless of free order;
* **refcounted blocks** — ``fork`` shares a parent's blocks with the
  child by bumping refcounts, so a shared prompt prefix occupies HBM
  once no matter how many continuations hang off it;
* **copy-on-write** — ``reserve``/``extend`` return ``(src, dst)``
  physical copy pairs for any shared block the sequence is about to
  write into (the partial tail block after a fork); the caller applies
  them to the device pool before decoding. Blocks a sequence only
  *reads* stay shared forever;
* **reservation vs written** — ``reserve`` grows capacity (the
  scheduler's decode lookahead), ``advance`` records tokens actually
  written, ``extend`` does both; stats separate the two so
  fragmentation reports real waste, not lookahead;
* **live migration** — ``extract`` names the physical blocks holding a
  sequence's written tokens (the dense transfer set for shipping a
  *running* sequence to another replica) and ``inject`` re-materializes
  a migrated sequence over fresh blocks on the receiving pool; both are
  id-level only — ``serve.engine`` owns the device gather/scatter;
* **reclaimable blocks** — the radix prefix cache (``serve.radix``)
  holds references on blocks whose only owner is the cache itself;
  those blocks are *reclaimable*: they count toward
  ``available_blocks`` (so a warm cache never blocks admission) and
  ``ensure_free`` evicts them on demand before an alloc/reserve gives
  up. Eviction and preemption therefore share one accounting — the
  scheduler's watermark math sees free + cached, and only when both
  run out does PoolExhausted trigger a preemption;
* **stats** — occupancy (live blocks / pool size) and internal
  fragmentation (allocated-but-unused token slots) feed the serving
  scheduler's admission watermark and the GLB replica balancer's
  memory-pressure signal.

The pool never touches device memory: it hands out integer block ids and
copy instructions; ``serve.engine`` owns the gather/scatter that
realizes them.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple


class PoolExhausted(RuntimeError):
    """Raised when an alloc/extend needs more free blocks than exist."""


@dataclasses.dataclass(frozen=True)
class PoolStats:
    """Point-in-time snapshot of the block pool's occupancy and
    fragmentation (returned by ``KVPool.stats()``)."""

    num_blocks: int
    block_size: int
    live_blocks: int          # blocks with refcount > 0
    free_blocks: int
    num_seqs: int
    used_tokens: int          # sum of per-seq WRITTEN lengths
    cached_blocks: int        # reclaimable: referenced ONLY by the
                              # prefix cache (free-on-demand)
    occupancy: float          # live_blocks / num_blocks
    fragmentation: float      # 1 - used / sum(per-seq allocated capacity):
                              # reserved-but-unwritten token slots (partial
                              # tail blocks + lookahead reservations).
                              # Per-seq denominator so forked shared blocks
                              # weigh once per owner, like the numerator.


class KVPool:
    """Host-side block allocator for the paged KV cache.

    ``num_blocks`` physical blocks of ``block_size`` tokens each. A
    sequence's logical address space is its block table: logical token
    ``t`` lives in physical block ``table[t // block_size]`` at offset
    ``t % block_size``.
    """

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks))
        heapq.heapify(self._free)
        self._ref = [0] * num_blocks
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        # Prefix-cache accounting: blocks the radix tree owns, and an
        # INCREMENTAL count of how many are reclaimable (refcount == 1,
        # i.e. only the tree references them). available_blocks sits on
        # the scheduler hot path, so this must never walk the tree.
        self._cache_owned: set = set()
        self._reclaimable = 0
        # Eviction hook, wired up by the radix prefix cache: reclaim(n)
        # evicts cache entries until ~n blocks return to the free heap.
        self._reclaim_fn: Optional[Callable[[int], int]] = None

    # ------------------------------------------------------------ internals
    def _take_block(self) -> int:
        if not self._free:
            raise PoolExhausted("KV pool out of blocks")
        b = heapq.heappop(self._free)
        assert self._ref[b] == 0
        assert b not in self._cache_owned
        self._ref[b] = 1
        return b

    def _drop_block(self, b: int) -> None:
        assert self._ref[b] > 0, f"double free of block {b}"
        self._ref[b] -= 1
        if self._ref[b] == 1 and b in self._cache_owned:
            self._reclaimable += 1      # last non-tree reference gone
        if self._ref[b] == 0:
            assert b not in self._cache_owned
            heapq.heappush(self._free, b)

    def _nblocks(self, tokens: int) -> int:
        return -(-tokens // self.block_size) if tokens > 0 else 0

    # ------------------------------------------------------------------ api
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Blocks referenced only by the prefix cache (reclaimable).
        Maintained incrementally — O(1), safe on the scheduler hot path."""
        return self._reclaimable

    @property
    def available_blocks(self) -> int:
        """Free blocks plus cache-only blocks that eviction can return.
        All admission/watermark arithmetic uses this, so a warm prefix
        cache never costs capacity — eviction and preemption share one
        accounting."""
        return len(self._free) + self._reclaimable

    def attach_reclaimer(self, reclaim_fn: Callable[[int], int]) -> None:
        """Register the prefix cache's evict hook."""
        self._reclaim_fn = reclaim_fn

    def ensure_free(self, need: int) -> None:
        """Evict cached-but-unreferenced blocks until ``need`` are free (or
        the cache runs dry — the caller's exhaustion check then fires)."""
        if need > len(self._free) and self._reclaim_fn is not None:
            self._reclaim_fn(need - len(self._free))

    def refcount(self, b: int) -> int:
        return self._ref[b]

    def add_ref(self, b: int) -> None:
        """Take an extra sequence reference on a live block (fork/adopt).
        A cache-owned block gaining a sequence reference stops being
        reclaimable — eviction could no longer free it."""
        assert self._ref[b] > 0, f"add_ref on dead block {b}"
        if self._ref[b] == 1 and b in self._cache_owned:
            self._reclaimable -= 1
        self._ref[b] += 1

    def cache_ref(self, b: int) -> None:
        """The radix tree takes ownership of a live block (insert path).
        The inserting sequence still holds its reference, so the block
        becomes reclaimable only when that sequence frees."""
        assert self._ref[b] > 0, f"cache_ref on dead block {b}"
        assert b not in self._cache_owned, f"block {b} cached twice"
        self._cache_owned.add(b)
        self._ref[b] += 1

    def cache_unref(self, b: int) -> bool:
        """The radix tree drops ownership (eviction). Returns True when
        the block actually returned to the free heap."""
        assert b in self._cache_owned, f"evicting uncached block {b}"
        self._cache_owned.discard(b)
        if self._ref[b] == 1:
            self._reclaimable -= 1      # was counted as reclaimable
        self._drop_block(b)
        return self._ref[b] == 0

    def blocks_for(self, tokens: int) -> int:
        """Physical blocks a ``tokens``-long sequence needs."""
        return self._nblocks(tokens)

    def can_alloc(self, tokens: int) -> bool:
        return self._nblocks(tokens) <= self.available_blocks

    def has_seq(self, sid: int) -> bool:
        return sid in self._tables

    def seq_len(self, sid: int) -> int:
        return self._lens[sid]

    def block_table(self, sid: int) -> List[int]:
        return list(self._tables[sid])

    def capacity(self, sid: int) -> int:
        """Allocated token capacity (blocks x block_size)."""
        return len(self._tables[sid]) * self.block_size

    def alloc(self, sid: int, tokens: int) -> List[int]:
        """Allocate a new sequence whose first ``tokens`` tokens are (about
        to be) written. Returns its block table. Raises PoolExhausted
        (allocating nothing) if the free list is short."""
        if sid in self._tables:
            raise ValueError(f"seq {sid} already allocated")
        need = self._nblocks(tokens)
        if need > self.available_blocks:
            raise PoolExhausted(
                f"need {need} blocks, {self.available_blocks} available"
            )
        self.ensure_free(need)
        if need > self.free_blocks:    # cache eviction under-delivered
            raise PoolExhausted(
                f"need {need} blocks, {self.free_blocks} free after evict"
            )
        self._tables[sid] = [self._take_block() for _ in range(need)]
        self._lens[sid] = tokens
        return self.block_table(sid)

    def adopt(self, sid: int, blocks: List[int], tokens: int) -> List[int]:
        """Register a new sequence over already-live shared blocks (a
        prefix-cache hit): refcounts bump, nothing is allocated, and the
        first write into the shared partial tail COWs via reserve() like
        any forked sequence. ``blocks`` must cover exactly ``tokens``."""
        if sid in self._tables:
            raise ValueError(f"seq {sid} already allocated")
        assert self._nblocks(tokens) == len(blocks), (tokens, blocks)
        for b in blocks:
            self.add_ref(b)
        self._tables[sid] = list(blocks)
        self._lens[sid] = tokens
        return self.block_table(sid)

    def blocks_needed(self, sid: int, tokens: int) -> int:
        """Free blocks a ``reserve(sid, tokens)`` would consume: new
        blocks past current capacity PLUS one per shared block in the
        write range (the COW copies). Watermark checks must use this, not
        raw capacity arithmetic."""
        table = self._tables[sid]
        written = self._lens[sid]
        if tokens <= written:
            return 0
        end_blk = self._nblocks(tokens)
        cow = sum(
            1 for idx in range(written // self.block_size,
                               min(end_blk, len(table)))
            if self._ref[table[idx]] > 1
        )
        return max(end_blk - len(table), 0) + cow

    def reserve(self, sid: int, tokens: int) -> Tuple[List[int],
                                                      List[Tuple[int, int]]]:
        """Ensure capacity for ``tokens`` total WITHOUT advancing the
        written length (the scheduler's lookahead reservation). Returns
        ``(new_blocks, copies)`` where ``copies`` is a list of
        ``(src_phys, dst_phys)`` pairs the caller must apply to the device
        pool: a copy appears iff the next write position sits in a shared
        block (refcount > 1) — the copy-on-write step after ``fork``.
        Atomic: on PoolExhausted nothing changed."""
        table = self._tables[sid]
        written = self._lens[sid]
        if tokens <= written:
            return [], []
        end_blk = self._nblocks(tokens)
        need_new = max(end_blk - len(table), 0)
        # COW check: EVERY already-allocated shared block the write range
        # [written, tokens) touches — the partial tail block plus any
        # shared lookahead blocks a fork inherited. Blocks strictly before
        # the write range are read-only and stay shared.
        cow_idxs = [
            idx for idx in range(written // self.block_size,
                                 min(end_blk, len(table)))
            if self._ref[table[idx]] > 1
        ]
        need = need_new + len(cow_idxs)
        if need > self.available_blocks:
            raise PoolExhausted(
                f"reserve needs {need} blocks, "
                f"{self.available_blocks} available"
            )
        self.ensure_free(need)
        if need > self.free_blocks:    # cache eviction under-delivered
            raise PoolExhausted(
                f"reserve needs {need} blocks, "
                f"{self.free_blocks} free after evict"
            )
        copies: List[Tuple[int, int]] = []
        for idx in cow_idxs:
            src = table[idx]
            dst = self._take_block()
            copies.append((src, dst))
            self._drop_block(src)   # shared: stays alive for the other seq
            table[idx] = dst
        new_blocks = [self._take_block() for _ in range(need_new)]
        table.extend(new_blocks)
        return new_blocks, copies

    def advance(self, sid: int, tokens: int) -> None:
        """Record that the sequence's written length grew to ``tokens``
        (must stay within reserved capacity; never shrinks)."""
        if tokens > self.capacity(sid):
            raise ValueError(
                f"advance({tokens}) beyond capacity {self.capacity(sid)}"
            )
        self._lens[sid] = max(self._lens[sid], tokens)

    def extend(self, sid: int, tokens: int) -> Tuple[List[int],
                                                     List[Tuple[int, int]]]:
        """Grow seq ``sid`` to ``tokens`` *written* tokens: reserve the
        capacity (COW included) and advance in one call."""
        out = self.reserve(sid, tokens)
        if tokens > self._lens[sid]:
            self.advance(sid, tokens)
        return out

    def extract(self, sid: int) -> Tuple[List[int], int]:
        """Pack descriptor for live migration (DESIGN.md §9): the physical
        blocks holding the sequence's WRITTEN tokens — full blocks plus
        the partial tail — and the written length. Lookahead-only blocks
        (reserved, never written) are excluded: the thief re-reserves its
        own lookahead. The pool stays untouched; the engine gathers these
        blocks into a dense device buffer and calls ``free`` once the
        transfer is out the door."""
        written = self._lens[sid]
        return self._tables[sid][: self._nblocks(written)], written

    def inject(self, sid: int, tokens: int) -> List[int]:
        """Re-materialize a migrated-in sequence: allocate fresh blocks
        covering ``tokens`` written tokens and register the sequence over
        them (the ``extract`` counterpart on the thief). Atomic — raises
        PoolExhausted (after cache eviction) without allocating anything
        when the pool cannot fit the sequence; the caller then falls back
        to resume-by-recompute."""
        return self.alloc(sid, tokens)

    def fork(self, parent: int, child: int) -> List[int]:
        """Register ``child`` sharing every block of ``parent`` (prefix
        cached once). Blocks become refcount-shared; the child's first
        write past the shared prefix triggers the COW copy in extend()."""
        if child in self._tables:
            raise ValueError(f"seq {child} already allocated")
        table = self._tables[parent]
        for b in table:
            self.add_ref(b)
        self._tables[child] = list(table)
        self._lens[child] = self._lens[parent]
        return self.block_table(child)

    def free(self, sid: int) -> None:
        """Release the sequence: each block's refcount drops, blocks
        return to the free heap at refcount 0. Freeing an unknown sid
        raises (double-free guard)."""
        if sid not in self._tables:
            raise KeyError(f"seq {sid} not allocated (double free?)")
        for b in self._tables.pop(sid):
            self._drop_block(b)
        del self._lens[sid]

    # ---------------------------------------------------------------- stats
    def stats(self) -> PoolStats:
        live = self.num_blocks - self.free_blocks
        used = sum(self._lens.values())
        # Per-seq capacity: forked shared blocks count once per owner, the
        # same way the written numerator does, so the ratio stays in [0,1].
        cap = sum(len(t) for t in self._tables.values()) * self.block_size
        return PoolStats(
            num_blocks=self.num_blocks,
            block_size=self.block_size,
            live_blocks=live,
            free_blocks=self.free_blocks,
            num_seqs=len(self._tables),
            used_tokens=used,
            cached_blocks=self.cached_blocks,
            occupancy=live / self.num_blocks,
            fragmentation=max(0.0, 1.0 - used / cap) if cap else 0.0,
        )

    @property
    def occupancy(self) -> float:
        return (self.num_blocks - self.free_blocks) / self.num_blocks
