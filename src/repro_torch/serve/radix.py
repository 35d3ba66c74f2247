"""Radix prefix cache: automatic shared-prefix KV reuse over the block
pool (SGLang's RadixAttention memory model on top of serve/kvpool.py).

Millions of requests sharing a system prompt re-prefill identical KV
blocks; this module makes the shared prefix a *cache hit* instead. A
radix tree over token sequences maps prefixes to the refcounted physical
blocks that already hold their KV:

* **node boundaries are block-aligned** — every edge label is a whole
  number of pool blocks and owns exactly the blocks its token span
  covers, so each cached block has exactly one owning node and eviction
  of a node is eviction of a block range;
* **matching is token-granular** — a lookup may end mid-block (the new
  prompt diverges inside a cached block, or simply ends there). The hit
  forks the covering blocks into the new sequence via ``KVPool.adopt``;
  the shared partial tail block is COW'd by the scheduler's ordinary
  ``reserve`` call on first write, so the pool's fork/COW mechanism is the
  entire safety story — the cache adds policy, not new aliasing rules;
* **insert on release** — when a sequence finishes, its written tokens'
  full blocks are threaded into the tree and the tree takes a reference
  on each newly-cached block. ``KVPool.free`` then drops the sequence's
  references and the cached blocks survive at refcount 1, owned only by
  the tree: *reclaimable*;
* **LRU leaf eviction** — reclaimable blocks count toward the pool's
  ``available_blocks`` and are freed on demand (``KVPool.ensure_free``
  calls back into ``evict``): fully-reclaimable leaves go first,
  least-recently-used, cascading upward as parents become leaves; a
  leaf partially pinned by a live fork is sacrificed only when nothing
  cleaner remains, and its pinned blocks stay alive for their sequences
  (refcounts, not the tree, keep KV safe) — eviction can never pull KV
  out from under a decode.

A full-prefix hit is capped at ``len(tokens) - 1`` reused tokens so the
admission still computes at least one position — the logits that sample
the first output token.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.obs import NULL_TRACER

from .kvpool import KVPool


def _lcp(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class _Node:
    """One radix-tree edge+node: ``tokens`` is the edge label from
    ``parent`` (a multiple of block_size long, except the root's empty
    label) and ``blocks`` are the physical pool blocks backing exactly
    those tokens. Children are keyed by the first block's token tuple —
    unique because siblings diverge inside their first block."""

    __slots__ = ("tokens", "blocks", "children", "parent", "last_use")

    def __init__(self, tokens: List[int], blocks: List[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.blocks = blocks
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0

    def key(self, bs: int) -> Tuple[int, ...]:
        return tuple(self.tokens[:bs])


class RadixPrefixCache:
    """Block-aligned radix tree over token sequences mapping shared
    prefixes to the refcounted pool blocks that already hold their KV —
    lookups via :meth:`probe`/:meth:`fork`, population via
    :meth:`insert` on sequence release, reclamation via LRU leaf
    :meth:`evict` (see module docstring for the full invariants)."""

    def __init__(self, pool: KVPool, tracer=None, pid: int = 0):
        self.pool = pool
        self.bs = pool.block_size
        # Observability: hit/evict instants on the owning replica's track.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pid = pid
        self.root = _Node([], [], None)
        self._clock = 0                # logical LRU clock (deterministic)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0         # prefill positions never recomputed
        self.evictions = 0             # leaf nodes dropped
        self.cached_tokens = 0         # tokens currently in the tree
        self.seeded_tokens = 0         # tokens planted by live migration
        pool.attach_reclaimer(self.evict)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- lookup
    def _walk(self, tokens, cap: int):
        """Longest cached prefix of ``tokens[:cap]``. Returns
        (matched_len, covering_blocks, path_nodes); the last path node may
        be only partially matched."""
        node, p = self.root, 0
        blocks: List[int] = []
        path: List[_Node] = []
        while p < cap:
            rem = tokens[p:]
            child = None
            if len(rem) >= self.bs:
                child = node.children.get(tuple(rem[: self.bs]))
            if child is None:
                # token-granular partial match inside some child's first
                # block (deterministic: longest lcp, key-order tie-break)
                best, best_m = None, 0
                for k in sorted(node.children):
                    m = _lcp(node.children[k].tokens, rem)
                    if m > best_m:
                        best, best_m = node.children[k], m
                if best_m == 0:
                    break
                m = min(best_m, cap - p)
                blocks += best.blocks[: -(-m // self.bs)]
                path.append(best)
                p += m
                break
            m = min(_lcp(child.tokens, rem), cap - p)
            blocks += child.blocks[: -(-m // self.bs)]
            path.append(child)
            p += m
            if m < len(child.tokens):
                break
            node = child
        return p, blocks, path

    def probe(self, tokens) -> Tuple[int, List[int], List[_Node]]:
        """Read-only walk (the scheduler's admission predicate): longest
        cached prefix capped at len(tokens)-1, the blocks covering it,
        and the matched path. No refcounts move and the LRU clock is
        untouched; pass the result to fork() to commit without a second
        walk."""
        cap = len(tokens) - 1
        if cap <= 0:
            return 0, [], []
        return self._walk(tokens, cap)

    def match(self, tokens) -> Tuple[int, List[int]]:
        p, blocks, _ = self.probe(tokens)
        return p, blocks

    def hit_length(self, tokens) -> int:
        """Read-only cached-prefix length for ``tokens`` (the cost
        model's cache-credit input, DESIGN.md §16): how many prefill
        positions this replica would serve from cached blocks if the
        request were admitted right now. Same walk and same
        ``len(tokens)-1`` cap as :meth:`probe`; no refcounts move and
        the LRU clock is untouched, so pricing a request on every
        balance pass cannot perturb eviction order."""
        p, _, _ = self.probe(tokens)
        return p

    def fork(self, sid: int, tokens, probe=None) -> int:
        """Commit a hit: adopt the matched blocks into sequence ``sid``
        (refcount bump, zero recompute for the covered tokens) and
        refresh the LRU clock along the path. ``probe`` reuses a walk
        probe() already did — the tree cannot have changed in between.
        Returns the matched length; 0 counts as a miss."""
        p, blocks, path = probe if probe is not None else self.probe(tokens)
        if p == 0:
            self.misses += 1
            return 0
        self.pool.adopt(sid, blocks, p)
        now = self._tick()
        for nd in path:
            nd.last_use = now
        self.hits += 1
        self.tokens_reused += p
        if self.tracer.enabled:
            self.tracer.instant("cache_hit", pid=self.pid,
                                args={"sid": sid, "matched": p,
                                      "blocks": len(blocks)})
        return p

    # ------------------------------------------------------------- insert
    def _split(self, node: _Node, at: int) -> None:
        """Split ``node``'s edge at block-aligned token offset ``at``:
        the label tail (and its blocks and children) moves into a new
        child of ``node``."""
        assert 0 < at < len(node.tokens) and at % self.bs == 0
        tail = _Node(node.tokens[at:], node.blocks[at // self.bs:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_use = node.last_use
        node.tokens = node.tokens[:at]
        node.blocks = node.blocks[: at // self.bs]
        node.children = {tail.key(self.bs): tail}

    def insert(self, tokens, table: List[int], written: int) -> int:
        """Thread a finished sequence's full-block prefix into the tree.
        ``tokens``/``table`` are the sequence's written tokens and block
        table; only whole blocks are cached (the partial tail dies with
        the sequence). The tree takes a reference on each block of every
        NEW suffix edge; blocks whose content the tree already caches are
        left alone (the caller's ``free`` recycles the duplicates).
        Returns the number of newly-cached blocks. Call BEFORE
        ``pool.free(sid)``."""
        L = (min(written, len(tokens)) // self.bs) * self.bs
        if L <= 0:
            return 0
        now = self._tick()
        node, d = self.root, 0
        new_blocks = 0
        while d < L:
            node.last_use = now
            rem = tokens[d:L]
            child = node.children.get(tuple(rem[: self.bs]))
            if child is None:
                blocks = table[d // self.bs: L // self.bs]
                for b in blocks:
                    self.pool.cache_ref(b)
                leaf = _Node(list(rem), list(blocks), node)
                leaf.last_use = now
                node.children[leaf.key(self.bs)] = leaf
                new_blocks += len(blocks)
                self.cached_tokens += len(rem)
                break
            # whole-block-aligned common prefix with the existing edge
            m = (_lcp(child.tokens, rem) // self.bs) * self.bs
            assert m >= self.bs          # first block matched via the key
            if m < len(child.tokens):
                self._split(child, m)
            node = child
            d += m
        return new_blocks

    def seed(self, tokens, table: List[int], written: int) -> int:
        """Plant a migrated prefix (DESIGN.md §9): when a live migration
        cannot re-materialize a full sequence on this pool, the engine
        injects however many full blocks DO fit under a temporary seq id,
        scatters their KV, and seeds them here — the subsequent
        resume-by-recompute admission then *hits* the planted prefix and
        recomputes only the suffix. Same contract as ``insert`` (call
        before freeing the temporary seq); returns newly-cached blocks."""
        new = self.insert(tokens, table, written)
        self.seeded_tokens += new * self.bs   # only NEWLY-cached blocks:
        return new                            # dedup against the tree
                                              # must not inflate the stat

    # ----------------------------------------------------------- eviction
    def reclaimable_blocks(self) -> int:
        """Full-tree audit of what eviction could free right now. The
        pool tracks the same quantity incrementally (``cached_blocks``,
        O(1)); this O(tree) walk exists for tests/debugging — the
        property suite asserts the two always agree."""
        total = 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            total += sum(1 for b in nd.blocks if self.pool.refcount(b) == 1)
            stack.extend(nd.children.values())
        return total

    def _evictable(self, nd: _Node) -> bool:
        return (nd.parent is not None and not nd.children and any(
            self.pool.refcount(b) == 1 for b in nd.blocks
        ))

    def _evictable_leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            if self._evictable(nd):
                out.append(nd)
            stack.extend(nd.children.values())
        return out

    def evict(self, need: int) -> int:
        """Drop leaf ranges until ``need`` blocks returned to the free
        heap (or nothing evictable remains). Victim order: leaves whose
        blocks are ALL reclaimable first (pure wins), then LRU, so a leaf
        partially pinned by a live fork is sacrificed only when nothing
        cleaner remains — evicting it frees just its unpinned blocks;
        the pinned ones stay alive for their sequences (a running decode
        is never invalidated) but leave the cache when those sequences
        do. Cascades: a parent whose last child is dropped becomes an
        evictable candidate. One tree walk per call — refcounts of other
        candidates can't change mid-evict, so only the victim's parent
        needs (re)examining."""
        freed = 0
        cand = self._evictable_leaves()

        def rank(nd: _Node):
            pure = all(self.pool.refcount(b) == 1 for b in nd.blocks)
            return (0 if pure else 1, nd.last_use, nd.key(self.bs))

        while freed < need and cand:
            victim = min(cand, key=rank)
            cand.remove(victim)
            for b in victim.blocks:
                if self.pool.cache_unref(b):
                    freed += 1
            parent = victim.parent
            del parent.children[victim.key(self.bs)]
            self.cached_tokens -= len(victim.tokens)
            self.evictions += 1
            if self.tracer.enabled:
                self.tracer.instant("cache_evict", pid=self.pid,
                                    args={"tokens": len(victim.tokens),
                                          "freed_so_far": freed,
                                          "need": need})
            if self._evictable(parent):
                cand.append(parent)
        return freed

    # -------------------------------------------------------------- stats
    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
