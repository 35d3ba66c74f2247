"""Live KV migration in the port against ``repro.serve.engine``.

The same weights (``params_from_jax``) and requests go through the JAX
engine and the port's. Held exactly: landing modes, greedy tokens, the
balancer's ``decisions`` (its ``("live", ...)`` tuples included),
``collect()["_balancer"]`` and every count of ``stats()`` (the
histograms' times aside, their sample counts included). Held within 1e-5
absolute: KV values, which the two frameworks compute (float32 smoke
configs). The JAX balancer's random-round draws are injected as in
``test_torch_glb.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import Engine as JEngine
from repro.serve.engine import GLBReplicaBalancer as JBalancer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import _gather_kv, _scatter_kv
from repro_torch.serve import Engine, GLBReplicaBalancer, KVPool, Request
from repro_torch.serve.engine import gather_kv, scatter_kv
from test_torch_glb import KW, _jax_candidates, _setup

TINY = "tinyllama-1.1b"
PROMPT16 = [7, 3, 9, 2, 5, 8, 6, 4, 1, 2, 3, 4, 9, 9, 8, 7]
BLOCKER = [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 5]
PAGED = dict(paged=True, block_size=8)


# Counts the port's engine keeps and the JAX engine does not (held to
# their sums in test_torch_engine_trace.py).
PORT_ONLY = ("prefill_rows", "prefill_tokens")


def counts(stats: dict) -> dict:
    """A ``stats()`` / ``collect()`` view without host-clock values (a
    histogram of ms keeps its sample count) and without ``PORT_ONLY``."""
    return {k: v for k, v in stats.items()
            if ("_ms" not in k or k.endswith("_count"))
            and k not in PORT_ONLY}


class Side:
    """One framework's engine factory over the same smoke weights."""

    def __init__(self, jax_side: bool, arch: str = TINY):
        cfg, jp, tcfg, tp = _setup(arch)
        self.jax = jax_side
        self.cfg, self.params = (cfg, jp) if jax_side else (tcfg, tp)
        self.E = JEngine if jax_side else Engine
        self.R = JRequest if jax_side else Request
        self.B = JBalancer if jax_side else GLBReplicaBalancer

    def engine(self, **kw):
        extra = {} if self.jax else dict(device="cpu")
        return self.E(self.cfg, self.params, **dict(KW, **kw), **extra)

    def balancer(self, engines, **kw):
        if not self.jax:
            kw["candidates"] = _jax_candidates
        return self.B(engines, **kw)

    def cache(self, engine, name):
        return np.asarray(engine.cache[name], np.float32)


def drain(*engines, guard=600):
    while any(e.load > 0 for e in engines) and guard > 0:
        for e in engines:
            e.step()
        guard -= 1
    assert guard > 0, "engines failed to drain"


# -------------------------------------------------- gather / scatter
def test_gather_scatter_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    L, NB, bs, H, D = 3, 9, 4, 2, 8
    pool_k = rng.standard_normal((L, NB + 1, bs, H, D)).astype(np.float32)
    pool_v = rng.standard_normal((L, NB + 1, bs, H, D)).astype(np.float32)
    ids = np.asarray([5, 0, 7, 2], np.int32)
    jk, jv = _gather_kv(jnp.asarray(pool_k), jnp.asarray(pool_v),
                        jnp.asarray(ids))
    tk, tv = gather_kv(torch.as_tensor(pool_k), torch.as_tensor(pool_v),
                       torch.as_tensor(ids, dtype=torch.int64))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a host round trip, then into other blocks of a second pool
    dst = np.asarray([1, 8, 3, 6], np.int32)
    bk = rng.standard_normal((L, 4, bs, H, D)).astype(np.float32)
    bv = rng.standard_normal((L, 4, bs, H, D)).astype(np.float32)
    jk2, jv2 = _scatter_kv(jnp.asarray(pool_k), jnp.asarray(pool_v),
                           jnp.asarray(dst), jnp.asarray(bk),
                           jnp.asarray(bv))
    ck, cv = torch.as_tensor(pool_k.copy()), torch.as_tensor(pool_v.copy())
    scatter_kv(ck, cv, torch.as_tensor(dst, dtype=torch.int64),
               torch.as_tensor(bk).cpu(), torch.as_tensor(bv).cpu())
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jv2))
    # the sink block (index NB) is untouched
    np.testing.assert_array_equal(ck[:, NB].numpy(), pool_k[:, NB])


def pool_round_trip(Pool, Exhausted):
    """extract names the written blocks only (lookahead excluded); inject
    re-registers the sequence on a peer, atomically."""
    pool = Pool(8, 4)
    pool.alloc(1, 10)                       # 3 blocks written
    pool.reserve(1, 14)                     # +1 lookahead block
    blocks, written = pool.extract(1)
    peer = Pool(8, 4)
    peer.alloc(7, 5)
    table = peer.inject(1, 10)
    tiny = Pool(2, 4)
    with pytest.raises(Exhausted):
        tiny.inject(7, 12)                  # needs 3 > 2 blocks
    return (blocks, written, pool.block_table(1), table, peer.seq_len(1),
            peer.free_blocks, tiny.free_blocks)


def test_extract_inject_round_trip_matches_jax_pool():
    from repro.serve.kvpool import KVPool as JKVPool
    from repro.serve.kvpool import PoolExhausted as JExhausted
    from repro_torch.serve import PoolExhausted

    got = pool_round_trip(KVPool, PoolExhausted)
    assert got == pool_round_trip(JKVPool, JExhausted)
    blocks, written, table1, table, seq_len, _, tiny_free = got
    assert written == 10 and blocks == table1[:3] and len(table) == 3
    assert seq_len == 10 and tiny_free == 2


# --------------------------------------------------- landing modes
def wedged_victim(side, steps=7, max_new=30):
    """One sequence mid-decode: written 16 + 4 * steps (44, 6 blocks)."""
    e = side.engine(max_slots=1, **PAGED)
    req = side.R(rid=0, prompt=list(PROMPT16), max_new=max_new)
    e.submit(req)
    for _ in range(steps):
        e.step()
    assert not req.done
    return e, req


def tight_thief(side, **extra):
    """An 8-block pool with a blocker holding 3 blocks (5 free)."""
    e = side.engine(num_blocks=8, **PAGED, **extra)
    blocker = side.R(rid=50, prompt=list(BLOCKER), max_new=8)
    e.submit(blocker)
    e.step()
    assert e.pool.available_blocks == 5
    return e, blocker


def thief_for(side, mode):
    if mode == "live":
        return side.engine(**PAGED), None
    if mode == "seeded":
        return tight_thief(side, prefix_cache=True)
    if mode == "pool_full":
        return tight_thief(side)
    if mode == "block_size":
        return side.engine(paged=True, block_size=16), None
    assert mode == "max_seq"
    return side.engine(max_seq=32, **PAGED), None


def land(side, mode):
    """Migrate the wedged victim's sequence into the mode's thief, drain
    both, and return what the comparison reads."""
    victim, req = wedged_victim(side)
    thief, blocker = thief_for(side, mode)
    mig = victim.migrate_out(victim.migratable_slots()[0])
    kv = {n: np.asarray(b, np.float32) for n, b in mig.kv.items()}
    got = dict(written=mig.written, tokens=list(mig.tokens), kv=kv)
    if mode == "max_seq":
        assert not thief.can_host(mig.written)
        with pytest.raises(ValueError):
            thief.migrate_in(mig)
        victim._requeue_migrated(req)       # the caller still owns it
        got["mode"] = "refused"
    else:
        got["mode"] = thief.migrate_in(mig)
    if got["mode"] == "live":
        table = thief.pool.block_table(req.rid)
        got["landed"] = {n: side.cache(thief, n)[:, table] for n in kv}
    drain(victim, thief)
    reqs = [req] + ([blocker] if blocker is not None else [])
    assert all(r.done for r in reqs)
    got["out"] = [list(r.out) for r in reqs]
    got["stats"] = [counts(victim.stats()), counts(thief.stats())]
    return got


_LANDED = {}


def jax_land(mode):
    if mode not in _LANDED:
        _LANDED[mode] = land(Side(True), mode)
    return _LANDED[mode]


@pytest.mark.parametrize("mode,want", [
    ("live", "live"), ("seeded", "seeded"), ("pool_full", "recompute"),
    ("block_size", "recompute"), ("max_seq", "refused")])
def test_landing_mode_matches_jax(mode, want):
    got, ref = land(Side(False), mode), jax_land(mode)
    assert got["mode"] == ref["mode"] == want
    assert got["written"] == ref["written"] == 44
    assert got["tokens"] == ref["tokens"]
    for n in ("k", "v"):
        assert got["kv"][n].shape == ref["kv"][n].shape == (
            got["kv"][n].shape[0], 6, 8) + got["kv"][n].shape[3:]
        np.testing.assert_allclose(got["kv"][n], ref["kv"][n], atol=1e-5,
                                   rtol=0, err_msg=n)
    if want == "live":
        for n in ("k", "v"):
            # the thief's blocks hold exactly the transfer buffer
            np.testing.assert_array_equal(got["landed"][n], got["kv"][n])
            np.testing.assert_allclose(got["landed"][n], ref["landed"][n],
                                       atol=1e-5, rtol=0)
    assert got["out"] == ref["out"]
    assert got["stats"] == ref["stats"]
    victim, thief = got["stats"]
    assert victim["migrations_out"] == 1
    if want in ("live", "seeded", "recompute"):
        key = "migrations_in" if want == "live" else f"migrations_{want}"
        assert thief[key] == 1
    if want == "seeded":
        assert thief["seeded_tokens"] >= 8 and thief["cache_hits"] >= 1


def test_mid_prefill_slot_is_rejected_like_jax():
    outs = []
    for side in (Side(True), Side(False)):
        e = side.engine(prefill_chunk=4, token_budget=4, **PAGED)
        req = side.R(rid=0, prompt=list(PROMPT16), max_new=5)
        e.submit(req)
        e.step()                            # first chunk only (budget 4)
        assert e.sched.mid_prefill(0) and e.migratable_slots() == []
        with pytest.raises(ValueError, match="mid-prefill"):
            e.migrate_out(0)
        drain(e)
        outs.append((req.out, counts(e.stats())))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ fabrics
FABRIC_PROMPTS = [PROMPT16[: 4 + i] + [20 + i] for i in range(9)]


def fabric(side, n, nreq):
    """``n`` paged replicas of 2 slots, every request on replica 0, which
    steps once before balancing, so that its queue drains to the thieves
    and its saturated slots shed live sequences."""
    engines = [side.engine(replica_id=i, **PAGED) for i in range(n)]
    bal = side.balancer(engines, migrate=True)
    reqs = [side.R(rid=i, prompt=list(FABRIC_PROMPTS[i]),
                   max_new=14 + 3 * i) for i in range(nreq)]
    for r in reqs:
        bal.submit(r, rr=0)
    engines[0].step()
    assert bal.run(max_steps=300) == "terminated"
    assert all(r.done for r in reqs)
    return dict(out=[list(r.out) for r in reqs], decisions=bal.decisions,
                balancer=bal.collect()["_balancer"],
                stats=[counts(e.stats()) for e in engines],
                report=bal.report())


@pytest.mark.parametrize("arch,n,nreq,mode", [
    (TINY, 2, 2, "live"), (TINY, 3, 5, "live"),
    ("moonshot-v1-16b-a3b", 2, 2, "live"),
    ("mamba2-130m", 2, 2, "recompute")])
def test_migrating_fabric_matches_jax(arch, n, nreq, mode):
    got = fabric(Side(False, arch), n, nreq)
    ref = fabric(Side(True, arch), n, nreq)
    assert got["out"] == ref["out"]
    assert got["decisions"] == ref["decisions"]
    assert any(d[0] == "live" and d[-1] == mode for d in got["decisions"])
    assert got["balancer"] == ref["balancer"]
    assert got["balancer"]["migrations"] >= 1
    assert got["stats"] == ref["stats"]
    assert got["report"].splitlines()[-1] == ref["report"].splitlines()[-1]
