"""The port's lifeline core and replica balancer against the JAX package.

Host logic must match exactly: the buddy tables, re-wiring, diffusion
pairs, termination, and ``match_steals`` over random cases, with the JAX
reference's random-round draws (``randint`` from the superstep-folded
key) passed to the port as its candidates. The balancer runs fabrics of 2
and 3 replicas (contiguous and paged engines mixed) on
``mamba2-130m.smoke()`` and ``tinyllama-1.1b.smoke()``, and of 2 on
``moonshot-v1-16b-a3b.smoke()`` at its own capacity factor 1.25, with
every request placed on replica 0: the port must emit the JAX fabric's
tokens, its ``decisions`` log and its ``collect()["_balancer"]``
counters. (The JAX MoE engines decode through the interpret-mode Pallas
kernels, whose idle-slot attention the port follows; see
``test_torch_engine.py``.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as jcore
from repro.configs import ARCHS
from repro.models import init_lm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import GLBReplicaBalancer as JBalancer
from repro.serve.engine import Request as JRequest
from repro_torch import core
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.serve import Engine, GLBReplicaBalancer, Request
from repro_torch.weights import params_from_jax

PARAMS = core.GLBParams()
_jit_match = jax.jit(jcore.match_steals, static_argnames=("params",))


def _jax_candidates(step, P, w):
    """The random round's victims the JAX balancer draws at ``step``."""
    key = jax.random.fold_in(jax.random.key(17), step)
    if P < 2:
        return np.zeros((P, 0), np.int32)
    draws = np.asarray(jax.random.randint(key, (P, w), 0, P - 1))
    return (np.arange(P)[:, None] + 1 + draws) % P


# ------------------------------------------------------------ topology
@pytest.mark.parametrize("P", [1, 2, 3, 5, 8, 12])
def test_topology_matches_jax(P):
    z = PARAMS.resolve_z(P)
    assert z == jcore.GLBParams().resolve_z(P)
    np.testing.assert_array_equal(core.lifeline_buddies(P, z),
                                  jcore.lifeline_buddies(P, z))
    np.testing.assert_array_equal(core.lifeline_mask(P, z),
                                  jcore.lifeline_mask(P, z))
    rng = np.random.default_rng(P)
    for _ in range(6):
        alive = rng.random(P) < 0.6
        alive[rng.integers(P)] = True
        np.testing.assert_array_equal(core.rewire_lifelines(alive, z),
                                      jcore.rewire_lifelines(alive, z))
        costs = rng.integers(0, 5, P) * rng.random(P)
        elig = rng.random(P) < 0.7
        for e in (None, elig):
            assert (core.diffusion_pairs(costs, 0.25, e)
                    == jcore.diffusion_pairs(costs, 0.25, e))
        loads = rng.integers(0, 2, P) * (rng.random() < 0.5)
        assert core.terminated(loads) == jcore.terminated(loads)
    with pytest.raises(ValueError):
        core.rewire_lifelines(np.zeros(P, bool), z)


@pytest.mark.parametrize("P", [1, 2, 3, 5, 8])
def test_match_steals_matches_jax(P):
    z = PARAMS.resolve_z(P)
    buddies = core.lifeline_buddies(P, z)
    rng = np.random.default_rng(100 + P)
    for step in range(8):
        sizes = rng.integers(0, 4, P).astype(np.int32)
        hungry = rng.random(P) < 0.5
        pending = rng.random((P, P)) < 0.3
        for params in (PARAMS, core.GLBParams(w=1, min_give=2)):
            key = jax.random.fold_in(jax.random.key(17), step)
            want = _jit_match(jnp.asarray(sizes), jnp.asarray(hungry),
                              jnp.asarray(pending), key,
                              jnp.asarray(buddies),
                              jcore.GLBParams(w=params.w,
                                              min_give=params.min_give))
            got = core.match_steals(sizes, hungry, pending,
                                    _jax_candidates(step, P, params.w),
                                    buddies, params)
            for name, a, b in zip(core.MatchResult._fields, got, want):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    got = core.match_steals(sizes, hungry, pending, np.zeros((P, 0)),
                            buddies, core.GLBParams(no_steal=True))
    assert (got.src == -1).all() and (got.pending == pending).all()


def test_random_candidates_never_pick_the_thief():
    rng = np.random.default_rng(0)
    for P in (2, 3, 7):
        c = core.random_candidates(rng, P, 4)
        assert c.shape == (P, 4) and c.min() >= 0 and c.max() < P
        assert (c != np.arange(P)[:, None]).all()
    assert core.random_candidates(rng, 1, 2).shape == (1, 0)


def test_merge_place_stats_and_summary_match_jax():
    per = [{"tokens_out": 10, "steps": 3}, {"tokens_out": 4, "hits": 2}]
    assert core.merge_place_stats(per) == jcore.merge_place_stats(per)
    merged = core.merge_place_stats(per)
    for arg, places in ((per, None), (merged, 2)):
        assert (core.fabric_summary(arg, places=places)
                == jcore.fabric_summary(arg, places=places))


# ------------------------------------------------------------ balancer
_SETUP = {}
KW = dict(max_slots=2, max_seq=64, pad_len=16, steps_per_sync=4)
SHARED = [7, 3, 9, 2, 5, 8, 6, 4, 1, 2, 3, 4]


def _setup(arch):
    if arch not in _SETUP:
        cfg = ARCHS[arch].smoke()
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, decode_impl="decode_interpret")
        jp = init_lm(jax.random.key(0), cfg)
        tcfg = T_ARCHS[arch].smoke()
        _SETUP[arch] = (cfg, jp, tcfg, params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return _SETUP[arch]


def _fabric(E, B, R, cfg, params, n, nreq, **kw):
    extra = {} if E is JEngine else dict(device="cpu")
    engines = [E(cfg, params, replica_id=i, **KW, **extra,
                 **(dict(paged=True, block_size=8) if i % 2 else {}))
               for i in range(n)]
    bal = B(engines, **kw)
    reqs = [R(rid=i, prompt=SHARED[: 4 + i % 9] + [10 + i],
              max_new=5 + i % 4) for i in range(nreq)]
    for r in reqs:
        bal.submit(r, rr=0)                # adversarial: all on replica 0
    return bal, reqs


@pytest.mark.parametrize("arch", ["mamba2-130m", "tinyllama-1.1b"])
@pytest.mark.parametrize("n,nreq", [(2, 6), (3, 9)])
def test_balancer_matches_jax(arch, n, nreq):
    _balancer_matches_jax(arch, n, nreq)


def test_moe_balancer_matches_jax():
    _balancer_matches_jax("moonshot-v1-16b-a3b", 2, 6)


def _balancer_matches_jax(arch, n, nreq):
    cfg, jp, tcfg, tp = _setup(arch)
    jb, jreqs = _fabric(JEngine, JBalancer, JRequest, cfg, jp, n, nreq)
    tb, treqs = _fabric(Engine, GLBReplicaBalancer, Request, tcfg, tp, n,
                        nreq, candidates=_jax_candidates)
    assert jb.run(max_steps=300) == "terminated"
    assert tb.run(max_steps=300) == "terminated"
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert tb.decisions == jb.decisions and tb.queue_moves > 0
    assert tb.collect()["_balancer"] == jb.collect()["_balancer"]
    got, want = tb.collect(), jb.collect()
    for field in ("tokens_out", "steps", "host_syncs"):
        assert got[field] == want[field], field
    assert "balancer:" in tb.report() and "terminated=True" in tb.report()
    assert (tb.merged_metrics().snapshot()["requests_finished"]
            == len(treqs))


def test_balancer_default_candidates_and_unported_options():
    _, _, tcfg, tp = _setup("mamba2-130m")
    bal, reqs = _fabric(Engine, GLBReplicaBalancer, Request, tcfg, tp, 3, 9)
    assert bal.run(max_steps=300) == "terminated"
    assert all(r.done for r in reqs) and bal.queue_moves > 0
    # Tier 2, faults, the cost model and the SLO monitor are ported: the
    # balancer takes them; predictive balancing without a cost model is
    # refused with the reference's ValueError.
    from repro_torch.obs import SLOMonitor, parse_slo_spec
    from repro_torch.serve import CostModel, FaultInjector

    e = [Engine(tcfg, tp, device="cpu", **KW)]
    slo = SLOMonitor(parse_slo_spec("ttft_ms=1000"))
    cm = CostModel()
    bal = GLBReplicaBalancer(e, migrate=True, faults=FaultInjector(),
                             cost_model=cm, predictive=True, slo=slo)
    assert e[0].cost_model is cm and e[0].slo is slo
    assert bal.migrate and bal.predictive and bal.alive == [True]
    with pytest.raises(ValueError, match="cost_model"):
        GLBReplicaBalancer(e, predictive=True)
    wedge = GLBReplicaBalancer(e)
    wedge.submit(Request(rid=0, prompt=[1, 2], max_new=40))
    assert wedge.run(max_steps=2) == "wedged"
