"""The port's GLB task executor (``repro_torch.core.run_sim`` / ``GLB``)
against ``repro.core`` on the paper's problems (fib, UTS, BC), on the CPU.

The random round's victims are the JAX reference's own draws
(``randint(fold_in(key(seed), step), (P, w), 0, P - 1)``) passed to the
port as ``candidates``, so the two schedules are the same superstep for
superstep: result, per-place results, supersteps and all ten counters
must be equal. BC's betweenness is float32 summed in another order (the
frontier products), so it is held to rtol 1e-5; its supersteps and
counters, which depend only on integer levels and on ``reach > 0``, are
exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.autotune import autotune as jautotune
from repro.obs import Tracer as JTracer
from repro.problems import bc as jbc
from repro.problems import fib as jfib
from repro.problems import rmat as jrmat
from repro.problems import uts as juts
from repro.serve.faults import FaultInjector as JFaults
from repro_torch import core
from repro_torch.core.autotune import autotune
from repro_torch.core.scheduler import reduce_result
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.problems import bc, fib, rmat, uts
from repro_torch.serve.faults import FaultInjector


def _jax_candidates(seed):
    def cand(step, P, w):
        if P < 2 or w <= 0:
            return np.zeros((P, 0), np.int32)
        key = jax.random.fold_in(jax.random.key(seed), step)
        draws = np.asarray(jax.random.randint(key, (P, w), 0, P - 1))
        return (np.arange(P)[:, None] + 1 + draws) % P
    return cand


def _jparams(params):
    return jcore.GLBParams(**dataclasses.asdict(params))


def _compare(jprob, prob, P, params, seed=0, rtol=None, jfaults=None,
             faults=None):
    want = jcore.run_sim(jprob, P, _jparams(params), seed=seed,
                         faults=jfaults)
    got = core.run_sim(prob, P, params, seed=seed, faults=faults,
                       candidates=_jax_candidates(seed), device="cpu")
    assert got.supersteps == int(want.supersteps)
    assert got.converged == bool(want.converged)
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        np.testing.assert_array_equal(got.stats[k].numpy(),
                                      np.asarray(want.stats[k]), err_msg=k)
    if rtol is None:
        np.testing.assert_array_equal(got.per_place.numpy(),
                                      np.asarray(want.per_place))
        np.testing.assert_array_equal(got.result.numpy(),
                                      np.asarray(want.result))
    else:
        np.testing.assert_allclose(got.per_place.numpy(),
                                   np.asarray(want.per_place), rtol=rtol,
                                   atol=1e-6)
        np.testing.assert_allclose(got.result.numpy(),
                                   np.asarray(want.result), rtol=rtol)
    return got


@pytest.mark.parametrize("P", [1, 3, 8])
def test_fib_matches_jax(P):
    got = _compare(jfib.fib_problem(16), fib.fib_problem(16), P,
                   core.GLBParams(n=16, steal_k=16))
    assert int(got.result) == fib.fib_oracle(16)


@pytest.mark.parametrize("params", [
    core.GLBParams(n=8, w=1, z=1, steal_k=4),
    core.GLBParams(n=64, w=4, z=3, steal_k=64),
    core.GLBParams(n=256, w=0, z=0, steal_k=16),   # pure-lifeline mode
    core.GLBParams(n=32, w=2, z=2, steal_k=8, min_give=4),
])
def test_uts_matches_jax(params):
    got = _compare(juts.uts_problem(depth=6), uts.uts_problem(depth=6), 4,
                   params)
    assert int(got.result) == uts.uts_oracle(depth=6)


@pytest.mark.parametrize("P,depth,seed", [(3, 6, 0), (8, 7, 1)])
def test_uts_place_counts_match_jax(P, depth, seed):
    got = _compare(juts.uts_problem(depth=depth),
                   uts.uts_problem(depth=depth), P,
                   core.GLBParams(n=64, steal_k=32), seed=seed)
    assert int(got.result) == uts.uts_oracle(depth=depth)
    assert int(got.stats["items_sent"].sum()) == \
        int(got.stats["items_recv"].sum())


def test_uts_narrow_gen_width_matches_jax():
    """gen_width below n: JAX's expansion width, not the budget."""
    _compare(juts.uts_problem(depth=5, gen_width=8),
             uts.uts_problem(depth=5, gen_width=8), 4,
             core.GLBParams(n=32, steal_k=16))


@pytest.mark.parametrize("scale,static_init,P", [(5, True, 4),
                                                  (5, False, 4),
                                                  (6, True, 3)])
def test_bc_matches_jax(scale, static_init, P):
    adj, n = jrmat.rmat_graph(scale=scale, seed=11)
    np.testing.assert_array_equal(rmat.rmat_graph(scale=scale, seed=11)[0],
                                  adj)
    got = _compare(jbc.bc_problem(adj, capacity=256,
                                  static_init=static_init),
                   bc.bc_problem(adj, capacity=256, static_init=static_init),
                   P, core.GLBParams(n=8, steal_k=8), rtol=1e-5)
    oracle = rmat.brandes_bc_oracle(adj)
    np.testing.assert_allclose(oracle, jrmat.brandes_bc_oracle(adj))
    np.testing.assert_allclose(got.result.numpy(), oracle, rtol=1e-4,
                               atol=1e-3)


def test_glb_api_matches_jax_and_traced_equals_untraced():
    jglb = jcore.GLB(juts.uts_problem(depth=4), jcore.GLBParams(n=8), P=4)
    want = jglb.run(seed=0)
    glbs = [core.GLB(uts.uts_problem(depth=4), core.GLBParams(n=8), P=4,
                     device="cpu") for _ in range(2)]
    tr = Tracer()
    got = [g.run(seed=0, candidates=_jax_candidates(0), tracer=t)
           for g, t in zip(glbs, (None, tr))]
    for g, r in zip(glbs, got):
        assert int(r) == int(want)
        assert g.supersteps == jglb.supersteps
        for f in jglb.stats:
            np.testing.assert_array_equal(g.stats[f],
                                          np.asarray(jglb.stats[f]), f)
    assert "GLB stats over 4 places" in glbs[1].stats_summary()
    # the trace has JAX's shape: one span per superstep, the load counter
    jtr = JTracer()
    jcore.GLB(juts.uts_problem(depth=4), jcore.GLBParams(n=8),
              P=4).run(seed=0, tracer=jtr)
    tr.flush()
    assert validate_chrome_trace(tr.to_chrome()) == []
    for t in (tr, jtr):
        spans = [e for e in t.events if e.get("ph") == "B"
                 and e["name"] == "superstep"]
        loads = [e for e in t.events if e.get("ph") == "C"
                 and e["name"] == "glb_load"]
        assert len(spans) == len(loads) == glbs[1].supersteps
        assert loads[-1]["args"]["total"] == 0.0
    shape = lambda t: [(e["ph"], e.get("name"), sorted(e.get("args", {})))
                       for e in t.events]
    assert shape(tr) == shape(jtr)


@pytest.mark.parametrize("case", ["fib-crash", "uts-crash-root",
                                  "bc-crash-evacuate", "fib-hang"])
def test_faults_match_jax(case):
    """The failure protocol's cases of the JAX package's fault tests:
    exact against the JAX run under the same faults."""
    if case == "fib-crash":
        probs = jfib.fib_problem(16), fib.fib_problem(16)
        params, fault = core.GLBParams(n=16, steal_k=16), ("crash", 1, 2)
        want_result = fib.fib_oracle(16)
    elif case == "uts-crash-root":
        probs = juts.uts_problem(depth=5), uts.uts_problem(depth=5)
        params, fault = core.GLBParams(n=32, steal_k=16), ("crash", 0, 2)
        want_result = uts.uts_oracle(depth=5)
    elif case == "bc-crash-evacuate":
        adj, _ = jrmat.rmat_graph(scale=4, seed=7)
        probs = (jbc.bc_problem(adj, capacity=256),
                 bc.bc_problem(adj, capacity=256))
        params, fault = core.GLBParams(n=4, steal_k=8), ("crash", 2, 3)
        want_result = None
    else:
        probs = jfib.fib_problem(14), fib.fib_problem(14)
        params, fault = core.GLBParams(n=16, steal_k=16), ("hang", 1, 1)
        want_result = fib.fib_oracle(14)
    kind, place, at = fault
    inj = [F() for F in (JFaults, FaultInjector)]
    for f in inj:
        if kind == "crash":
            f.crash(place, at=at)
        else:
            f.hang(place, at=at, duration=2)
    got = _compare(*probs, 4, params, jfaults=inj[0], faults=inj[1],
                   rtol=1e-5 if want_result is None else None)
    assert [(f.kind, f.place, f.at) for f in inj[1].fired] == \
        [(f.kind, f.place, f.at) for f in inj[0].fired]
    if want_result is not None:
        assert int(got.result) == want_result


def test_faults_traced_and_hook_required():
    tr = Tracer()
    core.run_sim(fib.fib_problem(12), 4, core.GLBParams(n=8, steal_k=8),
                 faults=FaultInjector().crash(1, at=2), tracer=tr,
                 device="cpu")
    names = [e.get("name") for e in tr.events if e.get("ph") == "i"]
    assert names == ["place_dead", "bag_recovered"]
    adj, _ = rmat.rmat_graph(scale=3, seed=7)
    prob = dataclasses.replace(bc.bc_problem(adj), evacuate=None)
    with pytest.raises(ValueError, match="no evacuate hook"):
        core.run_sim(prob, 2, faults=FaultInjector(), device="cpu")


def test_autotune_matches_jax():
    kw = dict(w_grid=(0, 2), z_grid=(0,), n_grid=(32, 128), seed=0)
    want = jautotune(juts.uts_problem(depth=4), 4, **kw)
    got = autotune(uts.uts_problem(depth=4), 4,
                   candidates=_jax_candidates(0), device="cpu", **kw)
    assert dataclasses.asdict(got.best) == dataclasses.asdict(want.best)
    assert [(dataclasses.asdict(p), s, i) for p, s, i in got.table] == \
        [(dataclasses.asdict(p), s, i) for p, s, i in want.table]


def test_default_candidates_seed_and_errors():
    prob = uts.uts_problem(depth=5)
    runs = [core.run_sim(prob, 4, core.GLBParams(n=16), seed=s,
                         device="cpu") for s in (0, 1, 0)]
    assert all(int(r.result) == uts.uts_oracle(depth=5) for r in runs)
    assert runs[0].supersteps == runs[2].supersteps
    assert set(runs[0].host_ms) == {"process", "match", "transfer"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        core.GLB(prob, mode="shard_map")
    with pytest.raises(ValueError, match="needs P"):
        core.GLB(prob)
    glb = core.GLB(prob, core.GLBParams(max_supersteps=3), P=2,
                   device="cpu")
    with pytest.raises(RuntimeError, match="max_supersteps"):
        glb.run()
    assert not glb.last_run.converged and glb.supersteps == 3
    x = torch.tensor([[1, 5], [3, 2]])
    assert reduce_result(x, "sum").tolist() == [4, 7]
    assert reduce_result(x, "max").tolist() == [3, 5]
    assert reduce_result(x, "min").tolist() == [1, 2]
    with pytest.raises(ValueError, match="unknown reduce op"):
        reduce_result(x, "mean")
