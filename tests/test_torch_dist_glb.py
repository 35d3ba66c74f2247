"""The port's distributed GLB executor (``GLB(mode="shard_map")``, one
place per process) against ``repro.core`` on the paper's problems, on
gloo ranks of the CPU.

One world of 8 ranks runs every case: P 8 on a (8,) ``place`` mesh, and
P 4 on a (2, 4) (``data``, ``place``) mesh, whose two halves run the same
case side by side. With the JAX reference's own random-round draws
injected (``candidates``), each case equals the JAX ``run_sim``: result,
supersteps, all ten counters per place and ``per_place`` (BC's
betweenness is float32 summed in another order, so it is held to rtol
1e-5, as in ``test_torch_sim.py``; its counters and supersteps are
exact). With the port's default draws it equals the port's ``run_sim``.
Every rank returns the same values. One case is held against JAX's own
``GLB(mode="shard_map")`` on 8 host devices, in a subprocess.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_dist_ranks as R
from repro import core as jcore
from repro.problems import bc as jbc
from repro.problems import fib as jfib
from repro.problems import uts as juts
from repro_torch import core
from repro_torch.problems import bc, fib, rmat, uts

WORLD = 8
jprobs = {"uts": juts, "fib": jfib, "bc": jbc}
tprobs = {"uts": uts, "fib": fib, "bc": bc}
P8 = ((8,), ("place",))
P4 = ((2, 4), ("data", "place"))
ADJ = rmat.rmat_graph(scale=6, seed=11)[0]
PROBLEMS = {
    "uts": (("uts", dict(depth=6)), lambda m: m.uts_problem(depth=6)),
    "fib": (("fib", dict(n=15)), lambda m: m.fib_problem(15)),
    "bc": (("bc", dict(adj=ADJ, capacity=256)),
           lambda m: m.bc_problem(ADJ, capacity=256)),
}
PARAMS = {"uts": dict(n=64, w=2, steal_k=32),
          "uts-w0": dict(n=64, w=0, steal_k=32),
          "fib": dict(n=8, steal_k=8),
          "bc": dict(n=8, steal_k=8)}
# (id, problem, params, routing, mesh, draws: "jax" or "default")
CASES = [
    (f"{name}-{routing}-P{mesh[0][-1]}", prob, par, routing, mesh, "jax")
    for mesh in (P8, P4)
    for name, prob, par, routing in (
        ("uts", "uts", "uts", "dense"), ("uts", "uts", "uts", "lifeline"),
        ("uts-w0", "uts", "uts-w0", "lifeline"),
        ("fib", "fib", "fib", "dense"), ("fib", "fib", "fib", "lifeline"),
        ("bc", "bc", "bc", "dense"), ("bc", "bc", "bc", "lifeline"))
] + [
    ("uts-dense-P8-default", "uts", "uts", "dense", P8, "default"),
    ("uts-lifeline-P8-default", "uts", "uts", "lifeline", P8, "default"),
    ("fib-lifeline-P4-default", "fib", "fib", "lifeline", P4, "default"),
    ("bc-dense-P4-default", "bc", "bc", "dense", P4, "default"),
]

JAX_SHARDMAP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax
from repro.core import GLB, GLBParams
from repro.problems.uts import uts_problem

mesh = jax.make_mesh((8,), ("place",))
out = {}
for routing in ("dense", "lifeline"):
    glb = GLB(uts_problem(depth=6), GLBParams(n=64, w=2, steal_k=32),
              mesh=mesh, mode="shard_map", routing=routing)
    out[routing] = dict(
        result=int(glb.run(seed=0)), supersteps=glb.supersteps,
        stats={k: np.asarray(v).tolist() for k, v in glb.stats.items()},
        per_place=np.asarray(glb.last_run.per_place).tolist())
print("RESULT" + json.dumps(out))
"""


def _draws(seed, P, w, steps):
    """The JAX reference's random-round victims of supersteps
    [0, steps), as ``test_torch_sim._jax_candidates`` draws them."""
    if P < 2 or w <= 0:
        return np.zeros((steps, P, 0), np.int32)
    out = []
    for step in range(steps):
        key = jax.random.fold_in(jax.random.key(seed), step)
        d = np.asarray(jax.random.randint(key, (P, w), 0, P - 1))
        out.append((np.arange(P)[:, None] + 1 + d) % P)
    return np.asarray(out, np.int32)


# Supersteps of JAX draws handed to the ranks; every case here drains in
# fewer (a run that needed more would fail on the table's end).
DRAW_STEPS = 256


def _jax_sim(prob, par, P):
    sim = jcore.run_sim(PROBLEMS[prob][1](jprobs[prob]), P,
                        jcore.GLBParams(**PARAMS[par]), seed=0)
    return dict(result=np.asarray(sim.result),
                per_place=np.asarray(sim.per_place),
                stats={k: np.asarray(v) for k, v in sim.stats.items()},
                supersteps=int(sim.supersteps))


def _port_sim(prob, par, P):
    sim = core.run_sim(PROBLEMS[prob][1](tprobs[prob]), P,
                       core.GLBParams(**PARAMS[par]), seed=0, device="cpu")
    return dict(result=sim.result.numpy(), per_place=sim.per_place.numpy(),
                stats={k: v.numpy() for k, v in sim.stats.items()},
                supersteps=sim.supersteps)


@pytest.fixture(scope="module")
def runs():
    """The rank world and the JAX shard_map subprocess run while this
    process computes the references."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    draws, cases = {}, []
    for cid, prob, par, routing, mesh, kind in CASES:
        P, w = mesh[0][-1], core.GLBParams(**PARAMS[par]).w
        if kind == "jax" and (P, w) not in draws:
            draws[P, w] = _draws(0, P, w, DRAW_STEPS)
        cases.append(dict(problem=PROBLEMS[prob][0], params=PARAMS[par],
                          routing=routing, mesh=mesh,
                          cand=draws[P, w] if kind == "jax" else None))
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SHARDMAP],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        world = pool.submit(R.spawn, R.glb_cases, WORLD, cases)
        wants, sims = {}, {}
        for cid, prob, par, routing, mesh, kind in CASES:
            key = (kind, prob, par, mesh[0][-1])
            if key not in sims:     # JAX's run_sim has no routing
                sims[key] = (_jax_sim if kind == "jax" else _port_sim)(
                    *key[1:])
            wants[cid] = sims[key]
        got = world.result(timeout=600)
        stdout, stderr = jax_proc.communicate(timeout=600)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, stderr[-4000:]
    line = [l for l in stdout.splitlines() if l.startswith("RESULT")][-1]
    jax_shardmap = json.loads(line[len("RESULT"):])
    by_id = {c[0]: [got[r][i] for r in range(WORLD)]
             for i, c in enumerate(CASES)}
    return wants, by_id, jax_shardmap


def _check(got, want, exact):
    assert got["converged"]
    assert got["supersteps"] == want["supersteps"]
    assert set(got["stats"]) == set(want["stats"]) == set(core.stats.FIELDS)
    for k in want["stats"]:
        np.testing.assert_array_equal(got["stats"][k], want["stats"][k],
                                      err_msg=k)
    if exact:
        np.testing.assert_array_equal(got["per_place"], want["per_place"])
        np.testing.assert_array_equal(got["result"], want["result"])
    else:
        np.testing.assert_allclose(got["per_place"], want["per_place"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["result"], want["result"], rtol=1e-5)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_shard_map_matches_reference(runs, cid):
    wants, by_id, _ = runs
    ranks = by_id[cid]
    _check(ranks[0], wants[cid], exact=not cid.startswith("bc"))
    for other in ranks[1:]:         # every rank holds the same answer
        assert other["supersteps"] == ranks[0]["supersteps"]
        np.testing.assert_array_equal(other["result"], ranks[0]["result"])
        for k in ranks[0]["stats"]:
            np.testing.assert_array_equal(other["stats"][k],
                                          ranks[0]["stats"][k])
    assert ranks[0]["phases"] == sorted(core.executor.PHASES)
    if cid.startswith("uts"):
        assert int(ranks[0]["result"]) == uts.uts_oracle(depth=6)
    if cid.startswith("fib"):
        assert int(ranks[0]["result"]) == fib.fib_oracle(15)


@pytest.mark.parametrize("cid", ["uts-dense-P4", "uts-lifeline-P8",
                                 "uts-w0-lifeline-P8", "fib-dense-P8"])
def test_wire_bytes_per_superstep(runs, cid):
    """What each rank hands to the collectives per superstep: the
    (size, in-state work) gather, then dense: a (P, K, item) buffer per
    item field and the (P,) counts; lifeline: z masked packets of K items
    and a count, plus the dense buffer for the random round unless w == 0."""
    _, by_id, _ = runs
    case = next(c for c in CASES if c[0] == cid)
    P = case[4][0][-1]
    params = core.GLBParams(**PARAMS[case[2]])
    spec = PROBLEMS[case[1]][1](tprobs[case[1]]).item_spec
    item = sum(int(np.prod(s, dtype=np.int64)) * dt.itemsize
               for s, dt in spec.values())
    K, z = params.steal_k, params.resolve_z(P)
    dense = P * K * item + P * 4
    want = 8 + (dense if case[3] == "dense" else
                z * (K * item + 4) + (dense if params.w else 0))
    for r in by_id[cid]:
        assert r["wire_bytes"] == want * r["supersteps"]


@pytest.mark.parametrize("routing", ["dense", "lifeline"])
def test_equals_jax_shard_map(runs, routing):
    """JAX's own shard_map executor on 8 host devices and the port's
    executor on 8 ranks, both with JAX's draws: the same run."""
    _, by_id, jax_sm = runs
    want = jax_sm[routing]
    got = by_id[f"uts-{routing}-P8"][0]
    assert int(got["result"]) == want["result"]
    assert got["supersteps"] == want["supersteps"]
    for k, v in want["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], np.asarray(v),
                                      err_msg=k)
    np.testing.assert_array_equal(got["per_place"],
                                  np.asarray(want["per_place"]))


def test_glb_shard_map_errors():
    """The reference's refusals, before any rank is needed."""
    class Mesh:                       # shape and names, as a DeviceMesh
        shape = (2,)
        mesh_dim_names = ("place",)

    prob = fib.fib_problem(8)
    with pytest.raises(ValueError, match="needs a mesh"):
        core.GLB(prob, mode="shard_map")
    glb = core.GLB(prob, mesh=Mesh(), mode="shard_map", device="cpu")
    assert glb.P == 2
    with pytest.raises(ValueError, match="sim"):
        glb.run(faults=object())
    tracer = dataclasses.make_dataclass("T", [("enabled", bool)])(True)
    with pytest.raises(ValueError, match="sim"):
        glb.run(tracer=tracer)
    with pytest.raises(ValueError, match="unknown mode"):
        core.GLB(prob, P=2, mode="pmap")
