"""Replica faults in the port's serving fabric against the JAX balancer.

Each case runs the same ``FaultInjector`` schedule (the JAX package's on
its side, the port's copy on the other) over the same weights and
requests, with the JAX random-round draws injected: the port must emit
the JAX fabric's tokens, ``decisions``, ``collect()["_balancer"]``, the
counts of every replica's ``stats()`` and the liveness vector exactly,
and raise where it raises. Every crash-free reference run is
token-identical to the faulted one (the reference's own invariant), so
the two-replica cases are held to a three-replica clean run too.
"""
import numpy as np
import pytest

from repro.serve.faults import FaultInjector as JFaults
from repro_torch.serve import FaultInjector
from test_torch_migrate import PROMPT16, Side, counts

KW3 = dict(paged=True, block_size=8, num_blocks=64)


def faults(side):
    return JFaults() if side.jax else FaultInjector()


def fabric(side, schedule=None, n=3, heartbeat_misses=None, nreq=4,
           max_new=6, max_steps=300, late=False):
    engines = [side.engine(replica_id=i, **KW3) for i in range(n)]
    inj = schedule(faults(side)) if schedule else None
    bal = side.balancer(engines, migrate=True, faults=inj,
                        heartbeat_misses=heartbeat_misses)
    reqs = [side.R(rid=i, prompt=list(PROMPT16), max_new=max_new)
            for i in range(nreq)]
    for r in reqs:
        bal.submit(r)
    status = bal.run(max_steps=max_steps)
    steps0 = engines[0].steps
    if late:
        # a request after the death: routed around the fenced zombie
        reqs.append(side.R(rid=99, prompt=list(PROMPT16), max_new=4))
        bal.submit(reqs[-1])
        status = (status, bal.run(max_steps=max_steps))
        assert engines[0].steps == steps0
    return dict(status=status, out=[list(r.out) for r in reqs],
                done=[r.done for r in reqs], decisions=bal.decisions,
                balancer=bal.collect()["_balancer"], alive=bal.alive,
                stats=[counts(e.stats()) for e in engines],
                buddies=np.asarray(bal._buddies).tolist(),
                pending=np.asarray(bal._pending).tolist(),
                report=[ln for ln in bal.report().splitlines()
                        if ln.startswith(("  balancer:", "  failures:"))])


def both(**kw):
    got, ref = fabric(Side(False), **kw), fabric(Side(True), **kw)
    assert got == ref
    return got


_CLEAN = {}


def clean(max_new):
    if max_new not in _CLEAN:
        _CLEAN[max_new] = fabric(Side(False), max_new=max_new)["out"]
    return _CLEAN[max_new]


@pytest.mark.parametrize("crash_at", [0, 1, 2, 4])
def test_crash_sweep_matches_jax(crash_at):
    got = both(schedule=lambda f: f.crash(0, at=crash_at), max_new=24)
    assert got["status"] == "terminated" and all(got["done"])
    assert got["alive"] == [False, True, True]
    b = got["balancer"]
    assert b["replicas_dead"] == 1
    assert b["readmitted_queued"] + b["readmitted_running"] >= 1
    assert got["out"] == clean(24)
    for p in (1, 2):
        assert 0 not in got["buddies"][p]
    assert not any(got["pending"][0]) and not any(
        row[0] for row in got["pending"])
    assert any("failures: 1 replica(s) dead" in ln for ln in got["report"])


def test_hang_shorter_than_window_matches_jax():
    got = both(schedule=lambda f: f.hang(0, at=1, duration=2), n=2)
    b = got["balancer"]
    assert b["replicas_dead"] == 0 and all(got["alive"])
    assert b["readmitted_queued"] == b["readmitted_running"] == 0
    assert got["out"] == clean(6)


def test_slow_replica_is_not_declared_dead_like_jax():
    got = both(schedule=lambda f: f.slow(0, at=0, factor=3), n=2,
               max_steps=600)
    assert got["status"] == "terminated" and all(got["alive"])
    assert got["balancer"]["replicas_dead"] == 0
    assert got["out"] == clean(6)


def test_zombie_is_fenced_like_jax():
    got = both(schedule=lambda f: f.hang(0, at=1, duration=8), n=2,
               heartbeat_misses=2, late=True)
    assert got["status"] == ("terminated", "terminated")
    assert all(got["done"]) and got["alive"][0] is False
    assert got["out"][:4] == clean(6)


def running_readmission(side):
    victim = side.engine(replica_id=0, **KW3)
    survivor = side.engine(replica_id=1)             # contiguous
    bal = side.balancer([victim, survivor], migrate=True,
                        faults=faults(side).crash(0, at=2))
    bal.submit(side.R(rid=0, prompt=list(PROMPT16), max_new=40), rr=0)
    victim.step()                                    # now running
    with pytest.raises(RuntimeError, match="no surviving paged"):
        bal.run(max_steps=100)
    return bal.decisions, bal.supersteps, bal.alive


def test_running_readmission_needs_a_compatible_host_like_jax():
    assert running_readmission(Side(False)) == running_readmission(
        Side(True))


@pytest.mark.parametrize("jax_side", [True, False])
def test_all_replicas_dead_raises(jax_side):
    side = Side(jax_side)
    engines = [side.engine(replica_id=i, **KW3) for i in range(2)]
    bal = side.balancer(engines, migrate=True,
                        faults=faults(side).crash(0, at=0).crash(1, at=0))
    bal.submit(side.R(rid=0, prompt=list(PROMPT16), max_new=4))
    with pytest.raises(RuntimeError):
        bal.run(max_steps=100)


def test_run_returns_wedged_like_jax():
    got = both(n=1, nreq=1, max_new=40, max_steps=2)
    assert got["status"] == "wedged" and got["done"] == [False]
