"""The port's cost model, predictive balancing and SLO-aware admission
against the JAX package's.

Held exactly: the decode-length predictor and ``CostModel`` over one
sequence of stamps and finishes (predictions, errors, snapshot), each
request's price, and the predictive fabrics' tokens, ``decisions`` (their
``("diffuse", ...)`` and ``("diffuse_live", ...)`` tuples included),
``collect()["_balancer"]`` and ``["_cost"]``, with the JAX random-round
draws injected. SLO-aware admission reads the host clock, so it is held
with explicit queue times, as the reference's own tests hold it.
"""
import dataclasses

import pytest

from repro.obs.slo import SLOMonitor as JSLOMonitor
from repro.obs.slo import parse_slo_spec as j_parse_slo_spec
from repro.serve import CostModel as JCostModel
from repro.serve import CostParams as JCostParams
from repro_torch.obs import SLOMonitor, parse_slo_spec
from repro_torch.serve import CostModel, CostParams
from test_torch_migrate import Side, counts

SMALL = dict(max_slots=2, max_seq=64, pad_len=16, steps_per_sync=4,
             paged=True, block_size=8)


def cost_model(side, **kw):
    return (JCostModel(JCostParams(**kw)) if side.jax
            else CostModel(CostParams(**kw)))


def test_cost_params_defaults_are_the_references():
    assert dataclasses.asdict(CostParams()) == dataclasses.asdict(
        JCostParams())
    assert (CostParams().us_per_prefill_token,
            CostParams().us_per_decode_token,
            CostParams().prior_decode_tokens) == (50.0, 400.0, 64.0)
    for bad in (dict(quantile=1.5), dict(us_per_decode_token=0.0),
                dict(min_samples=0), dict(prior_decode_tokens=0.0)):
        with pytest.raises(ValueError):
            CostParams(**bad)


def stamp_and_finish(side):
    """Three tenants' requests stamped and finished in one interleaved
    order, the predictor's answers and sources read along the way."""
    cm = cost_model(side, prior_decode_tokens=40.0, min_samples=3)
    lengths = {"chat": 8, "long": 100, "mid": 30}
    log = []
    for i in range(24):
        tenant = ("chat", "long", "mid", "chat")[i % 4]
        req = side.R(rid=i, prompt=[1, 2, 3], max_new=96, tenant=tenant)
        log.append((cm.stamp(req), cm.stamp(req), cm.predictor.source(
            tenant), cm.predictor.source("nobody")))
        req.out = [7] * (lengths[tenant] + i % 3)
        log.append((cm.observe_finish(req), cm.predict_decode(tenant, 50,
                                                              5)))
        log.append(tuple(cm.estimate(p, c, g, tenant, 96, 8)
                         for p, c, g in ((64, 0, 0), (64, 32, 0),
                                         (64, 0, 10))))
    unstamped = side.R(rid=99, prompt=[1], max_new=8)
    unstamped.out = [1, 2]
    log.append(cm.observe_finish(unstamped))     # never stamped: None
    return log, cm.snapshot(), list(cm.errors), cm.mean_abs_error()


def test_predictor_and_cost_model_match_jax():
    got, ref = stamp_and_finish(Side(False)), stamp_and_finish(Side(True))
    assert got == ref
    log, snap, errors, _ = got
    assert snap["cost_samples"] == 24 and log[-1] is None
    assert snap["cost_late_abs_err_tokens"] < snap[
        "cost_early_abs_err_tokens"]


# --------------------------------------------------- skewed fabrics
def skew_fabric(side, cm=None, predictive=False, n=6):
    """Two paged replicas with prefix cache and chunked prefill, six
    requests of two tenants all on replica 0."""
    engines = [side.engine(replica_id=i, num_blocks=16, prefix_cache=True,
                           prefill_chunk=8, cost_model=cm, **SMALL)
               for i in range(2)]
    bal = side.balancer(engines, migrate=True, cost_model=cm,
                        predictive=predictive)
    reqs = [side.R(rid=i, prompt=[1 + i] * 12, max_new=10,
                   tenant=f"t{i % 2}") for i in range(n)]
    for r in reqs:
        bal.submit(r, rr=0)
    return bal, reqs


def live_fabric(side, cm=None, predictive=False):
    """Replica 0 saturated with two running sequences, replica 1 empty:
    the diffusive pass can only move a live sequence."""
    engines = [side.engine(replica_id=i, cost_model=cm, **SMALL)
               for i in range(2)]
    bal = side.balancer(engines, migrate=True, cost_model=cm,
                        predictive=predictive)
    reqs = [side.R(rid=i, prompt=[3, i + 1, 4], max_new=20)
            for i in range(2)]
    for r in reqs:
        bal.submit(r, rr=0)
    engines[0].step()
    return bal, reqs


def run(bal, reqs):
    assert bal.run(max_steps=300) == "terminated"
    assert all(r.done for r in reqs)
    c = bal.collect()
    return dict(out=[list(r.out) for r in reqs], decisions=bal.decisions,
                balancer=c["_balancer"], cost=c.get("_cost"),
                stats=[counts(e.stats()) for e in bal.engines],
                report=[ln for ln in bal.report().splitlines()
                        if ln.startswith(("  balancer:",
                                          "  predictive:"))])


_JAX = {}


def jax_run(name, fab, predictive, with_cm):
    if name not in _JAX:
        side = Side(True)
        cm = cost_model(side) if with_cm else None
        _JAX[name] = run(*fab(side, cm, predictive))
    return _JAX[name]


@pytest.mark.parametrize("name,fab,kind", [
    ("skew", skew_fabric, "diffuse"), ("live", live_fabric, "diffuse_live")])
def test_predictive_fabric_matches_jax(name, fab, kind):
    side = Side(False)
    got = run(*fab(side, cost_model(side), True))
    ref = jax_run(name + "/predictive", fab, True, True)
    assert got == ref
    assert got["balancer"]["diffusion_moves"] >= 1
    assert any(d[0] == kind for d in got["decisions"])
    assert got["cost"]["cost_samples"] == len(got["out"])
    assert any(ln.startswith("  predictive:") for ln in got["report"])
    # greedy tokens are those of the reactive fabric
    assert got["out"] == run(*fab(side))["out"]


def test_reactive_parity_with_the_predictor_off():
    """A cost model with predictive=False takes exactly the reactive
    code path: the decisions of no cost model, the JAX fabric's."""
    side = Side(False)
    plain = run(*skew_fabric(side))
    parity = run(*skew_fabric(side, cost_model(side)))
    for key in ("out", "decisions", "balancer"):
        assert parity[key] == plain[key], key
    assert parity["balancer"]["diffusion_moves"] == 0
    assert parity["cost"]["cost_samples"] == len(parity["out"])
    ref = jax_run("skew/reactive", skew_fabric, False, True)
    assert parity == ref


def test_predictive_needs_a_cost_model():
    side = Side(False)
    with pytest.raises(ValueError, match="cost_model"):
        side.balancer([side.engine(**SMALL)], predictive=True)


def priced(side):
    """A request's price on an engine whose radix cache holds its prefix,
    and an unrelated one's."""
    eng = side.engine(num_blocks=24, prefix_cache=True, prefill_chunk=8,
                      cost_model=cost_model(side), **SMALL)
    warm = side.R(rid=0, prompt=[5] * 16, max_new=6)
    eng.submit(warm)
    while eng.load > 0 and eng.steps < 40:
        eng.step()
    assert warm.done
    again = side.R(rid=1, prompt=[5] * 16, max_new=6)
    cold = side.R(rid=2, prompt=[9] * 16, max_new=6)
    return (eng.prefix_cache.hit_length(eng._prefix_tokens(again)),
            eng.request_cost(again, True), eng.request_cost(cold, True),
            eng.request_cost(warm, False), eng.predicted_cost)


def test_request_cost_credits_the_prefix_cache_like_jax():
    got = priced(Side(False))
    assert got == priced(Side(True))
    hit, again, cold, _, _ = got
    assert hit > 0 and again < cold


# ------------------------------------------------- SLO-aware admission
def slo_engine(side, spec="ttft_ms=1000000", **kw):
    mon = (JSLOMonitor(j_parse_slo_spec(spec)) if side.jax
           else SLOMonitor(parse_slo_spec(spec)))
    return side.engine(**dict(SMALL, num_blocks=24, pad_len=8, **kw),
                       slo=mon, slo_admission=True), mon


def slo_order(side):
    """One free slot: the request whose TTFT budget is most blown (an
    explicit queue time 1e12 us in the past) is admitted first although
    it arrived last; then the relaxed tail is paced, never starved."""
    eng, _ = slo_engine(side, max_slots=1)
    reqs = [side.R(rid=i, prompt=[1 + i] * 4, max_new=20) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    reqs[2].t_queued -= 1e12
    eng.step()
    first = eng.slots[0].rid
    eng2, _ = slo_engine(side, max_slots=4)
    r0 = side.R(rid=0, prompt=[9] * 4, max_new=8)
    eng2.submit(r0)
    eng2.step()
    late = [side.R(rid=i, prompt=[i] * 4, max_new=4) for i in (1, 2, 3)]
    for r in late:
        eng2.submit(r)
    eng2.step()
    deferred = (eng2.sched.paced_deferrals, [r.rid for r in eng2.queue])
    while eng2.load > 0 and eng2.steps < 60:
        eng2.step()
    assert all(r.done for r in [r0] + late)
    return first, deferred, [list(r.out) for r in [r0] + late]


def test_slo_admission_orders_by_slack_like_jax():
    got = slo_order(Side(False))
    assert got == slo_order(Side(True))
    first, (deferrals, queued), _ = got
    assert first == 2 and deferrals >= 1 and queued


def test_slo_admission_refusals_match_jax():
    for side in (Side(True), Side(False)):
        with pytest.raises(ValueError):
            side.engine(**SMALL, slo_admission=True)      # no monitor
        with pytest.raises(ValueError):
            slo_engine(side, spec="tpot_ms=50")           # wrong metric
        with pytest.raises(ValueError, match="paged"):
            side.engine(max_slots=2, slo_admission=True)  # not paged
