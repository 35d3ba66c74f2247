"""The port's serving engine against ``repro.serve.engine.Engine``.

Same requests, same weights (carried over by ``params_from_jax``), greedy
sampling: the port's engine must emit exactly the tokens of the JAX
engine's per-token baseline in all five modes (step_legacy, contiguous,
paged, paged + prefix cache, paged + prefix cache + chunked prefill), on
``tinyllama-1.1b.smoke()``, ``qwen2-1.5b.smoke()`` and
``moonshot-v1-16b-a3b.smoke()`` in float32, the MoE at capacity factor
8.0 (dropless) as ``tests/test_serve_matrix.py`` serves it. The requests
and engine sizes are those of ``tests/test_serve_matrix.py``. At the
MoE's own factor 1.25 drops are batch-global, so a token depends on what
the other slots (idle ones included) route in the same step: there the
port's contiguous and paged engines are held to the JAX engine in the
same mode, step for step. The JAX MoE engine decodes through its Pallas
kernels in interpret mode: an idle slot's attention is zeros there and in
the port (the JAX oracle gives it uniform attention instead), and idle
slots are routed.

A paged admission of the dense and vlm families pads its prefix to the
pool's block size, where the JAX engine pads it to ``pad_len``: with a
``pad_len`` three blocks long, the tokens of prompts on both sides of
each block edge are still the JAX engine's (``qwen2-vl-2b.smoke()`` on
text prompts too), also where a starved pool preempts and a request
resumes by recompute.

``mamba2-130m.smoke()`` (ssm family) runs in the three modes it supports.
Its prompt padding runs through the recurrence, which washes out most of
a prompt's influence, so equal tokens prove little: the per-slot conv/ssm
cache leaves are compared with the JAX engine's after the admission and
after every engine step (1e-4 absolute and relative, float32: the JAX
engine's prefill scans sequentially, the port's in chunks). That decay
also hides a stale conv state, so a last test holds an admission into a
reused slot to a fresh engine's, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import init_lm
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.serve import Engine, Request
from repro_torch.weights import params_from_jax
from test_serve_matrix import KW, _reqs

MOE = "moonshot-v1-16b-a3b"
ARCH_NAMES = ["tinyllama-1.1b", "qwen2-1.5b", MOE]
SSM = "mamba2-130m"
STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")
_SETUP = {}
_JAX = {}


def _run(engine, reqs, step=None):
    step = step or engine.step
    for r in reqs:
        engine.submit(r)
    guard = 0
    while engine.load > 0 and guard < 600:
        step()
        guard += 1
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs]


def _treqs(n=4, max_new=8, rid0=0):
    return [Request(rid=r.rid + rid0, prompt=list(r.prompt),
                    max_new=r.max_new) for r in _reqs(n, max_new)]


def moe_cfgs(factor):
    """(JAX, port) configs of the MoE smoke model at capacity ``factor``;
    the JAX one decodes through its interpret-mode kernels."""
    cfg = dataclasses.replace(ARCHS[MOE].smoke(), capacity_factor=factor)
    return (dataclasses.replace(cfg, decode_impl="decode_interpret"),
            dataclasses.replace(T_ARCHS[MOE].smoke(),
                                capacity_factor=factor))


def setup(arch):
    """(torch cfg, torch params, JAX legacy-engine greedy tokens)."""
    if arch not in _SETUP:
        cfg, tcfg = ARCHS[arch].smoke(), T_ARCHS[arch].smoke()
        if cfg.family == "moe":
            cfg, tcfg = moe_cfgs(8.0)
        jp = init_lm(jax.random.key(0), cfg)
        _JAX[arch] = (cfg, jp)
        je = JEngine(cfg, jp, **KW)
        base = _run(je, _reqs(), je.step_legacy)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        _SETUP[arch] = (tcfg, tp, base)
    return _SETUP[arch]


MODES = {
    "legacy": {},
    "contiguous": {},
    "paged": dict(paged=True, block_size=8),
    "paged+prefix": dict(paged=True, block_size=8, prefix_cache=True),
    "paged+prefix+chunk": dict(paged=True, block_size=8, prefix_cache=True,
                               prefill_chunk=4, token_budget=8),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_greedy_tokens_match_jax_engine(arch, mode):
    cfg, params, base = setup(arch)
    e = Engine(cfg, params, device="cpu", **KW, **MODES[mode])
    step = e.step_legacy if mode == "legacy" else e.step
    assert _run(e, _treqs(), step) == base
    if mode.startswith("paged+prefix"):
        # second wave hits the cached shared prompt, same tokens
        hits0 = e.prefix_cache.hits
        assert _run(e, _treqs(rid0=100)) == base
        assert e.prefix_cache.hits > hits0
        assert (e.pool.free_blocks + e.pool.cached_blocks
                == e.pool.num_blocks)
    elif mode == "paged":
        assert e.pool.free_blocks == e.pool.num_blocks
    if mode == "paged+prefix+chunk":
        assert e.sched.chunks_scheduled >= len(base)


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_moe_at_its_capacity_factor_matches_jax_engine(mode):
    """Capacity 1.25: drops happen (JAX's summed ``dropped`` > 0 over the
    run), and the tokens are the JAX engine's in the same mode."""
    from repro.models import forward as j_forward
    from repro.serve.engine import Request as JRequest

    _, tp, _ = setup(MOE)
    jp = _JAX[MOE][1]
    jcfg, tcfg = moe_cfgs(1.25)
    je = JEngine(jcfg, jp, **KW, **MODES[mode])
    te = Engine(tcfg, tp, device="cpu", **KW, **MODES[mode])
    reqs = _reqs(6, 10)
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
             for r in reqs]
    want = _run(je, jreqs)
    assert _run(te, _treqs(6, 10)) == want
    assert (te.steps, te.tokens_out, te.host_syncs) == (
        je.steps, je.tokens_out, je.host_syncs)
    # the reference drops routed slots on these prompts
    toks = np.asarray([r.prompt[:KW["pad_len"]] for r in reqs[:2]])
    _, _, aux = j_forward(jp, jcfg, tokens=toks)
    assert float(aux["dropped"]) > 0


def test_host_syncs_match_jax_and_drop_by_steps_per_sync():
    """As tests/test_serve_engine.py: N-token decode cuts host drains by
    ~N; and the port counts host syncs exactly as the JAX engine does."""
    cfg, params, _ = setup("tinyllama-1.1b")
    kw = dict(max_slots=2, max_seq=64, pad_len=8)
    mk = lambda: [Request(rid=i, prompt=[3, i + 1, 4, 2], max_new=10)
                  for i in range(5)]
    e1 = Engine(cfg, params, steps_per_sync=1, device="cpu", **kw)
    _run(e1, mk())
    e8 = Engine(cfg, params, steps_per_sync=8, device="cpu", **kw)
    _run(e8, mk())
    assert e8.tokens_out == e1.tokens_out
    assert e8.host_syncs < e1.host_syncs / 3
    jcfg = ARCHS["tinyllama-1.1b"].smoke()
    je = JEngine(jcfg, init_lm(jax.random.key(0), jcfg), steps_per_sync=8,
                 **kw)
    from repro.serve.engine import Request as JRequest
    _run(je, [JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
              for r in mk()])
    assert (e8.host_syncs, e8.steps, e8.tokens_out) == (
        je.host_syncs, je.steps, je.tokens_out)


def test_temperature_sampling_deterministic_in_seed():
    cfg, params, _ = setup("tinyllama-1.1b")
    outs = []
    for seed in (0, 0, 1):
        e = Engine(cfg, params, temperature=1.0, seed=seed, device="cpu",
                   **KW)
        outs.append(_run(e, _treqs(2, 12)))
    assert outs[0] == outs[1], "same seed must replay the same tokens"
    assert outs[0] != outs[2], "different seed must explore differently"


BLOCK_KW = dict(max_slots=2, max_seq=64, pad_len=48, steps_per_sync=4,
                paged=True, block_size=16)
LENGTHS = (1, 15, 16, 17, 47, 48, 60)


@pytest.mark.parametrize("num_blocks", [None, 4])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-1.5b",
                                  "qwen2-vl-2b"])
def test_block_padded_admissions_match_jax_engine(arch, num_blocks):
    """Prompts of LENGTHS tokens (cut to pad_len 48) through engines with
    blocks of 16: the port prefills 16, 16, 16, 32, 48, 48 and 48 rows,
    the JAX engine 48 each, and the greedy tokens are the same. With a
    pool of 4 blocks (one sequence's worth), three 6-token prompts that
    decode 40 tokens each: the same preemptions, resumed by recompute,
    and the same tokens."""
    from repro.serve.engine import Request as JRequest

    cfg, params, _ = setup(arch)
    jcfg, jp = _JAX[arch]
    if num_blocks is None:
        reqs = [dict(rid=i, prompt=[(3 * i + 7 * j) % 97 + 1
                                    for j in range(n)], max_new=6 + i % 3)
                for i, n in enumerate(LENGTHS)]
    else:
        reqs = [dict(rid=i, prompt=list(range(1 + i, 7 + i)), max_new=40)
                for i in range(3)]
    je = JEngine(jcfg, jp, num_blocks=num_blocks, **BLOCK_KW)
    te = Engine(cfg, params, device="cpu", num_blocks=num_blocks, **BLOCK_KW)
    want = _run(je, [JRequest(**r) for r in reqs])
    assert _run(te, [Request(**r) for r in reqs]) == want
    assert te.sched.preemptions == je.sched.preemptions
    assert (te.sched.preemptions > 0) == (num_blocks is not None)
    if num_blocks is None:
        assert te.stats()["prefill_rows"] == 16 * 3 + 32 + 48 * 3


def test_unported_options_raise():
    """The cost model, the SLO monitor and SLO-aware admission are
    ported: the engine takes them, and refuses what the reference
    refuses with its ValueError (SLO-aware admission without the paged
    scheduler or without a monitor)."""
    from repro_torch.obs import SLOMonitor, parse_slo_spec
    from repro_torch.serve import CostModel

    cfg, params, _ = setup("tinyllama-1.1b")
    slo = SLOMonitor(parse_slo_spec("ttft_ms=1000"))
    cm = CostModel()
    e = Engine(cfg, params, device="cpu", paged=True, block_size=8,
               cost_model=cm, slo=slo, slo_admission=True, **KW)
    assert e.cost_model is cm and e.slo is e.sched.slo is slo
    reqs = _treqs(2, 4)
    _run(e, reqs)
    assert cm.snapshot()["cost_samples"] == 2
    assert slo.attainment()["ttft_ms"]["total"] == 2
    for kw in (dict(slo=slo, slo_admission=True),
               dict(paged=True, block_size=8, slo_admission=True)):
        with pytest.raises(ValueError):
            Engine(cfg, params, device="cpu", **kw)
    with pytest.raises(ValueError):
        Engine(cfg, params, device="cpu").submit(
            Request(rid=0, prompt=[], max_new=1))


@pytest.mark.parametrize("mode", ["legacy", "contiguous", "paged"])
def test_ssm_tokens_and_recurrent_state_match_jax(mode):
    cfg, params, base = setup(SSM)
    jcfg, jp = _JAX[SSM]
    from repro.serve.engine import Request as JRequest
    je = JEngine(jcfg, jp, **KW, **MODES[mode])
    te = Engine(cfg, params, device="cpu", **KW, **MODES[mode])
    jreqs, treqs = _reqs(), _treqs()
    assert isinstance(jreqs[0], JRequest)
    for a, b in zip(jreqs, treqs):
        je.submit(a)
        te.submit(b)

    def same_state():
        for k in STATE_KEYS:
            np.testing.assert_allclose(te.cache[k].numpy(),
                                       np.asarray(je.cache[k]),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
        assert [r.out for r in treqs] == [r.out for r in jreqs]

    if mode != "paged":
        je._admit()                    # admission alone: the prefilled
        te._admit()                    # slots' state
        same_state()
    n = 0
    while (je.load or te.load) and n < 200:
        if mode == "legacy":
            je.step_legacy()
            te.step_legacy()
        else:
            je.step()
            te.step()
        same_state()                   # slot reuse included: scrubbed
        n += 1
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == base


def test_ssm_rejects_prefix_cache_and_chunked_prefill():
    cfg, params, _ = setup(SSM)
    for kw in (dict(paged=True, block_size=8, prefix_cache=True),
               dict(paged=True, block_size=8, prefill_chunk=4),
               dict(prefix_cache=True)):
        with pytest.raises(ValueError, match="stateless attention"):
            Engine(cfg, params, device="cpu", **KW, **kw)


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_ssm_slot_reuse_starts_from_a_clean_state(mode):
    """An admission into a slot that served another request must leave
    exactly the state a fresh engine's admission does. (The decay over a
    padded bucket hides most of a stale conv state from the JAX
    comparison above, so this compares the port with itself, bit for
    bit.)"""
    cfg, params, _ = setup(SSM)
    kw = dict(KW, max_slots=1, **MODES[mode])
    x = lambda: Request(rid=1, prompt=[5, 9, 2, 7, 3], max_new=6)
    used = Engine(cfg, params, device="cpu", **kw)
    _run(used, [Request(rid=0, prompt=[8, 1, 6, 4], max_new=5)])
    fresh = Engine(cfg, params, device="cpu", **kw)
    for e in (used, fresh):
        e.submit(x())
        e.step()                       # admits x, then decodes
    for k in STATE_KEYS:
        assert torch.equal(used.cache[k], fresh.cache[k]), k
