"""The port's serving engine against ``repro.serve.engine.Engine``.

Same requests, same weights (carried over by ``params_from_jax``), greedy
sampling: the port's engine must emit exactly the tokens of the JAX
engine's per-token baseline in all five modes (step_legacy, contiguous,
paged, paged + prefix cache, paged + prefix cache + chunked prefill), on
``tinyllama-1.1b.smoke()`` and ``qwen2-1.5b.smoke()`` in float32. The
requests and engine sizes are those of ``tests/test_serve_matrix.py``.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.models import init_lm
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.serve import Engine, Request
from repro_torch.weights import params_from_jax
from test_serve_matrix import KW, _reqs

ARCH_NAMES = ["tinyllama-1.1b", "qwen2-1.5b"]
_SETUP = {}


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


def setup(arch):
    """(torch cfg, torch params, JAX legacy-engine greedy tokens)."""
    if arch not in _SETUP:
        cfg = ARCHS[arch].smoke()
        jp = init_lm(jax.random.key(0), cfg)
        je = JEngine(cfg, jp, **KW)
        base = _run(je, _reqs(), je.step_legacy)
        tcfg = T_ARCHS[arch].smoke()
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


def test_unported_options_raise():
    cfg, params, _ = setup("tinyllama-1.1b")
    for kw in (dict(cost_model=object()), dict(slo=object()),
               dict(paged=True, slo_admission=True)):
        with pytest.raises(NotImplementedError):
            Engine(cfg, params, device="cpu", **kw)
    with pytest.raises(ValueError):
        Engine(cfg, params, device="cpu").submit(
            Request(rid=0, prompt=[], max_new=1))
