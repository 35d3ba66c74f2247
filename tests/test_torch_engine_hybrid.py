"""The hybrid family (zamba2-7b: Mamba2 layers and one weight-shared
attention + MLP block) through the port's serving engine, against
``repro.serve.engine``.

``zamba2-7b.smoke()`` at 4 layers (a shared application after layers 1
and 3, on k/v cache layers 0 and 1), float32, the JAX weights carried
over by ``params_from_jax``. The port's engine and the JAX engine take
the same requests in step, contiguous and paged: greedy tokens and slot
lengths equal, and after the admission and every engine step the per-slot
conv/ssm leaves and the k/v caches (the pools' blocks, the port's sink
block aside; each contiguous slot's written window) within 1e-4 absolute
and relative (the JAX engine's prefill scans
sequentially, the port's in chunks). Both engines refuse the prefix cache
and chunked prefill for the family. A 2-replica migrating fabric
(``GLBReplicaBalancer(migrate=True)``, every request on replica 0) makes
the same decisions as the JAX balancer, its live steals landing by
recompute (no KV travels with a recurrent state).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCHS
from repro.models import init_lm
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.serve import Engine
from repro_torch.weights import params_from_jax
from test_serve_matrix import KW, _reqs
from test_torch_engine import _treqs
from test_torch_migrate import Side, fabric

ZAMBA = "zamba2-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")
MODES = {"contiguous": {}, "paged": dict(paged=True, block_size=8)}
_SETUP = {}


def setup():
    """(JAX cfg, JAX params, port cfg, port params) at 4 layers."""
    if not _SETUP:
        cfg = dataclasses.replace(ARCHS[ZAMBA].smoke(), n_layers=4)
        tcfg = dataclasses.replace(T_ARCHS[ZAMBA].smoke(), n_layers=4)
        assert cfg.attn_every == 2
        jp = init_lm(jax.random.key(0), cfg)
        _SETUP["zamba"] = (cfg, jp, tcfg, params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return _SETUP["zamba"]


@pytest.mark.parametrize("mode", list(MODES))
def test_hybrid_tokens_state_and_kv_match_jax(mode):
    cfg, jp, tcfg, tp = setup()
    je = JEngine(cfg, jp, **KW, **MODES[mode])
    te = Engine(tcfg, tp, device="cpu", **KW, **MODES[mode])
    assert te.cache["k"].shape[0] == 2          # 4 // 2 applications
    jreqs, treqs = _reqs(), _treqs()
    for a, b in zip(jreqs, treqs):
        je.submit(a)
        te.submit(b)

    def same_state():
        for k in STATE_KEYS + ("k", "v"):
            got, want = te.cache[k].numpy(), np.asarray(je.cache[k])
            if k in ("k", "v") and te.paged:
                got = got[:, :te.num_blocks]      # the sink block aside
            elif k in ("k", "v"):
                # Each slot's written window: past it the JAX admission
                # leaves zeros (it writes the whole fresh row) and the
                # port the previous request's rows, which no step reads.
                for b, n in enumerate(je.lens):
                    np.testing.assert_allclose(
                        got[:, b, :max(n, 0)], want[:, b, :max(n, 0)],
                        err_msg=f"{k} slot {b}", **TOL)
                continue
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)
        assert list(te.lens) == list(je.lens)
        assert [r.out for r in treqs] == [r.out for r in jreqs]

    if mode == "contiguous":
        je._admit()                    # admission alone: the prefilled
        te._admit()                    # slots' state
        same_state()
    n = 0
    while (je.load or te.load) and n < 200:
        je.step()
        te.step()
        same_state()                   # slot reuse included: scrubbed
        n += 1
    assert all(r.done for r in treqs)
    assert (te.steps, te.tokens_out, te.host_syncs) == (
        je.steps, je.tokens_out, je.host_syncs)


def test_hybrid_rejects_prefix_cache_and_chunked_prefill():
    cfg, jp, tcfg, tp = setup()
    for kw in (dict(paged=True, block_size=8, prefix_cache=True),
               dict(paged=True, block_size=8, prefill_chunk=4)):
        with pytest.raises(ValueError, match="stateless attention"):
            Engine(tcfg, tp, device="cpu", **KW, **kw)
        with pytest.raises(AssertionError, match="stateless attention"):
            JEngine(cfg, jp, **KW, **kw)


def test_hybrid_migrating_fabric_matches_jax():
    """Two paged replicas of the smoke config, every request on replica
    0: the same tokens, decisions, balancer counters and per-replica
    stats as the JAX fabric, and every live steal lands by recompute."""
    got = fabric(Side(False, ZAMBA), 2, 3)
    ref = fabric(Side(True, ZAMBA), 2, 3)
    assert got["out"] == ref["out"]
    assert got["decisions"] == ref["decisions"]
    live = [d for d in got["decisions"] if d[0] == "live"]
    assert live and all(d[-1] == "recompute" for d in live)
    assert got["balancer"] == ref["balancer"]
    assert got["stats"] == ref["stats"]
