"""The port's dense LM against the JAX package, with the JAX weights carried
over by ``weights.params_from_jax``.

Configs: ``tinyllama-1.1b.smoke()`` and ``qwen2-1.5b.smoke()`` (QKV bias),
float32. The biases and norm scales, zero at init, are set to random
values so that every parameter matters. Logits of ``forward`` (train and
prefill), of ``decode_step`` on the contiguous and the paged caches, and of
a chunked prefill against the pool are compared, and so are the caches
written.

Tolerance: 1e-4 absolute / 1e-4 relative on logits and caches: float32 on
both sides, two layers of matrix products summed in a different order by
XLA and by PyTorch (values of order 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import (decode_step, forward, init_lm, make_cache,
                          make_paged_cache)
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import forward as t_forward
from repro_torch.models import init_lm as t_init_lm
from repro_torch.models import make_cache as t_make_cache
from repro_torch.models import make_paged_cache as t_make_paged_cache
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH_NAMES = ["tinyllama-1.1b", "qwen2-1.5b"]
_SETUP = {}


def setup(arch):
    """(jax cfg, torch cfg, jax params, torch params), shared per module."""
    if arch not in _SETUP:
        cfg = ARCHS[arch].smoke()
        rng = np.random.default_rng(0)
        tree = jax.tree.map(np.array, init_lm(jax.random.key(0), cfg))
        for name in ("bq", "bk", "bv"):
            if name in tree["blocks"]["attn"]:
                a = tree["blocks"]["attn"][name]
                tree["blocks"]["attn"][name] = rng.normal(
                    0, 0.1, a.shape).astype(np.float32)
        for blk, name in ((tree["blocks"], "ln1"), (tree["blocks"], "ln2"),
                          (tree, "final_ln")):
            blk[name] = rng.normal(0, 0.1, blk[name].shape).astype(
                np.float32)
        tcfg = T_ARCHS[arch].smoke()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        _SETUP[arch] = (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        params_from_jax(tree, tcfg, device="cpu"))
    return _SETUP[arch]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _tokens(rng, cfg, B, S):
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_train_and_prefill_logits(arch):
    cfg, tcfg, jp, tp = setup(arch)
    toks = _tokens(np.random.default_rng(1), cfg, 2, 12)
    want, _, _ = forward(jp, cfg, tokens=jnp.asarray(toks), mode="train")
    got, _, _ = t_forward(tp, tcfg, torch.from_numpy(toks))
    _close(got, want)
    jc = make_cache(cfg, 2, 32, dtype=jnp.float32)
    want, jc, _ = forward(jp, cfg, tokens=jnp.asarray(toks), cache=jc,
                          cache_len=jnp.int32(0), mode="prefill")
    tc = t_make_cache(tcfg, 2, 32, device="cpu")
    got, tc, _ = t_forward(tp, tcfg, torch.from_numpy(toks), cache=tc,
                           cache_len=0, mode="prefill")
    _close(got, want)
    for name in ("k", "v"):
        _close(tc[name], jc[name])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_contiguous_with_idle_slot(arch):
    cfg, tcfg, jp, tp = setup(arch)
    rng = np.random.default_rng(2)
    B, S_max = 3, 32
    jc = make_cache(cfg, B, S_max, dtype=jnp.float32)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 1, a.shape).astype(np.float32)), jc)
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    lens = np.asarray([5, -1, 17], np.int32)          # slot 1 idle
    tok = _tokens(rng, cfg, B, 1)
    want, jc = decode_step(jp, cfg, jnp.asarray(tok), jc, jnp.asarray(lens))
    got, tc = t_decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(lens))
    live = lens >= 0
    _close(got[torch.from_numpy(live)], np.asarray(want)[live])
    for name in ("k", "v"):
        _close(tc[name], jc[name])     # idle slot's rows untouched too


def _paged_state(cfg, rng, NB, Bs, lens):
    jc = make_paged_cache(cfg, NB, Bs, len(lens), dtype=jnp.float32)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 1, a.shape).astype(np.float32)), jc)
    tc = {n: torch.cat([torch.from_numpy(np.array(a)),
                        torch.zeros_like(torch.from_numpy(
                            np.array(a[:, :1])))], dim=1)
          for n, a in jc.items()}                    # + the sink block
    return jc, tc


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_paged_with_idle_slot(arch):
    cfg, tcfg, jp, tp = setup(arch)
    rng = np.random.default_rng(3)
    NB, Bs, MB = 12, 8, 4
    lens = np.asarray([9, -1, 23], np.int32)
    jc, tc = _paged_state(cfg, rng, NB, Bs, lens)
    bt = np.zeros((3, MB), np.int32)
    bt[0, :2], bt[2, :3] = [7, 2], [4, 11, 0]        # scrambled tables
    tok = _tokens(rng, cfg, 3, 1)
    want, jc = decode_step(jp, cfg, jnp.asarray(tok), jc, jnp.asarray(lens),
                           block_tables=jnp.asarray(bt))
    got, tc = t_decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(lens),
                            block_tables=torch.from_numpy(bt))
    live = lens >= 0
    _close(got[torch.from_numpy(live)], np.asarray(want)[live])
    for name in ("k", "v"):
        _close(tc[name][:, :NB], jc[name])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_chunked_prefill_against_pool(arch):
    cfg, tcfg, jp, tp = setup(arch)
    rng = np.random.default_rng(4)
    NB, Bs, MB = 12, 8, 4
    jc, tc = _paged_state(cfg, rng, NB, Bs, [0])
    # tokens [11, 18) of a sequence whose blocks are 5, 9, 1; entries past
    # the allocation are the out-of-range sentinel NB (dropped writes).
    bt = np.asarray([[5, 9, 1, NB]], np.int32)
    tok = _tokens(rng, cfg, 1, 7)
    want, jc, _ = forward(jp, cfg, tokens=jnp.asarray(tok), cache=jc,
                          cache_len=jnp.int32(11), mode="prefill",
                          block_tables=jnp.asarray(bt))
    got, tc, _ = t_forward(tp, tcfg, torch.from_numpy(tok), cache=tc,
                           cache_len=11, mode="prefill",
                           block_tables=torch.from_numpy(bt))
    _close(got, want)
    for name in ("k", "v"):
        _close(tc[name][:, :NB], jc[name])


def test_init_lm_shapes_and_distributions():
    cfg = T_ARCHS["tinyllama-1.1b"].smoke()
    p = t_init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, _, tp = setup("tinyllama-1.1b")
    assert len(p["blocks"]) == cfg.n_layers
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    wq = p["blocks"][0]["attn"]["wq"]
    std = 1 / np.sqrt(cfg.d_model)                 # truncated at +-2 std
    assert float(wq.abs().max()) <= 2 * std
    assert abs(float(wq.std()) / std - 0.88) < 0.05   # trunc-normal std
