"""``attn_impl="chunked"``: the port's ``attention_chunked`` and the
``chunked`` routes of ``ops.attention`` against the JAX package's.

``attention_chunked`` is held to ``repro.kernels.ref.attention_chunked``
(causal and not, Skv > Sq, GQA of 4 query heads on 2 KV heads of 16, one
and four q blocks) in value (1e-5, float32 on both sides) and in the
gradient of q, k and v under a random cotangent against ``jax.grad``.
``ops.attention(impl="chunked")`` is held to JAX's on its three routes:
contiguous prefill (``attention_chunked`` at block 512), decode with
``lengths`` (``decode_ref``) and through ``block_tables`` (``paged_ref``,
decode and chunked prefill). Then the models: the zamba2-7b and
tinyllama-1.1b smoke configs with ``attn_impl`` and ``decode_impl``
``"chunked"``, float32, on weights carried over by
``weights.params_from_jax``, in forward (train), prefill and contiguous
and paged decode, logits within 1e-4 of JAX's largest |logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import (decode_step, forward, init_lm, make_cache,
                          make_paged_cache)
from repro_torch import configs as t_configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_chunked
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import forward as t_forward
from repro_torch.models import make_cache as t_make_cache
from repro_torch.weights import params_from_jax

J = jnp.asarray
T = torch.from_numpy
ATOL = 1e-5
HQ, HKV, D = 4, 2, 16


def _qkv(rng, B, Sq, Skv):
    q = rng.normal(0, 1, (B, Sq, HQ, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, HKV, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, HKV, D)).astype(np.float32)
    return q, k, v


# (causal, Sq, Skv, block_q): one block and four, Skv > Sq
CHUNKED = [(True, 32, 32, 512), (True, 32, 32, 8), (True, 16, 48, 4),
           (False, 32, 32, 8), (False, 16, 40, 16)]


@pytest.mark.parametrize("causal,Sq,Skv,bq", CHUNKED)
def test_attention_chunked_values_and_grads(causal, Sq, Skv, bq):
    rng = np.random.default_rng(Sq + Skv + bq)
    q, k, v = _qkv(rng, 2, Sq, Skv)
    ct = rng.normal(0, 1, q.shape).astype(np.float32)
    want = jref.attention_chunked(J(q), J(k), J(v), causal=causal,
                                  block_q=bq)
    tq, tk, tv = (T(a).requires_grad_(True) for a in (q, k, v))
    got = attention_chunked(tq, tk, tv, causal=causal, block_q=bq)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    jg = jax.grad(lambda a, b, c: jnp.sum(jref.attention_chunked(
        a, b, c, causal=causal, block_q=bq) * J(ct)), argnums=(0, 1, 2))(
        J(q), J(k), J(v))
    tg = torch.autograd.grad((got * T(ct)).sum(), (tq, tk, tv))
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_attention_chunked_rejects_ragged_blocks():
    q, k, v = (T(a) for a in _qkv(np.random.default_rng(0), 1, 12, 12))
    with pytest.raises(ValueError, match="do not split"):
        attention_chunked(q, k, v, block_q=8)
    with pytest.raises(AssertionError):      # the reference asserts
        jref.attention_chunked(J(q.numpy()), J(k.numpy()), J(v.numpy()),
                               block_q=8)


def test_ops_chunked_prefill_route():
    """Contiguous prefill: ``attention_chunked`` at block 512 (1024 rows,
    two blocks), causal and not."""
    q, k, v = _qkv(np.random.default_rng(1), 1, 1024, 1024)
    for causal in (True, False):
        want = jops.attention(J(q), J(k), J(v), causal=causal,
                              impl="chunked")
        got = ops.attention(T(q), T(k), T(v), causal=causal,
                            impl="chunked")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_ops_chunked_decode_route():
    """With ``lengths`` and Sq == 1: ``decode_ref``'s window mask."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 3, 1, 24)
    lens = np.asarray([1, 13, 24], np.int32)
    want = jops.attention(J(q), J(k), J(v), causal=False, impl="chunked",
                          lengths=J(lens))
    got = ops.attention(T(q), T(k), T(v), causal=False, impl="chunked",
                        lengths=T(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("Sq", [1, 5])
def test_ops_chunked_paged_routes(Sq):
    """Through ``block_tables``: paged decode (Sq 1) and chunked prefill
    (Sq 5 at a mid-block ``q_offset``), the tables scrambled."""
    rng = np.random.default_rng(3 + Sq)
    NB, Bs = 10, 4
    q = rng.normal(0, 1, (2, Sq, HQ, D)).astype(np.float32)
    kp = rng.normal(0, 1, (NB, Bs, HKV, D)).astype(np.float32)
    vp = rng.normal(0, 1, (NB, Bs, HKV, D)).astype(np.float32)
    bt = np.asarray([[3, 7, 1, 0], [9, 2, 5, 8]], np.int32)
    off = np.asarray([6, 9], np.int32)
    lens = off + Sq if Sq > 1 else np.asarray([7, 14], np.int32)
    kw = dict(causal=Sq > 1, impl="chunked")
    jkw = dict(kw, lengths=J(lens), block_tables=J(bt),
               q_offset=J(off) if Sq > 1 else None)
    tkw = dict(kw, lengths=T(lens), block_tables=T(bt),
               q_offset=T(off) if Sq > 1 else None)
    want = jops.attention(J(q), J(kp), J(vp), **jkw)
    got = ops.attention(T(q), T(kp), T(vp), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ------------------------------------------------------------- models
MODELS = ["zamba2-7b", "tinyllama-1.1b"]
_SETUP = {}


def _chunked(cfg):
    return dataclasses.replace(cfg, attn_impl="chunked",
                               decode_impl="chunked", dtype="float32")


def setup(arch):
    if arch not in _SETUP:
        cfg = _chunked(ARCHS[arch].smoke())
        tcfg = _chunked(t_configs.ARCHS[arch].smoke())
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        tree = jax.tree.map(np.array, init_lm(jax.random.key(0), cfg))
        _SETUP[arch] = (cfg, tcfg, jax.tree.map(J, tree),
                        params_from_jax(tree, tcfg, device="cpu"))
    return _SETUP[arch]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("arch", MODELS)
def test_model_forward_and_prefill_chunked(arch):
    """The fault's case: 128 tokens in train mode (the port used to raise
    ``unknown attention impl 'chunked'``), then prefill into a cache."""
    cfg, tcfg, jp, tp = setup(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 128))
    toks = toks.astype(np.int32)
    want, _, _ = forward(jp, cfg, tokens=J(toks), mode="train")
    got, _, _ = t_forward(tp, tcfg, tokens=T(toks), mode="train")
    assert tuple(got.shape) == want.shape == (1, 128, cfg.vocab)
    _close(got, want)
    jc = make_cache(cfg, 1, 160, dtype=jnp.float32)
    want, jc, _ = forward(jp, cfg, tokens=J(toks), cache=jc,
                          cache_len=jnp.int32(0), mode="prefill")
    tc = t_make_cache(tcfg, 1, 160, device="cpu")
    got, tc, _ = t_forward(tp, tcfg, tokens=T(toks), cache=tc, cache_len=0,
                           mode="prefill")
    _close(got, want)
    for name in jc:
        _close(tc[name], jc[name])


@pytest.mark.parametrize("arch", MODELS)
def test_model_decode_chunked(arch):
    """Contiguous decode (``lengths`` route) with an idle slot, and paged
    decode (``block_tables`` route)."""
    cfg, tcfg, jp, tp = setup(arch)
    rng = np.random.default_rng(5)
    jc = jax.tree.map(lambda a: J(rng.normal(0, 1, a.shape).astype(
        np.float32)), make_cache(cfg, 3, 32, dtype=jnp.float32))
    tc = {n: T(np.array(a)) for n, a in jc.items()}
    lens = np.asarray([5, -1, 17], np.int32)
    tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    want, _ = decode_step(jp, cfg, J(tok), jc, J(lens))
    got, _ = t_decode_step(tp, tcfg, T(tok), tc, T(lens))
    _close(got[[0, 2]], np.asarray(want)[[0, 2]])

    NB, Bs = 12, 8
    jc = jax.tree.map(lambda a: J(rng.normal(0, 1, a.shape).astype(
        np.float32)), make_paged_cache(cfg, NB, Bs, 3, dtype=jnp.float32))
    tc = {n: (torch.cat([T(np.array(a)), torch.zeros_like(
        T(np.array(a[:, :1])))], dim=1) if n in ("k", "v")
              else T(np.array(a))) for n, a in jc.items()}
    bt = np.zeros((3, 4), np.int32)
    bt[0, :2], bt[2, :3] = [7, 2], [4, 11, 0]
    lens = np.asarray([9, -1, 23], np.int32)
    want, _ = decode_step(jp, cfg, J(tok), jc, J(lens), block_tables=J(bt))
    got, _ = t_decode_step(tp, tcfg, T(tok), tc, T(lens),
                           block_tables=T(bt))
    _close(got[[0, 2]], np.asarray(want)[[0, 2]])
