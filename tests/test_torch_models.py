"""The port's LM against the JAX package, with the JAX weights carried over
by ``weights.params_from_jax``.

Configs: ``tinyllama-1.1b.smoke()`` and ``qwen2-1.5b.smoke()`` (QKV bias),
``moonshot-v1-16b-a3b.smoke()`` (moe family; at capacity factor 8.0,
dropless, as ``tests/test_serve_matrix.py`` serves it, and at its own 1.25,
where the summed ``expert_counts`` and ``dropped`` must be equal too), and
``mamba2-130m.smoke()`` (ssm family: one Mamba2 block in each mode,
the whole model, the per-slot recurrent caches), float32. The biases,
norm scales and Mamba2's scalars, zero or one at init, are set to random
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
MOE = "moonshot-v1-16b-a3b"
ARCH_NAMES = ["tinyllama-1.1b", "qwen2-1.5b", MOE]
_SETUP = {}


def _smoke(archs, arch, factor):
    cfg = archs[arch].smoke()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
    return cfg


def _jax_moe_decode(cfg):
    """The JAX config a moe parity test runs: decode attention through the
    Pallas kernels in interpret mode. An idle slot (length 0) gets zeros
    from the kernels, and from the port's plain versions, which follow
    them, but uniform attention from the JAX oracle ``decode_ref``. Idle
    slots stay in the batch and are routed, so that difference would
    change the expert counts (and, at capacity 1.25, the drops other
    slots see)."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, decode_impl="decode_interpret")


def setup(arch, factor=8.0):
    """(jax cfg, torch cfg, jax params, torch params), shared per module.
    MoE configs run at capacity ``factor``."""
    if (arch, factor) not in _SETUP:
        cfg = _smoke(ARCHS, arch, factor)
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
        tcfg = _smoke(T_ARCHS, arch, factor)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        cfg = _jax_moe_decode(cfg)
        _SETUP[arch, factor] = (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
                                params_from_jax(tree, tcfg, device="cpu"))
    return _SETUP[arch, factor]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _same_aux(got, want):
    """MoE routing statistics summed over the layers: equal."""
    for k in ("expert_counts", "dropped"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _tokens(rng, cfg, B, S):
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_train_and_prefill_logits(arch, factor=8.0):
    cfg, tcfg, jp, tp = setup(arch, factor)
    toks = _tokens(np.random.default_rng(1), cfg, 2, 12)
    want, _, jaux = forward(jp, cfg, tokens=jnp.asarray(toks), mode="train")
    got, _, taux = t_forward(tp, tcfg, torch.from_numpy(toks))
    _close(got, want)
    jc = make_cache(cfg, 2, 32, dtype=jnp.float32)
    want, jc, jaux2 = forward(jp, cfg, tokens=jnp.asarray(toks), cache=jc,
                              cache_len=jnp.int32(0), mode="prefill")
    tc = t_make_cache(tcfg, 2, 32, device="cpu")
    got, tc, taux2 = t_forward(tp, tcfg, torch.from_numpy(toks), cache=tc,
                               cache_len=0, mode="prefill")
    _close(got, want)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    if cfg.family == "moe":
        _same_aux(taux, jaux)
        _same_aux(taux2, jaux2)
        assert (float(jaux["dropped"]) > 0) == (factor == 1.25)


def _decode_aux(cfg, tcfg, jp, tp, tok, jc, tc, lens, bt=None):
    """MoE only: the summed routing statistics of one decode step from the
    same caches (a copy of the port's, which decode_step updates in
    place). Idle slots are in the batch and take capacity in both."""
    if cfg.family != "moe":
        return
    tc = {n: t.clone() for n, t in tc.items()}
    _, _, jaux = forward(jp, cfg, tokens=jnp.asarray(tok), cache=jc,
                         cache_len=jnp.asarray(lens), mode="decode",
                         block_tables=None if bt is None
                         else jnp.asarray(bt))
    _, _, taux = t_forward(tp, tcfg, torch.from_numpy(tok), cache=tc,
                           cache_len=torch.from_numpy(lens), mode="decode",
                           block_tables=None if bt is None
                           else torch.from_numpy(bt))
    _same_aux(taux, jaux)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_contiguous_with_idle_slot(arch, factor=8.0):
    cfg, tcfg, jp, tp = setup(arch, factor)
    rng = np.random.default_rng(2)
    B, S_max = 3, 32
    jc = make_cache(cfg, B, S_max, dtype=jnp.float32)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 1, a.shape).astype(np.float32)), jc)
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    lens = np.asarray([5, -1, 17], np.int32)          # slot 1 idle
    tok = _tokens(rng, cfg, B, 1)
    _decode_aux(cfg, tcfg, jp, tp, tok, jc, tc, lens)
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
def test_decode_step_paged_with_idle_slot(arch, factor=8.0):
    cfg, tcfg, jp, tp = setup(arch, factor)
    rng = np.random.default_rng(3)
    NB, Bs, MB = 12, 8, 4
    lens = np.asarray([9, -1, 23], np.int32)
    jc, tc = _paged_state(cfg, rng, NB, Bs, lens)
    bt = np.zeros((3, MB), np.int32)
    bt[0, :2], bt[2, :3] = [7, 2], [4, 11, 0]        # scrambled tables
    tok = _tokens(rng, cfg, 3, 1)
    _decode_aux(cfg, tcfg, jp, tp, tok, jc, tc, lens, bt)
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
def test_chunked_prefill_against_pool(arch, factor=8.0):
    cfg, tcfg, jp, tp = setup(arch, factor)
    rng = np.random.default_rng(4)
    NB, Bs, MB = 12, 8, 4
    jc, tc = _paged_state(cfg, rng, NB, Bs, [0])
    # tokens [11, 18) of a sequence whose blocks are 5, 9, 1; entries past
    # the allocation are the out-of-range sentinel NB (dropped writes).
    bt = np.asarray([[5, 9, 1, NB]], np.int32)
    tok = _tokens(rng, cfg, 1, 7)
    want, jc, jaux = forward(jp, cfg, tokens=jnp.asarray(tok), cache=jc,
                             cache_len=jnp.int32(11), mode="prefill",
                             block_tables=jnp.asarray(bt))
    got, tc, taux = t_forward(tp, tcfg, torch.from_numpy(tok), cache=tc,
                              cache_len=11, mode="prefill",
                              block_tables=torch.from_numpy(bt))
    _close(got, want)
    for name in ("k", "v"):
        _close(tc[name][:, :NB], jc[name])
    if cfg.family == "moe":
        _same_aux(taux, jaux)


@pytest.mark.parametrize("test", [
    test_forward_train_and_prefill_logits,
    test_decode_step_contiguous_with_idle_slot,
    test_decode_step_paged_with_idle_slot,
    test_chunked_prefill_against_pool,
], ids=lambda f: f.__name__[5:])
def test_moe_at_its_capacity_factor(test):
    """The MoE cases above again at the config's own capacity factor 1.25,
    where drops happen."""
    test(MOE, 1.25)


def test_init_lm_shapes_and_distributions(arch="tinyllama-1.1b"):
    cfg = T_ARCHS[arch].smoke()
    p = t_init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, _, tp = setup(arch)
    assert len(p["blocks"]) == cfg.n_layers
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    wq = p["blocks"][0]["attn"]["wq"]
    std = 1 / np.sqrt(cfg.d_model)                 # truncated at +-2 std
    assert float(wq.abs().max()) <= 2 * std
    assert abs(float(wq.std()) / std - 0.88) < 0.05   # trunc-normal std


def test_moe_init_lm_shapes():
    test_init_lm_shapes_and_distributions(MOE)


# ------------------------------------------------------------ ssm family
J = jnp.asarray


def setup_ssm():
    """mamba2-130m.smoke() with every zero/one-initialised leaf (norm
    scales, dt_bias, A_log, D) set to random values."""
    if "ssm" not in _SETUP:
        cfg = ARCHS["mamba2-130m"].smoke()
        rng = np.random.default_rng(5)
        tree = jax.tree.map(np.array, init_lm(jax.random.key(1), cfg))
        m = tree["blocks"]["mamba"]
        for blk, name, mean in ((tree["blocks"], "ln", 0.0),
                                (tree, "final_ln", 0.0),
                                (m, "gate_norm", 0.0), (m, "dt_bias", 0.0),
                                (m, "A_log", 0.0), (m, "D", 1.0)):
            blk[name] = rng.normal(mean, 0.2, blk[name].shape).astype(
                np.float32)
        tcfg = T_ARCHS["mamba2-130m"].smoke()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        _SETUP["ssm"] = (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         params_from_jax(tree, tcfg, device="cpu"))
    return _SETUP["ssm"]


def _ssm_state(cfg, rng, B):
    """A random per-slot recurrent cache (one layer's leaves)."""
    jc = make_cache(cfg, B, 8, dtype=jnp.float32)
    return {k: rng.normal(0, 1, a.shape[1:]).astype(np.float32)
            for k, a in jc.items()}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_fwd_matches_jax(mode):
    """One Mamba2 block in each mode: output, and the new conv/ssm states
    (prefill and decode start from a random carried state; in decode,
    slot 1 is inactive and must keep its state bit for bit)."""
    from repro.models.mamba2 import mamba_fwd as j_mamba
    from repro_torch.models.mamba2 import mamba_fwd as t_mamba

    cfg, tcfg, jp, tp = setup_ssm()
    rng = np.random.default_rng(6)
    B, S = 3, (1 if mode == "decode" else 12)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    jpar = jax.tree.map(lambda a: a[0], jp["blocks"]["mamba"])
    tpar = tp["blocks"][0]["mamba"]
    state = _ssm_state(cfg, rng, B) if mode != "train" else None
    active = np.asarray([True, False, True]) if mode == "decode" else None
    want, jnew = j_mamba(jpar, jnp.asarray(x), cfg,
                         cache=state and jax.tree.map(jnp.asarray, state),
                         mode=mode,
                         active=None if active is None else J(active))
    tstate = state and {k: torch.from_numpy(v.copy())
                        for k, v in state.items()}
    got, tnew = t_mamba(tpar, torch.from_numpy(x), tcfg, cache=tstate,
                        mode=mode, active=None if active is None
                        else torch.from_numpy(active))
    _close(got if active is None else got[[0, 2]],
           want if active is None else np.asarray(want)[[0, 2]])
    if state is None:
        return
    assert tnew is tstate                       # updated in place
    for k in state:
        _close(tnew[k], jnew[k])
        if active is not None:
            assert np.array_equal(tnew[k][1].numpy(), state[k][1])


def test_ssm_forward_and_decode_match_jax():
    """The whole mamba2 model: train and prefill logits, then one decode
    step against the prefilled cache with an idle slot (-1)."""
    cfg, tcfg, jp, tp = setup_ssm()
    toks = _tokens(np.random.default_rng(7), cfg, 3, 16)
    want, _, _ = forward(jp, cfg, tokens=J(toks), mode="train")
    got, _, _ = t_forward(tp, tcfg, torch.from_numpy(toks))
    _close(got, want)
    jc = make_cache(cfg, 3, 32, dtype=jnp.float32)
    want, jc, _ = forward(jp, cfg, tokens=J(toks), cache=jc,
                          cache_len=jnp.int32(0), mode="prefill")
    tc = t_make_cache(tcfg, 3, 32, device="cpu")
    assert set(tc) == set(jc) == {"conv_x", "conv_B", "conv_C", "ssm"}
    got, tc, _ = t_forward(tp, tcfg, torch.from_numpy(toks), cache=tc,
                           cache_len=0, mode="prefill")
    _close(got, want)
    for k in jc:
        _close(tc[k], jc[k])
    lens = np.asarray([16, -1, 16], np.int32)
    tok = _tokens(np.random.default_rng(8), cfg, 3, 1)
    before = {k: v.clone() for k, v in tc.items()}
    want, jc = decode_step(jp, cfg, J(tok), jc, J(lens))
    got, tc = t_decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                            torch.from_numpy(lens))
    _close(got[[0, 2]], np.asarray(want)[[0, 2]])
    for k in jc:
        _close(tc[k], jc[k])
        assert torch.equal(tc[k][:, 1], before[k][:, 1])   # idle slot


def test_ssm_caches_and_init_shapes():
    cfg, tcfg, _, tp = setup_ssm()
    p = t_init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    f32 = ("A_log", "D", "dt_bias", "gate_norm")
    for name in f32:
        assert tp["blocks"][0]["mamba"][name].dtype == torch.float32
    assert tp["blocks"][0]["ln"].dtype == torch.float32
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    pc = t_make_paged_cache(bf, 6, 8, 3, device="cpu")
    jpc = make_paged_cache(cfg, 6, 8, 3)
    assert set(pc) == set(jpc)                 # no k/v pools, no sink
    for k, a in jpc.items():
        assert tuple(pc[k].shape) == a.shape
        assert pc[k].dtype == (torch.float32 if k == "ssm"
                               else torch.bfloat16)
    # The hybrid family: n_layers // attn_every k/v layers (one per
    # application of the shared block) beside the recurrent leaves of
    # every layer, in both cache layouts; the pools hold the sink block.
    hybrid = dataclasses.replace(ARCHS["zamba2-7b"].smoke(), n_layers=5,
                                 attn_every=2)
    thybrid = dataclasses.replace(T_ARCHS["zamba2-7b"].smoke(), n_layers=5,
                                  attn_every=2)
    jcc = make_cache(hybrid, 3, 16, dtype=jnp.float32)
    tcc = t_make_cache(thybrid, 3, 16, device="cpu")
    jpc = make_paged_cache(hybrid, 6, 8, 3, dtype=jnp.float32)
    tpc = t_make_paged_cache(thybrid, 6, 8, 3, device="cpu")
    for got, want, sink in ((tcc, jcc, 0), (tpc, jpc, 1)):
        assert set(got) == set(want) == {"k", "v", "conv_x", "conv_B",
                                         "conv_C", "ssm"}
        for k, a in want.items():
            shape = list(a.shape)
            if k in ("k", "v"):
                assert shape[0] == 2            # 5 // 2 applications
                shape[1] += sink
            else:
                assert shape[0] == 5
            assert list(got[k].shape) == shape, k
            assert got[k].dtype == torch.float32
