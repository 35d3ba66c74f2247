"""The rest of the model zoo against the JAX package: mistral-nemo-12b and
qwen1.5-110b (dense), zamba2-7b (hybrid: Mamba2 layers and one
weight-shared attention + MLP block), qwen2-vl-2b (vlm: merged embeddings
and M-RoPE) and musicgen-medium (audio: four codebook streams), each at
its ``smoke()`` size, float32, with the JAX weights carried over by
``weights.params_from_jax``. The zero/one-initialised leaves (norm scales,
biases, Mamba2's scalars) are set to random values so that every parameter
matters. zamba2 runs at its smoke depth (2 layers, one application of the
shared block) and at 4 layers / every 2 and 6 layers / every 3, so that a
second application, on its own k/v cache layer, is reached.

Also: ``apply_mrope`` against the reference at qwen2-vl's sections and the
smoke ones, the registry (``get_config``, ``cell_applicable``) and
``param_count()`` over all ten archs.

Tolerance: 1e-4 absolute / 1e-4 relative on logits and caches (float32 on
both sides, matrix products summed in another order by XLA and PyTorch);
greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, cell_applicable, get_config
from repro.models import (decode_step, forward, init_lm, make_cache,
                          make_paged_cache, prefill)
from repro.models.config import SHAPES
from repro.models.layers import apply_mrope
from repro_torch import configs as t_configs
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import forward as t_forward
from repro_torch.models import init_lm as t_init_lm
from repro_torch.models import make_cache as t_make_cache
from repro_torch.models import make_paged_cache as t_make_paged_cache
from repro_torch.models import prefill as t_prefill
from repro_torch.models.layers import apply_mrope as t_apply_mrope
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
J = jnp.asarray
T = torch.from_numpy
ZOO = ["mistral-nemo-12b", "qwen1.5-110b", "zamba2-7b", "qwen2-vl-2b",
       "musicgen-medium"]
# zamba2 deeper: (n_layers, attn_every) reaching two or more applications
HYBRID = {"zamba2-7b@4/2": (4, 2), "zamba2-7b@6/3": (6, 3)}
CASES = ZOO + list(HYBRID)
_SETUP = {}


def _cfg(archs, case):
    name, _, _ = case.partition("@")
    cfg = archs[name].smoke()
    if case in HYBRID:
        n, every = HYBRID[case]
        cfg = dataclasses.replace(cfg, n_layers=n, attn_every=every)
    return cfg


def _randomize(tree, rng):
    """Norm scales, biases and Mamba2's scalars to random values."""
    def walk(sub):
        for k, v in sub.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ln", "ln1", "ln2", "final_ln", "gate_norm", "bq",
                       "bk", "bv", "dt_bias", "A_log"):
                sub[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "D":
                sub[k] = rng.normal(1, 0.2, v.shape).astype(np.float32)
    walk(tree)
    return tree


def setup(case):
    """(jax cfg, torch cfg, jax params, torch params), shared per module."""
    if case not in _SETUP:
        cfg, tcfg = _cfg(ARCHS, case), _cfg(t_configs.ARCHS, case)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        tree = jax.tree.map(np.array, init_lm(jax.random.key(0), cfg))
        tree = _randomize(tree, np.random.default_rng(len(case)))
        _SETUP[case] = (cfg, tcfg, jax.tree.map(J, tree),
                        params_from_jax(tree, tcfg, device="cpu"))
    return _SETUP[case]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _tokens(rng, cfg, B, S):
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _positions3(B, S, image=(2, 8, 2, 4)):
    """(B, S, 3) M-RoPE positions whose streams differ: text in all three
    equal, then an image span of h x w patches at one temporal index with
    its own (h, w) grid, then text again after the span's largest index."""
    start, n, gh, gw = image
    pos = np.zeros((B, S, 3), np.int32)
    t = np.arange(start)
    pos[:, :start] = t[:, None]
    i = np.arange(n)
    pos[:, start:start + n, 0] = start
    pos[:, start:start + n, 1] = start + i // gw % gh
    pos[:, start:start + n, 2] = start + i % gw
    nxt = start + max(gh, gw)
    rest = np.arange(S - start - n) + nxt
    pos[:, start + n:] = rest[:, None]
    return pos


def _batch(cfg, rng, B, S):
    """The model's inputs as (jax kwargs, torch kwargs): merged embeddings
    and three position streams for vlm, (B, S, K) tokens for audio."""
    if cfg.family == "vlm":
        emb = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
        pos = _positions3(B, S)
        return (dict(embeds=J(emb), positions=J(pos)),
                dict(embeds=T(emb), positions=T(pos)))
    toks = _tokens(rng, cfg, B, S)
    return dict(tokens=J(toks)), dict(tokens=T(toks))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            for i, b in enumerate(v):
                out.update(_flat(b, f"{prefix}{k}/{i}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_init_shapes_and_dtypes(arch):
    """The port's init_lm against JAX's init_lm leaf by leaf (the stacked
    layer axis unstacked; the hybrid's shared block once), in bf16: the
    _F32 leaves float32, the rest bf16."""
    cfg, _, jp, _ = setup(arch)
    bf = dataclasses.replace(_cfg(t_configs.ARCHS, arch), dtype="bfloat16")
    got = _flat(t_init_lm(bf, torch.Generator().manual_seed(0),
                          device="cpu"))
    want = {}
    for path, a in _flat(jax.tree.map(np.asarray, jp)).items():
        if path.startswith("blocks/"):
            for i in range(cfg.n_layers):
                want[f"blocks/{i}/{path[7:]}"] = a[i]
        else:
            want[path] = a
    assert set(got) == set(want)
    f32 = ("ln", "ln1", "ln2", "final_ln", "gate_norm", "A_log", "D",
           "dt_bias")
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        leaf = path.rsplit("/", 1)[-1]
        assert got[path].dtype == (torch.float32 if leaf in f32
                                   else torch.bfloat16), path
    if cfg.family == "hybrid":
        assert "shared/attn/wq" in got and "blocks/0/attn/wq" not in got
    if cfg.n_codebooks:
        assert tuple(got["embed"].shape)[0] == cfg.n_codebooks


@pytest.mark.parametrize("case", CASES)
def test_forward_and_prefill_logits(case):
    cfg, tcfg, jp, tp = setup(case)
    jin, tin = _batch(cfg, np.random.default_rng(1), 2, 16)
    want, _, _ = forward(jp, cfg, mode="train", **jin)
    got, _, _ = t_forward(tp, tcfg, **tin)
    assert got.shape == want.shape
    _close(got, want)
    jc = make_cache(cfg, 2, 32, dtype=jnp.float32)
    want, jc, _ = forward(jp, cfg, cache=jc, cache_len=jnp.int32(0),
                          mode="prefill", **jin)
    tc = t_make_cache(tcfg, 2, 32, device="cpu")
    assert set(tc) == set(jc)
    got, tc, _ = t_forward(tp, tcfg, cache=tc, cache_len=0, mode="prefill",
                           **tin)
    _close(got, want)
    for name in jc:
        _close(tc[name], jc[name])


def _random_cache(jc, rng):
    return jax.tree.map(lambda a: J(rng.normal(0, 1, a.shape).astype(
        np.float32)), jc)


@pytest.mark.parametrize("case", CASES)
def test_decode_contiguous_with_idle_slot(case):
    cfg, tcfg, jp, tp = setup(case)
    rng = np.random.default_rng(2)
    jc = _random_cache(make_cache(cfg, 3, 32, dtype=jnp.float32), rng)
    tc = {n: T(np.array(a)) for n, a in jc.items()}
    before = {n: t.clone() for n, t in tc.items()}
    lens = np.asarray([5, -1, 17], np.int32)          # slot 1 idle
    tok = _tokens(rng, cfg, 3, 1)
    want, jc = decode_step(jp, cfg, J(tok), jc, J(lens))
    got, tc = t_decode_step(tp, tcfg, T(tok), tc, T(lens))
    _close(got[[0, 2]], np.asarray(want)[[0, 2]])
    for name in jc:
        _close(tc[name], jc[name])
        # the idle slot's rows, k/v and recurrent, untouched
        assert torch.equal(tc[name][:, 1], before[name][:, 1]), name


@pytest.mark.parametrize("case", CASES)
def test_decode_paged_with_idle_slot(case):
    cfg, tcfg, jp, tp = setup(case)
    rng = np.random.default_rng(3)
    NB, Bs, MB = 12, 8, 4
    lens = np.asarray([9, -1, 23], np.int32)
    jc = _random_cache(make_paged_cache(cfg, NB, Bs, 3, dtype=jnp.float32),
                       rng)
    # The port's pools hold one more block, the sink; recurrent leaves are
    # per slot and have none.
    tc = {n: (torch.cat([T(np.array(a)), torch.zeros_like(
        T(np.array(a[:, :1])))], dim=1) if n in ("k", "v")
              else T(np.array(a))) for n, a in jc.items()}
    assert {n: tuple(t.shape) for n, t in tc.items()} == {
        n: tuple(t.shape) for n, t in t_make_paged_cache(
            tcfg, NB, Bs, 3, device="cpu").items()}
    bt = np.zeros((3, MB), np.int32)
    bt[0, :2], bt[2, :3] = [7, 2], [4, 11, 0]        # scrambled tables
    tok = _tokens(rng, cfg, 3, 1)
    want, jc = decode_step(jp, cfg, J(tok), jc, J(lens),
                           block_tables=J(bt))
    got, tc = t_decode_step(tp, tcfg, T(tok), tc, T(lens),
                            block_tables=T(bt))
    _close(got[[0, 2]], np.asarray(want)[[0, 2]])
    for name in jc:
        _close(tc[name][:, :NB] if name in ("k", "v") else tc[name],
               jc[name])


def _greedy(logits, cfg):
    lg = np.asarray(logits)[:, -1, ..., :cfg.vocab]
    return lg.argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_prefill_then_greedy_decode(arch):
    """lm.prefill on the family's inputs (vlm: merged embeddings with three
    differing position streams; audio: (B, S, K) tokens), then four greedy
    decode_steps ((B, 1) tokens for vlm, (B, 1, K) for audio): logits and
    caches at every step, and identical tokens. JAX's ``prefill`` stores
    its cache in bf16 whatever the config; the port's stores ``cfg.dtype``
    (float32 here), so the JAX side is its prefill forward on a float32
    cache."""
    cfg, tcfg, jp, tp = setup(arch)
    B, S, max_seq = 2, 16, 32
    jin, tin = _batch(cfg, np.random.default_rng(4), B, S)
    want, jc, _ = forward(jp, cfg, cache=make_cache(cfg, B, max_seq,
                                                    dtype=jnp.float32),
                          cache_len=jnp.int32(0), mode="prefill", **jin)
    got, tc = t_prefill(tp, tcfg, tin, max_seq)
    assert jax.tree.map(jnp.shape, prefill(jp, cfg, jin, max_seq)[1]) == \
        {n: tuple(t.shape) for n, t in tc.items()}
    _close(got, want)
    tok, ttok = _greedy(want, cfg), _greedy(got, cfg)
    np.testing.assert_array_equal(ttok, tok)
    # Decode positions continue from the cache length in every stream.
    for step in range(4):
        shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
        lens = np.full(B, S + step, np.int32)
        want, jc = decode_step(jp, cfg, J(tok.reshape(shape)), jc, J(lens))
        got, tc = t_decode_step(tp, tcfg, T(ttok.reshape(shape)), tc,
                                T(lens))
        assert got.shape == want.shape
        _close(got, want)
        tok, ttok = _greedy(want, cfg), _greedy(got, cfg)
        np.testing.assert_array_equal(ttok, tok)
    for name in jc:
        _close(tc[name], jc[name])


@pytest.mark.parametrize("sections,D", [((16, 24, 24), 128),
                                        ((2, 3, 3), 16)])
def test_apply_mrope_matches_reference(sections, D):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 24, 3, D)).astype(np.float32)
    pos = _positions3(2, 24, image=(3, 12, 3, 4))
    assert not (pos[..., 0] == pos[..., 1]).all()
    want = apply_mrope(J(x), J(pos), 1e6, sections)
    got = t_apply_mrope(T(x), T(pos), 1e6, sections)
    _close(got, want)
    # equal streams reduce to plain RoPE
    from repro_torch.models.layers import apply_rope
    same = np.repeat(pos[..., :1], 3, axis=-1)
    _close(t_apply_mrope(T(x), T(same), 1e6, sections),
           apply_rope(T(x), T(same[..., 0]), 1e6))
    with pytest.raises(ValueError):
        t_apply_mrope(T(x), T(pos), 1e6, (1, 2, 3))


def test_registry_matches_reference():
    assert list(t_configs.ARCHS) == list(ARCHS) and len(ARCHS) == 10
    for name, cfg in ARCHS.items():
        tcfg = t_configs.get_config(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(get_config(
            name))
        assert tcfg.param_count() == cfg.param_count(), name
        assert tcfg.active_param_count() == cfg.active_param_count(), name
        for shape in SHAPES.values():
            tshape = t_configs.SHAPES[shape.name]
            assert t_configs.cell_applicable(tcfg, tshape) == \
                cell_applicable(cfg, shape), (name, shape.name)
    with pytest.raises(KeyError):
        t_configs.get_config("no-such-arch")
