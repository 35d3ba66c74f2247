"""The port's MoE layer and GLB expert rebalancer against the JAX package.

``moe_fwd`` runs on ``phi3.5-moe-42b-a6.6b.smoke()`` (4 experts, top-2)
and on the moonshot-v1-16b-a3b smoke config with its real routing (64
experts, top-6, d_model 64), float32, weights from the JAX ``moe_init``
carried over as numpy. At the configs' capacity factor 1.25 the JAX layer
drops routed slots (asserted, so the drop path is covered) and at 8.0 it
drops none (on tokens without the shared skew that the 1.25 cases add).
``expert_counts``, ``dropped`` and ``capacity`` must be equal;
y within 1e-5 absolute and relative (float32 on both sides, products of
d_model 64 and d_ff 128 summed in another order, values of order 1).

``glb_expert_rebalance`` gets the JAX reference's random-round draws
(``randint`` from ``fold_in(key(seed), round)``) through ``candidates``:
the permutation, the swaps and both load vectors must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import glb_moe as jglb
from repro.models.moe import moe_fwd as j_moe_fwd
from repro.models.moe import moe_init as j_moe_init
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import glb_moe
from repro_torch.models.moe import capacity, moe_fwd, moe_init

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch, factor, **kw):
    cfg = dataclasses.replace(ARCHS[arch].smoke(), capacity_factor=factor,
                              **kw)
    tcfg = dataclasses.replace(T_ARCHS[arch].smoke(),
                               capacity_factor=factor, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return cfg, tcfg


CASES = {
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
    "moonshot-64x6": ("moonshot-v1-16b-a3b", dict(n_experts=64, top_k=6)),
}


def _layer(arch, factor, seed=0, **kw):
    cfg, tcfg = _cfgs(arch, factor, **kw)
    jp = j_moe_init(jax.random.key(seed), cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, tcfg, jp, tp


def _x(seed, shape, skew=1.5):
    """Tokens around one shared direction (``skew`` times a standard
    normal vector), so that routing is skewed and the 1.25 capacity drops
    slots."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + skew * rng.standard_normal(shape[-1])).astype(np.float32)


def _run_both(cfg, tcfg, jp, tp, x, perm=None):
    y, aux = j_moe_fwd(jp, jnp.asarray(x), cfg,
                       expert_perm=None if perm is None
                       else jnp.asarray(perm, jnp.int32))
    ty, taux = moe_fwd(tp, torch.from_numpy(x), tcfg,
                       expert_perm=None if perm is None
                       else torch.from_numpy(np.asarray(perm)))
    return (np.asarray(y), aux), (ty.numpy(), taux)


def _check(jout, tout):
    (y, aux), (ty, taux) = jout, tout
    np.testing.assert_allclose(ty, y, **TOL)
    np.testing.assert_array_equal(taux["expert_counts"].numpy(),
                                  np.asarray(aux["expert_counts"]))
    assert float(taux["dropped"]) == float(aux["dropped"])
    assert taux["capacity"] == aux["capacity"]
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(aux["aux_loss"]), **TOL)


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_fwd_matches_jax(case, factor):
    arch, kw = CASES[case]
    cfg, tcfg, jp, tp = _layer(arch, factor, **kw)
    x = _x(1, (2, 16, cfg.d_model), skew=1.5 if factor == 1.25 else 0.0)
    jout, tout = _run_both(cfg, tcfg, jp, tp, x)
    _check(jout, tout)
    dropped = float(jout[1]["dropped"])
    assert dropped > 0 if factor == 1.25 else dropped == 0


@pytest.mark.parametrize("case", list(CASES))
def test_moe_fwd_with_expert_perm_matches_jax(case):
    arch, kw = CASES[case]
    cfg, tcfg, jp, tp = _layer(arch, 1.25, seed=2, **kw)
    x = _x(3, (3, 8, cfg.d_model))
    perm = np.random.default_rng(3).permutation(cfg.n_experts)
    _check(*_run_both(cfg, tcfg, jp, tp, x, perm))


@pytest.mark.parametrize("factor,permuted", [(1.25, False), (8.0, False),
                                              (1.25, True)])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_fwd_passes_gmm_compact_groups(case, factor, permuted,
                                           monkeypatch):
    """The capacity buffer is packed by expert: the group sizes given to
    ``ops.gmm`` are min(count, cap) per (physical) expert, they sum to the
    kept slots, the rows past their sum are zero, and the layer still
    computes JAX's function."""
    from repro_torch.kernels import ops

    arch, kw = CASES[case]
    cfg, tcfg, jp, tp = _layer(arch, factor, **kw)
    x = _x(5, (2, 16, cfg.d_model), skew=1.5 if factor == 1.25 else 0.0)
    perm = (np.random.default_rng(6).permutation(cfg.n_experts)
            if permuted else None)
    calls = []
    real_gmm = ops.gmm

    def spy(rows, w, sizes, **kwargs):
        calls.append((rows.clone(), sizes.clone()))
        return real_gmm(rows, w, sizes, **kwargs)

    monkeypatch.setattr(ops, "gmm", spy)
    if permuted:
        tp = dict(tp, **glb_moe.permute_expert_params(
            {k: tp[k] for k in ("wg", "wi", "wo")},
            np.arange(cfg.n_experts), perm))
        jp = dict(jp, **jglb.permute_expert_params(
            {k: jp[k] for k in ("wg", "wi", "wo")},
            np.arange(cfg.n_experts), perm))
    jout, tout = _run_both(cfg, tcfg, jp, tp, x, perm)
    _check(jout, tout)
    taux = tout[1]
    cap = taux["capacity"]
    counts = taux["expert_counts"].numpy().astype(np.int64)
    kept = 2 * 16 * cfg.top_k - int(taux["dropped"])
    assert len(calls) == 3                     # wg, wi, wo
    for rows, sizes in calls:
        assert sizes.dtype == torch.int32
        np.testing.assert_array_equal(sizes.numpy(), np.minimum(counts, cap))
        assert int(sizes.sum()) == kept
        assert rows.shape[0] == cfg.n_experts * cap
        assert (rows[kept:] == 0).all()
    assert (calls[0][0][:kept].abs().sum(1) > 0).all()   # packed, no holes
    assert kept < calls[0][0].shape[0]         # a zero tail to hold


@pytest.mark.parametrize("T", [3, 5, 7])
def test_capacity_rounds_half_to_even_as_jax(T):
    """T * top_k / E = T / 2 lands on a half here: Python's round (half to
    even) gives JAX's capacity. The two moonshot path shapes: 1 slot per
    expert at decode (8 tokens), 30 for a 256-token bucket."""
    cfg, tcfg, jp, _ = _layer("phi3.5-moe-42b-a6.6b", 1.0)
    x = jnp.zeros((1, T, cfg.d_model), jnp.float32)
    assert capacity(T, tcfg) == j_moe_fwd(jp, x, cfg)[1]["capacity"]
    assert capacity(T, tcfg) == round(T / 2)
    assert capacity(8, T_ARCHS["moonshot-v1-16b-a3b"]) == 1
    assert capacity(256, T_ARCHS["moonshot-v1-16b-a3b"]) == 30


def test_moe_impls():
    """``ref`` (the plain gmm) computes what ``auto`` does; ``ep`` without
    a mesh raises (JAX's ValueError); an unknown impl raises."""
    arch, kw = CASES["moonshot-64x6"]
    cfg, tcfg, _, tp = _layer(arch, 1.25, **kw)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32))
    y, aux = moe_fwd(tp, x, tcfg)
    for impl in ("global", "ref"):
        y2, aux2 = moe_fwd(tp, x, dataclasses.replace(tcfg, moe_impl=impl))
        assert torch.equal(y, y2) and float(aux2["dropped"]) == float(
            aux["dropped"])
    with pytest.raises(ValueError, match="needs a mesh"):
        moe_fwd(tp, x, dataclasses.replace(tcfg, moe_impl="ep"))
    with pytest.raises(ValueError, match="unknown moe_impl"):
        moe_fwd(tp, x, dataclasses.replace(tcfg, moe_impl="einsum"))


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal gate probabilities: the lower expert index first, as
    lax.top_k orders them (the drop order depends on it)."""
    from repro_torch.models.moe import _top_k

    probs = np.asarray([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                        [0.4, 0.1, 0.4, 0.1]], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = _top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))


def test_moe_init_shapes_and_distribution():
    cfg = T_ARCHS["moonshot-v1-16b-a3b"].smoke()
    p = moe_init(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    jp = j_moe_init(jax.random.key(0), ARCHS["moonshot-v1-16b-a3b"].smoke())
    for k, a in jp.items():
        assert tuple(p[k].shape) == a.shape
    std = 1 / np.sqrt(cfg.d_model)                  # fan-in on axis 1
    assert float(p["wg"].abs().max()) <= 2 * std
    assert float(p["wo"].abs().max()) <= 2 / np.sqrt(cfg.d_ff)


# ------------------------------------------------------ expert rebalancing
def _jax_candidates(seed):
    def draw(r, P, w):
        key = jax.random.fold_in(jax.random.key(seed), r)
        d = np.asarray(jax.random.randint(key, (P, w), 0, P - 1))
        return (np.arange(P)[:, None] + 1 + d) % P
    return draw


def _rebalance_cases():
    skew = np.ones(16) * 10
    skew[:4] = 200
    rng = np.random.default_rng(7)
    yield "skewed", skew, np.arange(16), 4, 0
    yield "balanced", np.ones(16) * 50, np.arange(16), 4, 0
    for i, (E, R) in enumerate([(64, 8), (32, 4), (16, 2), (64, 16)]):
        counts = rng.integers(0, 400, E) * (rng.random(E) < 0.7)
        yield f"random{i}", counts, rng.permutation(E), R, i + 1


@pytest.mark.parametrize("name,counts,perm,R,seed",
                         list(_rebalance_cases()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_glb_expert_rebalance_matches_jax(name, counts, perm, R, seed):
    want = jglb.glb_expert_rebalance(counts, perm, n_ranks=R, seed=seed)
    got = glb_moe.glb_expert_rebalance(counts, perm, n_ranks=R, seed=seed,
                                       candidates=_jax_candidates(seed))
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.loads_before, want.loads_before)
    np.testing.assert_array_equal(got.loads_after, want.loads_after)
    assert got.swaps == want.swaps
    if name == "skewed":
        assert got.loads_after.std() < got.loads_before.std() * 0.5
    if name == "balanced":
        assert got.swaps == [] and (got.perm == perm).all()
    assert sorted(got.perm.tolist()) == list(range(len(counts)))


def test_default_candidates_rebalance_the_skewed_load():
    counts = np.ones(16) * 10
    counts[:4] = 200
    res = glb_moe.glb_expert_rebalance(counts, np.arange(16), n_ranks=4)
    assert res.loads_after.std() < res.loads_before.std() * 0.5
    assert sorted(res.perm.tolist()) == list(range(16))


@pytest.mark.parametrize("case", list(CASES))
def test_placement_permutation_preserves_math(case):
    """As tests/test_glb_moe.py: moe_fwd with the rebalanced placement and
    the permuted weights computes the unpermuted layer's output (and the
    JAX layer's, with the same placement). A random placement as well,
    since the rebalancer may swap back to where it started."""
    arch, kw = CASES[case]
    cfg, tcfg, jp, tp = _layer(arch, 8.0, **kw)
    x = _x(1, (2, 16, cfg.d_model))
    y0, aux0 = moe_fwd(tp, torch.from_numpy(x), tcfg)
    counts = aux0["expert_counts"].numpy()
    perm_old = np.arange(cfg.n_experts)
    res = glb_moe.glb_expert_rebalance(
        counts + np.arange(cfg.n_experts) * 5, perm_old, n_ranks=2,
        candidates=_jax_candidates(0))
    shuffled = np.random.default_rng(5).permutation(cfg.n_experts)
    assert (shuffled != perm_old).any()
    for perm in (res.perm, shuffled):
        tp2 = dict(tp)
        tp2.update(glb_moe.permute_expert_params(
            {k: tp[k] for k in ("wg", "wi", "wo")}, perm_old, perm))
        y1, aux1 = moe_fwd(tp2, torch.from_numpy(x), tcfg,
                           expert_perm=torch.from_numpy(perm))
        np.testing.assert_allclose(y1.numpy(), y0.numpy(), **TOL)
        np.testing.assert_array_equal(aux1["expert_counts"].numpy()[perm],
                                      counts)
        jp2 = dict(jp)
        jp2.update(jglb.permute_expert_params(
            {k: jp[k] for k in ("wg", "wi", "wo")}, perm_old, perm))
        jy1, _ = j_moe_fwd(jp2, jnp.asarray(x), cfg,
                           expert_perm=jnp.asarray(perm, jnp.int32))
        np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **TOL)
