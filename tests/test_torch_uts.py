"""The port's UTS pieces against ``repro``: the hashing helpers, the plain
node expansion (``uts_expand_ref``) against JAX's interpret-mode Pallas
kernel and its ``ref``, the routing of ``ops.expand_uts``, and the tree
counts of the oracles. Everything integer is compared bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.uts_expand import uts_expand as juts_expand
from repro.problems import uts as juts
from repro_torch.kernels import ops
from repro_torch.kernels.uts_expand import (narrow, uts_expand,
                                            uts_expand_ref, widen)
from repro_torch.problems import uts

THR = juts.geom_thresholds(4.0)


def _inputs(seed, M, base_hi=100):
    """uint32 descriptors over the full range (high bit set in half of
    them) and int32 bases, from numpy."""
    rng = np.random.default_rng(seed)
    d0 = rng.integers(0, 2 ** 32, M, dtype=np.uint64).astype(np.uint32)
    d1 = rng.integers(0, 2 ** 32, M, dtype=np.uint64).astype(np.uint32)
    base = rng.integers(max(0, base_hi - 100), base_hi, M).astype(np.int32)
    return d0, d1, base


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("M,width,block_m",
                         [(128, 64, 128), (256, 32, 64), (64, 8, 64)])
def test_uts_expand_ref_matches_jax_kernel_and_ref(M, width, block_m):
    d0, d1, base = _inputs(M + width, M)
    jd0, jd1, jbase = jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(base)
    jthr = jnp.asarray(THR)
    kern = juts_expand(jd0, jd1, jbase, jthr, width=width, block_m=block_m,
                       interpret=True)
    want = jref.uts_expand_ref(jd0, jd1, jbase, jthr, width)
    got = uts_expand_ref(_t(d0), _t(d1), _t(base), _t(THR), width)
    for k, w, g, conv in zip(kern, want, got, (_u, _u, lambda t: t.numpy())):
        np.testing.assert_array_equal(np.asarray(k), np.asarray(w))
        np.testing.assert_array_equal(conv(g), np.asarray(w))
    assert all(g.dtype == torch.int32 for g in got)


def test_uts_expand_ref_near_int32_limit():
    """base + lane up to 2^31 - 1: the child index stays exact."""
    d0, d1, base = _inputs(7, 16, base_hi=2 ** 31 - 64)
    width = 64
    want = jref.uts_expand_ref(jnp.asarray(d0), jnp.asarray(d1),
                               jnp.asarray(base), jnp.asarray(THR), width)
    got = uts_expand_ref(_t(d0), _t(d1), _t(base), _t(THR), width)
    for w, g, conv in zip(want, got, (_u, _u, lambda t: t.numpy())):
        np.testing.assert_array_equal(conv(g), np.asarray(w))


def test_expand_uts_routing():
    d0, d1, base = _inputs(3, 10)
    args = (_t(d0), _t(d1), _t(base), _t(THR))
    want = uts_expand_ref(*args, 16)
    for impl in ("auto", "ref"):
        ops.reset_launches()
        for g, w in zip(ops.expand_uts(*args, width=16, impl=impl), want):
            assert torch.equal(g, w)
        assert ops.kernel_launches()["uts_expand"] == 0   # CPU: no kernel
    with pytest.raises(ValueError, match="unknown uts impl"):
        ops.expand_uts(*args, width=16, impl="pallas")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        uts_expand(*meta, width=16)


def test_bit_views_round_trip():
    vals = np.asarray([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    wide = widen(_t(vals))
    assert wide.tolist() == [int(v) for v in vals]
    assert np.array_equal(_u(narrow(wide)), vals)


def test_hash_helpers_match_jax():
    d0, d1, base = _inputs(5, 64)
    i = np.arange(64, dtype=np.uint32)
    jh0, jh1 = juts.child_hash(jnp.asarray(d0), jnp.asarray(d1),
                               jnp.asarray(i), jnp)
    for xp, args, conv in (
            (np, (d0, d1, i), np.asarray),
            (torch, tuple(widen(_t(a)) for a in (d0, d1, i)),
             lambda t: t.numpy().astype(np.uint32))):
        h0, h1 = uts.child_hash(*args, xp)
        np.testing.assert_array_equal(conv(h0), np.asarray(jh0))
        np.testing.assert_array_equal(conv(h1), np.asarray(jh1))
        np.testing.assert_array_equal(
            conv(uts.fmix32(args[0], xp)),
            np.asarray(juts.fmix32(jnp.asarray(d0), jnp)))
        thr = THR if xp is np else widen(_t(THR))
        np.testing.assert_array_equal(
            np.asarray(uts.child_count(h0, thr, xp)),
            np.asarray(juts.child_count(jh0, jnp.asarray(THR), jnp)))
    for b0 in (2.0, 4.0, 6.0):
        np.testing.assert_array_equal(uts.geom_thresholds(b0),
                                      juts.geom_thresholds(b0))
    for seed in (0, 19, 2 ** 31):
        want = juts.root_desc(seed, np)
        assert [int(v) for v in uts.root_desc(seed, np)] == \
            [int(v) for v in want]
        assert [int(v) for v in uts.root_desc(seed, torch)] == \
            [int(v) for v in want]


@pytest.mark.parametrize("depth", [0, 1, 4, 6])
def test_oracles_match_jax(depth):
    want = juts.uts_oracle(b0=4.0, depth=depth, seed=19)
    assert uts.uts_oracle(b0=4.0, depth=depth, seed=19) == want
    assert uts.uts_count_bfs(b0=4.0, depth=depth, seed=19) == want


def test_bfs_count_in_small_chunks():
    """The chunked expansion gives the same count however it is cut."""
    want = juts.uts_oracle(b0=3.0, depth=7, seed=5)
    for chunk in (1, 7, 1000):
        assert uts.uts_count_bfs(b0=3.0, depth=7, seed=5,
                                 chunk=chunk) == want


# ------------------------------------------ the kernel's count, in numpy
# csrc/uts.cu counts #{k : h0 < T_k} by a binary search when a warp's vote
# finds the table non-increasing. These model its steps (uint32 in numpy)
# and hold them to the 32 compares the plain version makes.
B0S = (3.0, 4.0)     # the trees the problems, tests and chip_smoke.py run


def _vote(table):
    """The kernel's vote: lane k holds T_k and votes T_k >= T_{k+1}."""
    return bool(np.all(table[:-1] >= table[1:]))


def _search(h0, table):
    """Five halving steps reach min(count, 31), each reading T at the
    guess (a shuffle in the kernel); one compare against T at the result
    tells 31 from 32."""
    c = np.zeros(h0.shape, np.int64)
    for s in (16, 8, 4, 2, 1):
        c += np.where(h0 < table[c + s - 1], s, 0)
    return c + (h0 < table[c])


def _probes(table, rng):
    """h0 at 0, 2^32 - 1, each T_k - 1 and T_k (wrapped into uint32), and
    random values."""
    edges = np.concatenate([table.astype(np.int64) - 1, table]) % 2 ** 32
    return np.concatenate([[0, 2 ** 32 - 1], edges,
                           rng.integers(0, 2 ** 32, 100_000)]).astype(
        np.uint32)


@pytest.mark.parametrize("b0", B0S + (1.0, 6.0))
def test_geom_thresholds_are_non_increasing(b0):
    table = uts.geom_thresholds(b0)
    assert table.dtype == np.uint32 and table.shape == (32,)
    assert _vote(table)
    np.testing.assert_array_equal(table, juts.geom_thresholds(b0))


@pytest.mark.parametrize("b0", B0S + (1.0, 6.0, 1e6))
def test_search_model_equals_the_32_compares(b0):
    """At every edge of the table and at random h0, for the problems'
    tables, one whose T_k are all large (counts of 31 and 32) and ones with
    ties (T_k == T_{k+1}, zeros at the end)."""
    rng = np.random.default_rng(int(b0))
    tables = [uts.geom_thresholds(b0)]
    tied = np.sort(rng.integers(0, 2 ** 32, 32, dtype=np.uint64))[::-1]
    tied[10:14] = tied[10]
    tied[-5:] = 0
    tables.append(tied.astype(np.uint32))
    for table in tables:
        assert _vote(table)
        h0 = _probes(table, rng)
        want = (h0[:, None] < table[None, :]).sum(-1)
        np.testing.assert_array_equal(_search(h0, table), want)
        np.testing.assert_array_equal(
            uts.child_count(h0, table, np), want.astype(np.int32))


def test_an_unsorted_table_fails_the_vote():
    """The search would miscount a table out of order; the vote sends such
    a table to the 32 compares."""
    rng = np.random.default_rng(1)
    table = rng.permutation(uts.geom_thresholds(4.0))
    assert not _vote(table)
    h0 = _probes(table, rng)
    want = (h0[:, None] < table[None, :]).sum(-1)
    assert (_search(h0, table) != want).any()
