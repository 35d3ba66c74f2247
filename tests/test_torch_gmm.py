"""The port's plain grouped matmul (``gmm_ref``, what ``gmm`` runs on a CPU
tensor) against the JAX package's: the Pallas kernel in interpret mode and
``repro.kernels.ref.gmm_ref``.

Shapes: those of ``tests/test_kernels.py``'s gmm sweep, T and F that fit
no tile, and a hypothesis case with empty groups and group boundaries
inside a tile. Rows past ``sum(group_sizes)`` are zeros in the port, as
the Pallas kernel writes them (``ref.gmm_ref`` gives them the last
expert's product instead; the JAX tests always fill T, where the two
agree).

Tolerance: 1e-5 absolute and relative, float32 on both sides. The inputs
are standard normal with D <= 72, so outputs are of order 10 and the two
sides differ only in the order XLA and PyTorch sum D products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _optional_hypothesis import given, settings, st
from repro.kernels import ref
from repro.kernels.moe_gmm import gmm as pallas_gmm
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import gmm, gmm_ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, sizes, T, D, F):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = rng.standard_normal((len(sizes), D, F)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32)


def _port(x, w, gs):
    return gmm_ref(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(gs)).numpy()


def _pallas(x, w, gs, bt, bf):
    return np.asarray(pallas_gmm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(gs), block_t=bt, block_f=bf,
                                 interpret=True))


def _fill(rng, T, E):
    """Random group sizes summing to T (some may be 0)."""
    raw = (rng.dirichlet(np.ones(E)) * T).astype(np.int64)
    raw[-1] = T - raw[:-1].sum()
    return raw


@pytest.mark.parametrize("T,D,F,E,bt,bf", [
    (256, 64, 128, 4, 64, 64),         # the JAX sweep
    (128, 32, 64, 8, 128, 64),
    (512, 16, 32, 2, 64, 32),
    (77, 24, 40, 3, 128, 128),         # T and F fit no tile
    (130, 72, 100, 5, 256, 128),
])
def test_plain_gmm_matches_jax(T, D, F, E, bt, bf):
    rng = np.random.default_rng(T + E)
    x, w, gs = _inputs(T * F, _fill(rng, T, E), T, D, F)
    got = _port(x, w, gs)
    np.testing.assert_allclose(got, _pallas(x, w, gs, bt, bf), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.gmm_ref(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(gs))), **TOL)


@settings(max_examples=15, deadline=None)
@given(sizes=st.lists(st.integers(0, 64), min_size=2, max_size=6))
def test_plain_gmm_group_edges(sizes):
    """Empty groups and group boundaries inside a tile, against the
    Pallas kernel (64-row tiles) in interpret mode."""
    T = 128
    total = sum(sizes)
    if total > T or total == 0:
        return
    sizes = list(sizes)
    sizes[-1] += T - total             # fill T, as the JAX test does
    x, w, gs = _inputs(total, sizes, T, 16, 32)
    got = _port(x, w, gs)
    np.testing.assert_allclose(got, _pallas(x, w, gs, 64, 32), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.gmm_ref(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(gs))), **TOL)


@pytest.mark.parametrize("sizes", [[10, 0, 20], [0, 0, 0], [64, 0, 0],
                                   [3, 50, 7]])
def test_rows_past_the_groups_are_zeros_as_in_the_pallas_kernel(sizes):
    T, D, F = 64, 16, 32
    x, w, gs = _inputs(sum(sizes) + 1, sizes, T, D, F)
    got = _port(x, w, gs)
    want = _pallas(x, w, gs, 32, 32)
    total = sum(sizes)
    assert (want[total:] == 0).all() and (got[total:] == 0).all()
    np.testing.assert_allclose(got, want, **TOL)
    if total < T and total:
        # where ref.gmm_ref differs: it clips to the last expert
        jref = np.asarray(ref.gmm_ref(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(gs)))
        np.testing.assert_allclose(got[:total], jref[:total], **TOL)
        assert np.abs(jref[total:]).max() > 0


def test_plain_gmm_keeps_bf16_and_accumulates_in_f32():
    """bf16 in, bf16 out, the f32 products rounded once: equal to the f32
    product of the same bf16 values, rounded."""
    x, w, gs = _inputs(5, [7, 9], 16, 32, 24)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    got = gmm_ref(xb, wb, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16
    want = torch.cat([xb[:7].float() @ wb[0].float(),
                      xb[7:].float() @ wb[1].float()]).bfloat16()
    assert torch.equal(got, want)


def test_ops_gmm_routing_and_checks():
    x, w, gs = _inputs(3, [5, 11], 16, 8, 12)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, gs))
    ops.reset_launches()
    want = gmm_ref(xt, wt, gt)
    for impl in ("auto", "ref"):
        assert torch.equal(ops.gmm(xt, wt, gt, impl=impl), want)
    assert torch.equal(gmm(xt, wt, gt), want)
    assert ops.kernel_launches()["gmm"] == 0     # the CPU path never counts
    for impl in ("pallas", "pallas_interpret", "kernel"):
        with pytest.raises(ValueError, match="unknown gmm impl"):
            ops.gmm(xt, wt, gt, impl=impl)
    with pytest.raises(ValueError, match="unsupported device"):
        gmm(xt.to("meta"), wt.to("meta"), gt.to("meta"))
