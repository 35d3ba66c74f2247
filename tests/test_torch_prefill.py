"""The chunked-prefill kernel's module: launch plan and parity at the served
shapes.

``paged_prefill`` launches, for bf16, the tensor-core
``paged_prefill_tc_kernel`` of ``csrc/attention_tc.cu``, whose grid and
cluster size ``_build.prefill_plan`` picks from static shapes alone; that
plan is checked here for the chunk shapes the engines run and others. On
the CPU the wrapper runs ``paged_prefill_ref``, held, in float32, against
the JAX package's Pallas ``paged_prefill`` in interpret mode at the GQA
groups and head dims of the served chunked-prefill models (8 at D 64,
tinyllama-1.1b; 1 at D 128, moonshot-v1-16b-a3b), at narrow widths.
Tolerance: 2e-5 absolute and relative, float32 on both sides (the same
sums in another order), as in ``tests/test_torch_kernels.py``. The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_decode import paged_prefill as pl_prefill
from repro_torch.configs import ARCHS
from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode import paged_prefill

TOL = dict(atol=2e-5, rtol=2e-5)
SERVED = ("tinyllama-1.1b", "moonshot-v1-16b-a3b")
CHUNK = 64           # the engines' prefill_chunk in the served runs
SMS = 132            # an H100's streaming multiprocessors


def _plan_checks(batch, kv_heads, group, rows):
    c, grid = _build.prefill_plan(batch, kv_heads, group, rows)
    tiles = -(-rows * group // _build.PREFILL_ROWS)
    assert grid == (c * tiles, kv_heads, batch)
    # every (row, head) pair has its tile, and no tile is empty
    assert tiles * _build.PREFILL_ROWS >= rows * group
    assert (tiles - 1) * _build.PREFILL_ROWS < rows * group
    # a power-of-two cluster of at most 8, only for a grid that leaves
    # most of the card idle, and then still within one wave of two
    # blocks per SM
    assert c in (1, 2, 4, 8) and c <= _build.MAX_CLUSTER
    unsplit = tiles * kv_heads * batch
    assert (c > 1) == (unsplit <= _build.PREFILL_SPLIT_BLOCKS)
    assert c * unsplit <= 2 * SMS or c == 1
    # the same plan whatever the offsets and lengths: it never sees them
    assert _build.prefill_plan(batch, kv_heads, group, rows) == (c, grid)
    return c, grid


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_plan_fills_the_card_from_shapes_alone(arch):
    cfg = ARCHS[arch]
    _plan_checks(1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, CHUNK)


@pytest.mark.parametrize("batch,kv_heads,group,rows", [
    (1, 1, 1, 1), (2, 8, 4, 50), (1, 2, 128, 3), (8, 16, 1, 256),
    (64, 32, 8, 200), (1, 2, 8, 64), (2, 4, 8, 64)])
def test_prefill_plan_at_other_shapes(batch, kv_heads, group, rows):
    _plan_checks(batch, kv_heads, group, rows)


def test_prefill_plan_at_the_served_chunks():
    """tinyllama's chunk (512 pairs, 4 KV heads: 32 tiles) runs unsplit,
    moonshot's (64 pairs, 16 KV heads: 16 tiles) in clusters of 4, the
    choices the card measured fastest; a long prompt's 25 tiles a head
    over 32 KV heads fill the card unsplit."""
    assert _build.prefill_plan(1, 4, 8, 64) == (1, (8, 4, 1))
    assert _build.prefill_plan(1, 16, 1, 64) == (4, (4, 16, 1))
    assert _build.prefill_plan(1, 32, 8, 200) == (1, (25, 32, 1))


@pytest.mark.parametrize("group,rows", [(0, 64), (8, 0)])
def test_prefill_plan_rejects_what_it_does_not_take(group, rows):
    with pytest.raises(ValueError, match="prefill_plan"):
        _build.prefill_plan(1, 4, group, rows)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("Sq,offs,lens", [
    (16, [0, 37, 32, 0], [16, 53, 40, 0]),   # from 0, mid-block, a padded
                                             # tail, length 0
    (5, [60, 3, 16, 11], [65, 8, 21, 16]),   # a short chunk
    (1, [7, 0, 63, 30], [8, 1, 64, 0]),      # one token
])
def test_paged_prefill_matches_jax_at_the_served_groups(arch, Sq, offs,
                                                        lens):
    cfg = ARCHS[arch]
    group, D = cfg.n_heads // cfg.n_kv_heads, cfg.hd
    Hkv, Bs, MB = 2, 16, 5                 # keep the CPU run small
    B = len(offs)
    NB = B * MB
    rng = np.random.default_rng(group * D + Sq)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kp, vp = f(B, Sq, group * Hkv, D), f(NB, Bs, Hkv, D), f(NB, Bs, Hkv,
                                                               D)
    perm = list(rng.permutation(NB))
    bt = rng.integers(-5, 3 * NB, (B, MB)).astype(np.int32)  # garbage
    for b, L in enumerate(lens):
        n = -(-L // Bs)
        bt[b, :n] = [perm.pop() for _ in range(n)]
    args = (q, kp, vp, bt, np.asarray(lens, np.int32),
            np.asarray(offs, np.int32))
    got = paged_prefill(*map(torch.from_numpy, args))
    want = pl_prefill(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for b, L in enumerate(lens):
        if L == 0:
            assert float(got[b].abs().max()) == 0.0   # no key: zeros
