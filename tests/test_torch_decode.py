"""The decode kernels' modules: launch plan and parity at the served shapes.

``flash_decode`` and ``paged_decode`` launch, for bf16, the split-KV
tensor-core kernels of ``csrc/decode_tc.cu``, whose grid and cluster size
``_build.decode_plan`` picks from static shapes alone; that plan is
checked here for the four attention configurations the port serves. On
the CPU each wrapper runs its plain version, held, in float32, against the
JAX package's Pallas kernels in interpret mode at those configurations'
GQA groups and head dims (at a small batch and cache). Tolerance: 2e-5
absolute and relative, float32 on both sides (the same sums in another
order), as in ``tests/test_torch_kernels.py``. The kernels themselves are
held against the plain versions on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_decode import flash_decode as pl_decode
from repro.kernels.paged_decode import paged_decode as pl_paged
from repro_torch.configs import ARCHS
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_decode import paged_decode

TOL = dict(atol=2e-5, rtol=2e-5)
SERVED = ("tinyllama-1.1b", "qwen2-1.5b", "moonshot-v1-16b-a3b",
          "phi3.5-moe-42b-a6.6b")
SLOTS = 8            # the engine's max_slots in the served runs
SMS = 132            # an H100's streaming multiprocessors


@pytest.mark.parametrize("arch", SERVED)
def test_decode_plan_fills_the_card_from_shapes_alone(arch):
    cfg = ARCHS[arch]
    group = cfg.n_heads // cfg.n_kv_heads
    c, grid = _build.decode_plan(SLOTS, cfg.n_kv_heads, group)
    slices = cfg.n_kv_heads * -(-group // 16)
    assert grid == (c, slices, SLOTS)
    assert c in (1, 2, 4, 8) and c <= _build.MAX_CLUSTER
    blocks = c * slices * SLOTS
    # the largest cluster that keeps the grid to one wave of two blocks
    # per SM
    assert blocks <= 2 * SMS or c == 1
    assert c == _build.MAX_CLUSTER or 2 * blocks > 2 * SMS
    # the same plan whatever the slots' lengths: it never sees them
    assert _build.decode_plan(SLOTS, cfg.n_kv_heads, group) == (c, grid)


def test_decode_plan_at_the_served_shapes():
    """tinyllama's and qwen2's few (slot, KV head) pairs take clusters of
    8, phi3.5-moe's 64 clusters of 4, moonshot's 128 clusters of 2; more
    slots take smaller clusters, down to one block."""
    assert _build.decode_plan(8, 4, 8) == (8, (8, 4, 8))
    assert _build.decode_plan(8, 2, 6) == (8, (8, 2, 8))
    assert _build.decode_plan(8, 8, 4) == (4, (4, 8, 8))
    assert _build.decode_plan(8, 16, 1) == (2, (2, 16, 8))
    assert _build.decode_plan(64, 16, 1) == (1, (1, 16, 64))
    assert _build.decode_plan(1, 1, 128) == (8, (8, 8, 1))


@pytest.mark.parametrize("group", [0, 129])
def test_decode_plan_rejects_groups_it_does_not_take(group):
    with pytest.raises(ValueError, match="GQA group"):
        _build.decode_plan(8, 4, group)


def _served(arch):
    cfg = ARCHS[arch]
    return cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, cfg.hd


@pytest.mark.parametrize("arch", SERVED)
def test_flash_decode_matches_jax_at_the_served_groups(arch):
    group, Hkv, D = _served(arch)
    Hkv = min(Hkv, 2)                      # keep the CPU run small
    rng = np.random.default_rng(group * D)
    lens = np.asarray([0, 1, 47, 48, 20], np.int32)   # idle, edge, full
    B, S = len(lens), 48
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, 1, group * Hkv, D), f(B, S, Hkv, D), f(B, S, Hkv, D)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(lens))
    want = pl_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lens), block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0].abs().max()) == 0.0          # idle: exact zeros


@pytest.mark.parametrize("arch", SERVED)
def test_paged_decode_matches_jax_at_the_served_groups(arch):
    group, Hkv, D = _served(arch)
    Hkv = min(Hkv, 2)
    rng = np.random.default_rng(group * D + 1)
    lens = np.asarray([0, 1, 47, 64, 20], np.int32)
    B, Bs, MB = len(lens), 16, 4
    NB = B * MB
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kp, vp = f(B, 1, group * Hkv, D), f(NB, Bs, Hkv, D), f(NB, Bs, Hkv, D)
    perm = list(rng.permutation(NB))
    bt = rng.integers(-5, 3 * NB, (B, MB)).astype(np.int32)  # garbage
    for b, L in enumerate(lens):
        n = -(-int(L) // Bs)
        bt[b, :n] = [perm.pop() for _ in range(n)]
    args = (q, kp, vp, bt, lens)
    got = paged_decode(*map(torch.from_numpy, args))
    want = pl_paged(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0].abs().max()) == 0.0
