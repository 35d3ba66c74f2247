"""The port's attention kernel modules against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; those are
held, in float32, against ``repro.kernels.ref``'s oracles and against the
Pallas kernels run with ``interpret=True``. Inputs are made from a seed
with numpy and fed to both packages.

Tolerance: 2e-5 absolute and relative, float32 on both sides: the two
compute the same sums in a different order (einsum vs XLA dot_general /
the Pallas online softmax), a few ulp of values of order 1.

Idle slots (length 0): the kernels output zeros and the port's plain
versions follow them; ``ref.decode_ref`` returns uniform attention there,
so idle rows are compared against the interpret-mode Pallas kernel.

The last test holds each CUDA kernel against its plain version and runs
only where there is a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.kernels.flash_decode import flash_decode as pl_decode
from repro.kernels.paged_decode import paged_decode as pl_paged
from repro.kernels.paged_decode import paged_prefill as pl_prefill
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_decode import decode_ref, flash_decode
from repro_torch.kernels.paged_decode import (paged_decode, paged_decode_ref,
                                              paged_prefill,
                                              paged_prefill_ref)

TOL = dict(atol=2e-5, rtol=2e-5)
BS, MAX_BLOCKS, NUM_BLOCKS = 16, 8, 40


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tables(rng, lens, garbage=False):
    """Disjoint scrambled tables; past each allocation -1, or random
    out-of-range garbage."""
    perm = list(rng.permutation(NUM_BLOCKS))
    bt = np.full((len(lens), MAX_BLOCKS), -1, np.int32)
    if garbage:
        bt[:] = rng.integers(-7, 5 * NUM_BLOCKS, bt.shape)
    for b, L in enumerate(lens):
        n = -(-L // BS)
        bt[b, :n] = [perm.pop() for _ in range(n)]
    return bt


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


T = torch.from_numpy
J = jnp.asarray


# ------------------------------------------------------ flash_attention
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 1)])          # MHA, GQA
@pytest.mark.parametrize("Sq,Skv,causal", [
    (32, 32, True),      # square causal prefill
    (8, 40, True),       # decode alignment: query i at Skv - Sq + i
    (24, 40, False),
    (13, 13, True),      # ragged: not a multiple of any tile
])
def test_attention_ref_matches_jax(Hq, Hkv, Sq, Skv, causal):
    rng = np.random.default_rng(Sq * 7 + Hq)
    q, k, v = (_rand(rng, 2, Sq, Hq, 16), _rand(rng, 2, Skv, Hkv, 16),
               _rand(rng, 2, Skv, Hkv, 16))
    got = attention_ref(T(q), T(k), T(v), causal=causal)
    _close(got, ref.attention_ref(J(q), J(k), J(v), causal=causal))
    assert torch.equal(flash_attention(T(q), T(k), T(v), causal=causal),
                       got)               # CPU tensor -> plain version
    if Sq % 16 == 0 and Skv % 8 == 0:
        _close(got, pl_flash(J(q), J(k), J(v), causal=causal, block_q=16,
                             block_k=16, interpret=True))


# --------------------------------------------------------- flash_decode
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 1)])
def test_decode_ref_matches_jax_mixed_and_idle(Hq, Hkv):
    rng = np.random.default_rng(Hq)
    lens = np.asarray([1, 17, 0, 64, 40], np.int32)        # slot 2 idle
    B, S = len(lens), 64
    q, k, v = (_rand(rng, B, 1, Hq, 32), _rand(rng, B, S, Hkv, 32),
               _rand(rng, B, S, Hkv, 32))
    got = decode_ref(T(q), T(k), T(v), T(lens))
    live = lens > 0
    _close(got[live], np.asarray(ref.decode_ref(J(q), J(k), J(v),
                                                J(lens)))[live])
    _close(got, pl_decode(J(q), J(k), J(v), J(lens), block_k=16,
                          interpret=True))
    assert float(got[2].abs().max()) == 0.0      # idle slot: exact zeros
    assert torch.equal(flash_decode(T(q), T(k), T(v), T(lens)), got)


# --------------------------------------------------------- paged_decode
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 1)])
@pytest.mark.parametrize("garbage", [False, True])
def test_paged_decode_ref_matches_jax(Hq, Hkv, garbage):
    rng = np.random.default_rng(Hq * 3 + garbage)
    lens = np.asarray([1, 16, 0, 128, 45], np.int32)
    B = len(lens)
    q = _rand(rng, B, 1, Hq, 32)
    kp, vp = (_rand(rng, NUM_BLOCKS, BS, Hkv, 32),
              _rand(rng, NUM_BLOCKS, BS, Hkv, 32))
    bt = _tables(rng, lens, garbage)
    got = paged_decode_ref(T(q), T(kp), T(vp), T(bt), T(lens))
    live = lens > 0
    want = ref.paged_decode_ref(J(q), J(kp), J(vp), J(bt), J(lens))
    _close(got[live], np.asarray(want)[live])
    _close(got, pl_paged(J(q), J(kp), J(vp), J(bt), J(lens),
                         interpret=True))
    assert float(got[2].abs().max()) == 0.0
    assert torch.equal(paged_decode(T(q), T(kp), T(vp), T(bt), T(lens)),
                       got)


# -------------------------------------------------------- paged_prefill
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 1)])
@pytest.mark.parametrize("Sq,offs,tail", [
    (5, [0, 8], 0),       # from scratch / block-aligned offset
    (8, [3, 16], 0),      # mid-block offset / chunk == block size
    (1, [7, 0], 0),       # one-token chunk
    (16, [16, 40], 0),    # chunk spanning blocks
    (8, [8, 0], 3),       # padded tail: window shorter than the chunk
])
def test_paged_prefill_ref_matches_jax(Hq, Hkv, Sq, offs, tail):
    rng = np.random.default_rng(Sq * 31 + offs[0] + Hq)
    lens = np.asarray([o + Sq - tail for o in offs], np.int32)
    offs = np.asarray(offs, np.int32)
    q = _rand(rng, 2, Sq, Hq, 32)
    kp, vp = (_rand(rng, NUM_BLOCKS, BS, Hkv, 32),
              _rand(rng, NUM_BLOCKS, BS, Hkv, 32))
    bt = _tables(rng, lens, garbage=bool(tail))
    args = (T(q), T(kp), T(vp), T(bt), T(lens), T(offs))
    got = paged_prefill_ref(*args)
    jargs = (J(q), J(kp), J(vp), J(bt), J(lens), J(offs))
    _close(got, ref.paged_prefill_ref(*jargs))
    _close(got, pl_prefill(*jargs, interpret=True))
    assert torch.equal(paged_prefill(*args), got)


# ---------------------------------------------------------------- ops
def test_ops_routes_every_impl_and_checks_arguments():
    rng = np.random.default_rng(5)
    q1, q4 = T(_rand(rng, 2, 1, 4, 16)), T(_rand(rng, 2, 4, 4, 16))
    k, v = T(_rand(rng, 2, 32, 2, 16)), T(_rand(rng, 2, 32, 2, 16))
    kp, vp = T(_rand(rng, NUM_BLOCKS, BS, 2, 16)), T(
        _rand(rng, NUM_BLOCKS, BS, 2, 16))
    lens = T(np.asarray([20, 9], np.int32))
    bt = T(_tables(rng, [20, 9]))
    off = T(np.asarray([16, 5], np.int32))
    for impl in ops.IMPLS:
        paged = impl.startswith("paged")
        if not impl.startswith("decode"):
            if not paged:
                assert torch.equal(ops.attention(q4, k, v, impl=impl),
                                   attention_ref(q4, k, v))
            assert torch.equal(
                ops.attention(q1, kp, vp, impl=impl, lengths=lens,
                              block_tables=bt),
                paged_decode_ref(q1, kp, vp, bt, lens))
            assert torch.equal(
                ops.attention(q4, kp, vp, impl=impl, lengths=lens + 4,
                              block_tables=bt, q_offset=off),
                paged_prefill_ref(q4, kp, vp, bt, lens + 4, off))
        if not paged:
            assert torch.equal(
                ops.attention(q1, k, v, impl=impl, lengths=lens),
                decode_ref(q1, k, v, lens))
    with pytest.raises(ValueError):
        ops.attention(q1, k, v, impl="pallas_interpret")   # no such impl
    with pytest.raises(ValueError):
        ops.attention(q1, kp, vp, block_tables=bt)         # needs lengths
    with pytest.raises(ValueError):
        ops.attention(q4, kp, vp, lengths=lens, block_tables=bt)  # q_offset
    with pytest.raises(ValueError):
        ops.attention(q4, k, v, lengths=lens)              # Sq > 1, no table
    with pytest.raises(ValueError):
        ops.attention(q1, k, v, q_offset=off)              # offset, no table
    with pytest.raises(ValueError):
        ops.attention(q4, k, v, impl="paged")              # paged, no table


def test_cpu_path_never_counts_a_launch():
    ops.reset_launches()
    rng = np.random.default_rng(1)
    q, k = T(_rand(rng, 1, 4, 2, 16)), T(_rand(rng, 1, 4, 2, 16))
    flash_attention(q, k, k)
    assert ops.kernel_launches() == {n: 0 for n in ops.kernel_launches()}


# ------------------------------------------------------- on the card
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain_versions(dtype, tol):
    """Each CUDA kernel against its plain version on the card (bf16
    outputs round once from f32 accumulators in both: <= ~1 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    cu = lambda a: torch.from_numpy(np.asarray(a)).cuda()
    cd = lambda *s: cu(_rand(rng, *s)).to(dtype)
    lens = cu(np.asarray([0, 17, 64, 33], np.int32))
    bt = cu(_tables(rng, [0, 17, 64, 33], garbage=True))
    off = cu(np.asarray([0, 3, 48, 20], np.int32))
    q, k, v = cd(4, 24, 8, 32), cd(4, 64, 2, 32), cd(4, 64, 2, 32)
    kp, vp = cd(NUM_BLOCKS, BS, 2, 32), cd(NUM_BLOCKS, BS, 2, 32)
    pairs = [
        (flash_attention(q, k, v), attention_ref(q, k, v)),
        (flash_decode(q[:, :1], k, v, lens), decode_ref(q[:, :1], k, v, lens)),
        (paged_decode(q[:, :1], kp, vp, bt, lens),
         paged_decode_ref(q[:, :1], kp, vp, bt, lens)),
        (paged_prefill(q[:, :16].contiguous(), kp, vp, bt, lens, off),
         paged_prefill_ref(q[:, :16], kp, vp, bt, lens, off)),
    ]
    for got, want in pairs:
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= tol
