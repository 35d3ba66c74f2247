"""The port's SSD kernel module against the JAX package.

``ssd_ref`` (sequential scan) and ``ssd_chunked_ref`` (chunk-matmul form,
the kernel's arithmetic) are held against ``repro.kernels.ref.ssd_ref``
and the Pallas kernel run with ``interpret=True``, at the shapes of
``tests/test_kernels.py``'s SSD sweep and with bfloat16 x. Inputs are made
from a seed with numpy and fed to both packages.

Tolerance (float32): 5e-5 absolute, 1e-4 relative, as the JAX package's
own SSD test: the scan and the chunk form sum the same terms in another
order. bfloat16 y is compared in float32 after one rounding on both
sides: 1e-2, about one bf16 ulp of values of order 1.

The CUDA kernel is held against its plain version on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.mamba2_ssd import ssd_chunked as pl_ssd
from repro_torch.kernels import ops
from repro_torch.kernels.mamba2_ssd import (ssd_chunked, ssd_chunked_ref,
                                            ssd_ref)

TOL = dict(atol=5e-5, rtol=1e-4)
T_ = torch.from_numpy
J = jnp.asarray


def _inputs(seed, Bt, T, H, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(Bt, T, H, P)
    dt = (np.log1p(np.exp(f(Bt, T, H))) * 0.1).astype(np.float32)
    A = (-np.exp(f(H))).astype(np.float32)
    return x, dt, A, f(Bt, T, N), f(Bt, T, N)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("Bt,T,H,P,N,chunk", [
    (1, 128, 2, 64, 64, 32),
    (2, 64, 4, 32, 128, 64),
    (1, 256, 3, 64, 64, 64),
    (1, 64, 1, 128, 64, 16),
])
def test_ssd_refs_match_jax(Bt, T, H, P, N, chunk):
    args = _inputs(T + H, Bt, T, H, P, N)
    yj, hj = ref.ssd_ref(*map(J, args))
    yp, hp = pl_ssd(*map(J, args), chunk=chunk, interpret=True)
    targs = tuple(map(T_, args))
    for y, h in (ssd_ref(*targs), ssd_chunked_ref(*targs, chunk=chunk)):
        _close(y, yj)
        _close(h, hj)
        _close(y, yp)
        _close(h, hp)
    y, h = ssd_chunked(*targs, chunk=chunk)        # CPU -> plain version
    yc, hc = ssd_chunked_ref(*targs, chunk=chunk)
    assert torch.equal(y, yc) and torch.equal(h, hc)


def test_ssd_bf16_x():
    x, dt, A, B, C = _inputs(7, 1, 64, 2, 32, 64)
    xb = J(x).astype(jnp.bfloat16)
    yj, hj = ref.ssd_ref(xb, J(dt), J(A), J(B), J(C))
    xt = T_(x).to(torch.bfloat16)
    args = (xt, T_(dt), T_(A), T_(B), T_(C))
    for y, h in (ssd_ref(*args), ssd_chunked_ref(*args, chunk=32)):
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        _close(y.float(), np.asarray(yj, np.float32), atol=1e-2, rtol=1e-2)
        _close(h, hj)


def test_ssd_chunk_contract():
    """JAX's contract: L = min(chunk, T) must divide T. A sequence shorter
    than the chunk is one chunk; a ragged tail raises."""
    args = tuple(map(T_, _inputs(3, 1, 24, 2, 16, 8)))
    y, h = ssd_chunked(*args, chunk=64)                # L = T = 24
    yr, hr = ssd_ref(*args)
    _close(y, yr)
    _close(h, hr)
    for fn in (ssd_chunked, ssd_chunked_ref):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            fn(*args, chunk=16)                         # 24 % 16 != 0


def test_ops_ssd_routes_and_checks():
    args = tuple(map(T_, _inputs(4, 1, 256, 2, 16, 8)))
    y, h = ops.ssd(*args)                     # auto: CPU -> plain, L = 64
    yc, hc = ssd_chunked_ref(*args, chunk=64)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    y, h = ops.ssd(*args, impl="ref")
    yr, hr = ssd_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    y, h = ops.ssd(*args, impl="chunked")     # JAX: chunk max(chunk, 128)
    yc, hc = ssd_chunked_ref(*args, chunk=128)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    for impl in ("pallas", "pallas_interpret", "decode"):
        with pytest.raises(ValueError, match="unknown ssd impl"):
            ops.ssd(*args, impl=impl)


def test_cpu_path_never_counts_a_launch():
    ops.reset_launches()
    ssd_chunked(*map(T_, _inputs(5, 1, 16, 1, 16, 8)), chunk=8)
    assert ops.kernel_launches()["ssd_chunked"] == 0
