"""The launch plan and the arithmetic of ``ssd_chunked_kernel``, on the CPU.

``_build.ssd_plan`` (pure Python) picks the kernel's cluster size, column
tile and grid from the shapes: its clusters are powers of two up to 8 that
keep the grid within one wave of an H100, its blocks' runs of chunks cover
the T / L chunks in order, each once, none empty, its blocks cover every
(row, head, column) once, and its shared memory fits a block of an H100
up to N 256.

The kernel computes the scan in two levels: each block the local state S
and decay D of its run of chunks (from a zero state), then, across the
cluster, h_in = sum_{r<k} (prod_{r<i<k} D_i) S_r for block k, from which
the block walks its run again. ``_two_level`` below is that decomposition
in plain PyTorch, on the kernel's plan; it is held against the port's
``ssd_ref``, JAX's ``ref.ssd_ref`` and the Pallas ``ssd_chunked`` in
interpret mode, under ``tests/test_torch_ssd.py``'s float32 tolerance
(5e-5 absolute, 1e-4 relative: the same terms summed in another order).

The kernel's products are split: each float32 operand a = hi + lo with
hi = bf16(a), lo = bf16(a - hi), and a b ~ hi hi' + hi lo' + lo hi'.
``_split_product`` models that in numpy (bf16 rounding to nearest even,
products exact, float32 sums) and holds it against float64 at the depths
the kernel contracts over: its error must stay under a tenth of the card
tests' limit, 1e-4 x max(1, max |a b|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.mamba2_ssd import ssd_chunked as pl_ssd
from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd import ssd_ref

TOL = dict(atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 10, 16, 32, 100])
@pytest.mark.parametrize("L", [64, 16])
def test_plan_runs_cover_the_chunks_in_order(n, L):
    c, pt, per, grid = _build.ssd_plan(1, n * L, 4, 64, 128, L)
    assert c in (1, 2, 4, 8) and c <= n
    assert c == min(8, 1 << (n.bit_length() - 1))   # the largest that fits
    runs = [range(k * n // c, (k + 1) * n // c) for k in range(c)]
    assert [j for run in runs for j in run] == list(range(n))
    assert all(len(run) >= 1 for run in runs)        # no block idle
    assert max(len(run) for run in runs) == per
    assert grid[0] == c


@pytest.mark.parametrize("Bt,H,P", [(1, 24, 64), (3, 2, 100), (2, 5, 24),
                                    (1, 1, 16), (1, 3, 7), (4, 8, 200)])
@pytest.mark.parametrize("N", [4, 64, 128, 160, 192, 256])
def test_plan_covers_every_column_once_and_fits(Bt, H, P, N):
    c, pt, _, grid = _build.ssd_plan(Bt, 256, H, P, N, 64)
    tiles = -(-P // pt)
    assert grid == (c, H * tiles, Bt)
    cover = np.zeros((Bt, H, P), np.int64)
    for z in range(grid[2]):
        for yb in range(grid[1]):
            h, p0 = yb // tiles, yb % tiles * pt
            cover[z, h, p0:p0 + pt] += 1        # columns past P masked
    assert (cover == 1).all()
    assert _build.ssd_smem_bytes(N, pt) <= _build.SMEM_LIMIT
    # The narrowest tile that covers P, or the widest that fits.
    fits = [t for t in _build.SSD_TILES
            if _build.ssd_smem_bytes(N, t) <= _build.SMEM_LIMIT]
    assert pt == next((t for t in fits if t >= P), fits[-1])


@pytest.mark.parametrize("Bt,H,P,n", [(1, 24, 64, 16), (1, 24, 64, 4),
                                      (1, 64, 64, 16), (2, 24, 100, 8),
                                      (1, 1, 16, 3), (6, 24, 64, 16)])
def test_plan_keeps_the_grid_to_one_wave(Bt, H, P, n):
    """c doubles while the grid stays within the 132 SMs of an H100 (one
    block an SM), up to 8 and the chunks; past one wave only c = 1."""
    c, _, _, grid = _build.ssd_plan(Bt, n * 64, H, P, 128, 64)
    blocks = grid[0] * grid[1] * grid[2]
    assert blocks <= 132 or c == 1
    assert c == 8 or 2 * c > n or 2 * blocks > 132


def test_plan_at_the_served_shapes():
    # mamba2-130m: 24 heads of 64, N 128, chunk 64.
    assert _build.ssd_plan(1, 256, 24, 64, 128, 64) == (4, 64, 1,
                                                        (4, 24, 1))
    assert _build.ssd_plan(1, 1024, 24, 64, 128, 64) == (4, 64, 4,
                                                         (4, 24, 1))
    # N 256 fits only the 16-column tile.
    assert _build.ssd_plan(1, 64, 2, 64, 256, 16)[1] == 16
    assert _build.ssd_smem_bytes(256, 32) > _build.SMEM_LIMIT


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="cluster"):
        _build.ssd_plan(1, 256, 2, 64, 64, 64, cluster=3)
    with pytest.raises(ValueError, match="tile"):
        _build.ssd_plan(1, 256, 2, 64, 256, 64, tile=32)
    with pytest.raises(ValueError, match="tile"):
        _build.ssd_plan(1, 256, 2, 64, 64, 64, tile=48)
    with pytest.raises(ValueError):
        _build.ssd_plan(1, 100, 2, 64, 64, 64)          # ragged T


def _local(x, dt, A, B, C, s_from, j0, j1, L):
    """A run of chunks [j0, j1) from the state ``s_from``: (y of the run,
    the state after it, the run's decay prod exp(s_L))."""
    h, decay, ys = s_from, torch.ones_like(A), []
    tri = torch.tril(torch.ones(L, L, dtype=torch.float64))
    for j in range(j0, j1):
        sl = slice(j * L, (j + 1) * L)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        s = A[None, None, :] * torch.cumsum(dtc, 1)          # (Bt, L, H)
        dx = dtc[..., None] * xc
        G = torch.einsum("btn,bun->btu", Cc, Bc)
        M = torch.exp((s[:, :, None] - s[:, None, :]).clamp(max=0)) \
            * tri[None, :, :, None]
        y = torch.einsum("btu,btuh,buhp->bthp", G, M, dx)
        y = y + torch.exp(s)[..., None] * torch.einsum("btn,bhnp->bthp",
                                                      Cc, h)
        w = torch.exp(s[:, -1:] - s)[..., None] * dx
        h = torch.exp(s[:, -1])[:, :, None, None] * h \
            + torch.einsum("bun,buhp->bhnp", Bc, w)
        decay = decay * torch.exp(s[:, -1])
        ys.append(y)
    return ys, h, decay


def _two_level(x, dt, A, B, C, chunk):
    """The kernel's decomposition on its plan, in float64: local (S, D) of
    each block's run, the cluster combine, then each run again from its
    h_in. Returns (y, h_final)."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    L = min(chunk, T)
    c, _, _, _ = _build.ssd_plan(Bt, T, H, P, N, L)
    n = T // L
    zero = torch.zeros(Bt, H, N, P, dtype=torch.float64)
    runs = [(k * n // c, (k + 1) * n // c) for k in range(c)]
    S, D = [], []
    for j0, j1 in runs:                        # (1) no block waits
        _, s, d = _local(x, dt, A, B, C, zero, j0, j1, L)
        S.append(s)
        D.append(d[:, :, None, None])
    ys, h_out = [], None
    for k, (j0, j1) in enumerate(runs):        # (2) the combine, (3) y
        h_in = zero
        for r in range(k):
            h_in = D[r] * h_in + S[r]
        y, _, _ = _local(x, dt, A, B, C, h_in, j0, j1, L)
        ys += y
        if k == c - 1:
            h_out = D[k] * h_in + S[k]
    return torch.cat(ys, 1), h_out


def _inputs(seed, Bt, T, H, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(Bt, T, H, P)
    dt = (np.log1p(np.exp(f(Bt, T, H))) * 0.1).astype(np.float32)
    A = (-np.exp(f(H))).astype(np.float32)
    return x, dt, A, f(Bt, T, N), f(Bt, T, N)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("Bt,T,chunk", [(1, 1024, 64), (2, 320, 64),
                                        (1, 48, 16)])
def test_two_level_scan_matches_the_references(Bt, T, chunk):
    """16 chunks in clusters of 8 (two a block), 5 in clusters of 4 (a run
    of two beside runs of one), 3 in clusters of 2, at H 2, P 16, N 32."""
    args = _inputs(T + Bt, Bt, T, 2, 16, 32)
    y, h = _two_level(*(torch.from_numpy(a).double() for a in args), chunk)
    yt, ht = ssd_ref(*map(torch.from_numpy, args))
    yj, hj = ref.ssd_ref(*map(jnp.asarray, args))
    yp, hp = pl_ssd(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    for yw, hw in ((yt, ht), (yj, hj), (yp, hp)):
        _close(y, yw)
        _close(h, hw)


def _bf16(a):
    """float32 -> bf16 (round to nearest even) -> float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & ~np.uint64(0xFFFF)
    return u.astype(np.uint32).view(np.float32)


def _split_product(a, b):
    """a @ b as the kernel's bf16x3: hi = bf16(v), lo = bf16(v - hi) for
    both operands; lo hi' + hi lo' + hi hi' with exact products summed in
    float32 (as the tensor cores accumulate)."""
    ah = _bf16(a)
    al = _bf16(a - ah)
    bh = _bf16(b)
    bl = _bf16(b - bh)
    f = lambda p, q: (p.astype(np.float64) @ q.astype(np.float64)).astype(
        np.float32)
    return f(al, bh) + f(ah, bl) + f(ah, bh)


@pytest.mark.parametrize("K", [64, 128, 256])
def test_split_product_keeps_float32_accuracy(K):
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    b = rng.standard_normal((K, 64)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    limit = 1e-4 * max(1.0, np.abs(want).max())
    err = np.abs(_split_product(a, b) - want).max()
    assert err <= 0.1 * limit, (err, limit)
    # One bf16 pass would not hold the limit at all.
    one = _bf16(a).astype(np.float64) @ _bf16(b).astype(np.float64)
    assert np.abs(one - want).max() > limit
