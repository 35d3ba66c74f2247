"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This module imports torch and numpy only (no JAX), so it runs where the
card is:

    python -m pytest -q tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips without a CUDA device. The first
launch builds the kernels from ``src/repro_torch/csrc`` with ``nvcc``.

``ssd_chunked`` is held against ``ssd_chunked_ref`` (the same float32 math
in another summation order), element by element:
|got - ref| <= rel * |ref| + 1e-4 * max(1, max |ref|). The absolute term is
float32 summation order (the kernel's bf16x3 products keep ~2^-16 of each
product, a twentieth of it); rel is 0 for float32 outputs and 2^-6 for
bfloat16 y, two bf16 ulps, since both sides round once from float32 and
may land one ulp (at most 2^-7 of the value) apart. Its cases: the
mamba2-130m buckets of 256 and 1024 tokens, 2048 tokens, chunks of 8, 16
and 64, T shorter than a chunk, 1-3 rows, P 16-100 (ragged column tiles),
N 4-256, in both dtypes with one launch a call; then every cluster size
and column tile the launch plan can pick (runs of one chunk, of several,
and blocks with none), replay from a CUDA graph with new inputs, the route
each dtype takes, the first version of the kernel
(``ssd_chunked_loop_kernel``) still against the plain version, a build
failure that raises, and the shapes it refuses.

``uts_expand`` is held bit for bit against ``uts_expand_ref`` and against
the first version of its kernel (``uts_expand_lane_kernel``), at widths
that take the compiled-in and the run-time width, full and partial
vector stores, a threshold table that is not non-increasing (counted by
the 32 compares) and bases near 2^31.

``flash_attention`` is held against ``attention_ref`` (float32 math, the
output rounded once to q's dtype) by its largest absolute difference:
2e-2 for bfloat16 (one bf16 ulp of an output |o| < 4 is at most 2^-6, and
the tensor-core route rounds P to bf16, 2^-9 of each weight) and 1e-4 for
float32 (summation order), the limits ``chip_smoke.py`` holds it to. Its
cases cover head dims 16 to 128, GQA groups 1 and 8, causal and not, a
ragged Sq, Sq < Skv and Sq > Skv (rows that see no key give zeros).

``gmm`` is held against ``gmm_ref`` under the same element-wise rule as
``ssd_chunked`` (both accumulate in float32, in another order; bf16
outputs are rounded once on each side), at the two shapes the MoE layer
of moonshot-v1-16b-a3b gives it (64 experts, 1 row each at decode and 30
for a 256-token prefill bucket, D 2048 / F 1408, and F 2048 / D 1408 for
``wo``) and at edge cases: empty groups, boundaries inside a tile, T, D
and F that fit no tile, rows past the last group (zeros), the compact
decode shape the MoE layer now gives it (about 10 of 64 experts with one
row each, the rest empty) and grids too small to fill the card.

``flash_decode`` and ``paged_decode`` are held against ``decode_ref`` /
``paged_decode_ref`` under ``flash_attention``'s limits (the bf16 route
rounds P to bf16 once on the tensor cores, as ``flash_attention``'s does;
a group of one is scored on the CUDA cores with P in float32), at GQA
groups 1, 4, 6 and 8 (the served models') and head dims 64 and 128, in
both dtypes, with lengths at the edges of the bf16 kernel's split (idle,
one key, either side of a share step and of a full tile per block, the
whole cache, past it), garbage and negative table entries, and exact
zeros for the idle slot; then small head dims and groups above 16 heads,
replay from a CUDA graph with new lengths, the route each dtype takes,
one launch per call, and a build failure that raises.

``paged_prefill`` is held against ``paged_prefill_ref`` under the same
limits (the bf16 route rounds P to bf16 once on the tensor cores), at GQA
groups 1, 4 and 8, head dims 64 and 128, both dtypes and chunks of 1, 24,
50, 64 and 200 rows, each chunk in five sequences: from position 0, at a
mid-block offset, at a block-aligned one, with a padded tail (rows past
the window, which see the whole window), and of length 0 (exact zeros);
the tables hold garbage past each allocation. Then every cluster size
the bf16 kernel takes, replay from a CUDA graph with new offsets and
lengths, the route each dtype takes, one launch per call, and a build
failure that raises.

Head dim 112 (zamba2-7b's 3584 / 32): the four attention kernels in both
dtypes at groups 1 and 4 (in bf16 both through the tensor-core decode
scoring, which beat the CUDA cores' layout for a group of one at D 112),
the engines' shapes (a 256-token prompt, 8 decode slots
of 100-384 keys, a 64-row chunk at offset 128, 32/32 heads), and head
dims outside {16, 32, 64, 112, 128} refused with ValueError before any
launch; ``ssd_chunked`` at zamba2's 112 heads of P 64, N 64; and the
zamba2 smoke config served on the card, contiguous and paged, with the
tokens of its plain path.

Live migration: KV blocks gathered on the card, copied to host memory and
back and scattered into another pool arrive bit for bit in bf16 and f32,
with every other block (the sink included) untouched; and a 2-replica
``tinyllama-1.1b.smoke()`` fabric with ``migrate=True`` lands a live
sequence, decodes it through ``paged_decode``, terminates, and emits the
tokens of one engine that kept everything.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_decode import decode_ref, flash_decode
from repro_torch.kernels.mamba2_ssd import _launch as ssd_launch
from repro_torch.kernels.mamba2_ssd import ssd_chunked, ssd_chunked_ref
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.paged_decode import (paged_decode, paged_decode_ref,
                                              paged_prefill,
                                              paged_prefill_ref)
from repro_torch.kernels.uts_expand import _launch as uts_launch
from repro_torch.kernels.uts_expand import uts_expand, uts_expand_ref
from repro_torch.problems.uts import geom_thresholds


def _inputs(seed, Bt, T, H, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).cuda()
    x = f(Bt, T, H, P)
    dt = torch.nn.functional.softplus(f(Bt, T, H)) * 0.1
    A = -torch.exp(f(H))
    return x, dt, A, f(Bt, T, N), f(Bt, T, N)


def _close(got, want, rel) -> bool:
    got, want = got.float(), want.float()
    limit = rel * want.abs() + 1e-4 * max(1.0, want.abs().max().item())
    return bool(((got - want).abs() <= limit).all())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means f32


SSD_RELS = [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -6)]


def _check_ssd(args, chunk, rel, **launch):
    """One launch (through the wrapper, or ``_launch`` with ``launch``)
    against ssd_chunked_ref under ``_close``."""
    x = args[0]
    if launch:
        y, h = ssd_launch(*args, chunk, **launch)
    else:
        y, h = ssd_chunked(*args, chunk=chunk)
    yr, hr = ssd_chunked_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    assert _close(y, yr, rel)
    assert _close(h, hr, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", SSD_RELS)
@pytest.mark.parametrize("Bt,T,H,P,N,chunk", [
    (1, 256, 24, 64, 128, 64),     # the mamba2-130m prefill bucket
    (2, 64, 3, 32, 64, 64),
    (1, 24, 2, 16, 16, 64),        # T shorter than the chunk
    (1, 40, 2, 24, 20, 8),         # P not a multiple of the 16-column tile
    (1, 64, 2, 64, 256, 16),       # the largest state the kernel takes
    (1, 1024, 24, 64, 128, 64),    # the 1024-token bucket: 16 chunks
    (1, 2048, 4, 64, 128, 64),     # 32 chunks, 4 a block
    (1, 256, 4, 64, 128, 16),      # chunk 16: 16 chunks
    (3, 192, 3, 32, 64, 64),       # three rows of 3 chunks
    (1, 128, 3, 24, 32, 32),       # P 24: a ragged 32-column tile
    (1, 256, 2, 100, 64, 64),      # P 100: a full and a ragged tile
    (1, 128, 2, 16, 4, 32),        # the smallest state
    (1, 512, 2, 64, 256, 64),      # the largest state over 8 chunks
])
def test_ssd_kernel_matches_plain_version(card, Bt, T, H, P, N, chunk,
                                          dtype, rel):
    x, dt, A, B, C = _inputs(T + N, Bt, T, H, P, N)
    ops.reset_launches()
    _check_ssd((x.to(dtype), dt, A, B, C), chunk, rel)
    assert ops.kernel_launches()["ssd_chunked"] == 1   # one launch a call


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", SSD_RELS)
@pytest.mark.parametrize("T", [256, 1024])
def test_ssd_kernel_at_zamba2_shape(card, T, dtype, rel):
    """zamba2-7b's Mamba2 layer: 112 heads of P 64, state 64, at the
    256- and 1024-token buckets; one launch a call."""
    x, dt, A, B, C = _inputs(T + 112, 1, T, 112, 64, 64)
    ops.reset_launches()
    _check_ssd((x.to(dtype), dt, A, B, C), 64, rel)
    assert ops.kernel_launches()["ssd_chunked"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("T,chunk", [(320, 64), (1024, 64), (48, 16)])
def test_ssd_kernel_at_every_cluster_and_tile(card, cluster, tile, T,
                                              chunk):
    """Clusters of 1-8 blocks over 5, 16 and 3 chunks (runs of one chunk,
    of several, and blocks with none when c exceeds the chunks) and every
    column tile at a P of 40 (ragged at each tile), in bf16."""
    args = _inputs(cluster + tile + T, 1, T, 3, 40, 64)
    _check_ssd((args[0].bfloat16(), *args[1:]), chunk, 2.0 ** -6,
               cluster=cluster, tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 1024])
def test_ssd_kernel_replays_in_a_cuda_graph(card, T):
    """A captured launch replays with new inputs copied into its tensors:
    its grid and cluster come from the shapes only."""
    x, dt, A, B, C = _inputs(1, 1, T, 24, 64, 128)
    x = x.bfloat16()
    ssd_chunked(x, dt, A, B, C)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, h = ssd_chunked(x, dt, A, B, C)
    for seed in (2, 3):
        for dst, src in zip((x, dt, A, B, C), _inputs(seed, 1, T, 24, 64,
                                                       128)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        yr, hr = ssd_chunked_ref(x, dt, A, B, C, chunk=64)
        assert _close(y, yr, 2.0 ** -6) and _close(h, hr, 0.0)


class _EntrySpy:
    """A kernel library that records which entry points are taken."""

    def __init__(self, lib):
        self.lib, self.taken = lib, []

    def __getattr__(self, name):
        self.taken.append(name)
        return getattr(self.lib, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_routes_by_dtype(card, monkeypatch, dtype):
    """Both dtypes of x launch ssd_chunked_kernel (the 3xTF32 products hold
    float32's limits), one launch a call; the plain versions launch
    nothing."""
    spy = _EntrySpy(_build.lib("ssd"))
    real_lib = _build.lib
    monkeypatch.setattr(_build, "lib",
                        lambda name: spy if name == "ssd" else real_lib(name))
    x, dt, A, B, C = _inputs(4, 1, 128, 2, 32, 64)
    ops.reset_launches()
    ops.ssd(x.to(dtype), dt, A, B, C)
    ops.ssd(x.to(dtype), dt, A, B, C, impl="ref")
    ops.ssd(x.to(dtype), dt, A, B, C, impl="chunked")
    torch.cuda.synchronize()
    assert spy.taken == ["repro_ssd_chunked"]
    counts = ops.kernel_launches()
    assert counts["ssd_chunked"] == 1 and sum(counts.values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", SSD_RELS)
@pytest.mark.parametrize("Bt,T,H,P,N,chunk", [
    (1, 256, 24, 64, 128, 64), (1, 40, 2, 24, 20, 8),
    (1, 64, 2, 64, 256, 16), (1, 1024, 4, 64, 128, 64)])
def test_ssd_loop_kernel_matches_plain_version(card, Bt, T, H, P, N, chunk,
                                               dtype, rel):
    """The first version of the kernel (ssd_chunked_loop_kernel), which the
    wrapper no longer calls, still holds; it counts no launch."""
    x, dt, A, B, C = _inputs(T + P, Bt, T, H, P, N)
    ops.reset_launches()
    _check_ssd((x.to(dtype), dt, A, B, C), chunk, rel, loop=True)
    assert ops.kernel_launches()["ssd_chunked"] == 0


@pytest.mark.cuda
def test_ssd_build_failure_raises(card, tmp_path, monkeypatch):
    """A source that does not compile raises from the first launch; there
    is no fallback to the plain version."""
    bad = tmp_path / "ssd.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "SOURCES", dict(_build.SOURCES, ssd=bad))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ssd_chunked(*_inputs(0, 1, 64, 2, 16, 16), chunk=64)
    assert ops.kernel_launches()["ssd_chunked"] == 0


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_does_not_take(card):
    x, dt, A, B, C = _inputs(0, 1, 40, 2, 16, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunked(x, dt, A, B, C, chunk=16)          # ragged last chunk
    with pytest.raises(ValueError, match="chunk 128 > 64"):
        ssd_chunked(*_inputs(0, 1, 128, 2, 16, 16), chunk=128)
    with pytest.raises(TypeError, match="dt must be float32"):
        ssd_chunked(x, dt.bfloat16(), A, B, C, chunk=8)
    with pytest.raises(ValueError, match="state size"):
        ssd_chunked(*_inputs(0, 1, 40, 2, 16, 18), chunk=8)
    strided = C.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunked(x, dt, A, B, strided, chunk=8)


def _uts_inputs(seed, M, base_lo, base_hi, thresholds=None):
    """Descriptors with the high bit set (uint32 bits in int32), bases in
    [base_lo, base_hi), the thresholds of the paper's b0 = 4 tree (or the
    uint32 table given)."""
    rng = np.random.default_rng(seed)
    bits = lambda: torch.from_numpy(
        (rng.integers(0, 2 ** 31, M, dtype=np.int64) | 2 ** 31)
        .astype(np.uint32).view(np.int32)).cuda()
    base = torch.from_numpy(
        rng.integers(base_lo, base_hi, M).astype(np.int32)).cuda()
    if thresholds is None:
        thresholds = geom_thresholds(4.0)
    thr = torch.from_numpy(thresholds.view(np.int32)).cuda()
    return bits(), bits(), base, thr


def _check_uts(args, width):
    """The kernel once (one launch), bit for bit against the plain version
    and the first version of the kernel; returns its outputs."""
    M = args[0].shape[0]
    ops.reset_launches()
    got = uts_expand(*args, width=width)
    want = uts_expand_ref(*args, width)
    first = uts_launch("repro_uts_expand_lane", *args, width)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["uts_expand"] == 1
    for g, w, f in zip(got, want, first):
        assert g.dtype == torch.int32 and g.shape == (M, width)
        assert torch.equal(g, w)
        assert torch.equal(f, w)
    assert int(got[2].min()) >= 0 and int(got[2].max()) <= 32
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("M,width,base_hi", [
    (1024, 256, 32),          # the UTS path: 1024 places, width n = 256
    (1, 8, 32),
    (1000, 64, 32),           # M not a multiple of 128
    (77, 256, 2 ** 31 - 256),  # base + lane up to 2^31 - 1
    (300, 1, 32),             # widths at run time: one scalar lane,
    (301, 3, 32),             # three, a 16-byte row,
    (129, 8, 32),
    (97, 100, 2 ** 31 - 100),  # and 25 vector stores a row near 2^31
])
def test_uts_expand_kernel_is_bit_exact(card, M, width, base_hi):
    _check_uts(_uts_inputs(M + width, M, max(0, base_hi - 32), base_hi),
               width)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 8, 64, 100, 256])
def test_uts_expand_kernel_counts_an_unsorted_table(card, width):
    """A table that is not non-increasing fails the kernel's vote and is
    counted by the 32 compares: still bit-exact, counts past the sorted
    table's prefix included."""
    rng = np.random.default_rng(width)
    table = rng.permutation(geom_thresholds(4.0))
    got = _check_uts(_uts_inputs(width, 513, 2 ** 31 - 300, 2 ** 31 - 256,
                                 table), width)
    assert int(got[2].max()) > 0


@pytest.mark.cuda
def test_uts_expand_kernel_rejects_what_it_does_not_take(card):
    d0, d1, base, thr = _uts_inputs(0, 16, 0, 8)
    with pytest.raises(TypeError, match="d0 must be int32"):
        uts_expand(d0.long(), d1, base, thr, width=8)
    with pytest.raises(ValueError, match="thresholds shape"):
        uts_expand(d0, d1, base, thr[:16], width=8)
    with pytest.raises(ValueError, match="width"):
        uts_expand(d0, d1, base, thr, width=0)


def _gmm_inputs(seed, sizes, T, D, F, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((len(sizes), D, F))
                          / np.sqrt(D)).astype(np.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    return x.to("cuda", dtype), w.to("cuda", dtype), gs.cuda()


GMM_CASES = [
    # (sizes, T, D, F); the kernel's tile follows the mean group ceil(T / E)
    ([1] * 64, 64, 2048, 1408),             # decode: 8 slots x top-6
    ([30] * 64, 1920, 2048, 1408),          # prefill: 256-token bucket
    ([30] * 64, 1920, 1408, 2048),          # prefill, the wo product
    ([0, 5, 0, 40, 17, 0, 3], 80, 72, 100),  # empty groups, tail 15
    ([33, 0, 0, 95], 128, 40, 36),          # straddled tiles, odd D and F
    ([0, 0, 0], 19, 24, 8),                 # no group: all zeros
    ([70, 2, 9], 81, 16, 200),              # a group far above the mean
    ([10] * 12, 127, 300, 130),             # 16-row tiles, D, F not % 8
    ([2, 3, 0, 4], 9, 64, 520),             # 4-row tiles, a partial column
    # compact decode: 10 of 64 experts keep one row, 54 rows of zeros
    ([1 if e in (2, 5, 9, 17, 23, 30, 41, 47, 58, 63) else 0
      for e in range(64)], 64, 2048, 1408),
    ([0] * 60 + [1, 0, 0, 1], 64, 1408, 2048),  # compact decode, wo
    ([3, 0], 8, 256, 64),                   # one column tile, 2 blocks
    ([0, 17], 17, 96, 40),                  # one partial column tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0),
                                       (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("sizes,T,D,F", GMM_CASES)
def test_gmm_kernel_matches_plain_version(card, sizes, T, D, F, dtype, rel):
    x, w, gs = _gmm_inputs(T + D + F, sizes, T, D, F, dtype)
    ops.reset_launches()
    got = gmm(x, w, gs)
    want = gmm_ref(x, w, gs)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["gmm"] == 1
    assert got.dtype == dtype and got.shape == (T, F)
    assert torch.isfinite(got.float()).all()
    assert _close(got, want, rel)
    total = min(sum(sizes), T)
    assert (got[total:] == 0).all()         # rows past the last group


@pytest.mark.cuda
def test_gmm_counts_launches_and_rejects_what_it_does_not_take(card):
    x, w, gs = _gmm_inputs(0, [3, 5], 8, 16, 24, torch.bfloat16)
    ops.reset_launches()
    ops.gmm(x, w, gs)
    ops.gmm(x, w, gs, impl="ref")            # the plain version: no launch
    gmm(x, w, gs)
    assert ops.kernel_launches()["gmm"] == 2
    with pytest.raises(TypeError, match="mixed dtypes"):
        gmm(x, w.float(), gs)
    with pytest.raises(TypeError, match="int32"):
        gmm(x, w, gs.long())
    with pytest.raises(ValueError, match="shape"):
        gmm(x, w, gs[:1])
    with pytest.raises(ValueError, match="contiguous"):
        gmm(x.t().contiguous().t(), w, gs)
    with pytest.raises(ValueError, match="bad shapes"):
        gmm(x, w[:, :8], gs)
    assert ops.kernel_launches()["gmm"] == 2


@pytest.mark.cuda
def test_gmm_build_failure_raises(card, tmp_path, monkeypatch):
    """A source that does not compile raises from the first launch; there
    is no fallback to the plain version."""
    bad = tmp_path / "gmm.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "SOURCES", dict(_build.SOURCES, gmm=bad))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    x, w, gs = _gmm_inputs(0, [4], 4, 8, 8, torch.float32)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gmm(x, w, gs)
    assert ops.kernel_launches()["gmm"] == 0


ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _attn_inputs(seed, B, Sq, Skv, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    return f(B, Sq, Hq, D), f(B, Skv, Hkv, D), f(B, Skv, Hkv, D)


def _check_attention(q, k, v, causal):
    ops.reset_launches()
    got = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[q.dtype], err
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv", [
    (2, 77, 77),          # ragged Sq, two prompts
    (1, 40, 96),          # Sq < Skv: queries at the end of the keys
    (1, 70, 50),          # Sq > Skv: causal rows 0-19 see no key
])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_matches_plain_version(card, dtype, causal, D,
                                                      group, B, Sq, Skv):
    Hkv = 2
    q, k, v = _attn_inputs(Sq * D + group, B, Sq, Skv, group * Hkv, Hkv, D,
                           dtype)
    got = _check_attention(q, k, v, causal)
    if causal and Sq > Skv:
        assert (got[:, :Sq - Skv] == 0).all()   # no visible key: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 4, 64),     # tinyllama-1.1b
                                      (16, 16, 128)])  # moonshot-v1-16b-a3b
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_at_the_prompt_shapes(card, dtype, Hq, Hkv, D):
    """A 256-token prompt bucket of the two served attention shapes."""
    _check_attention(*_attn_inputs(D, 1, 256, 256, Hq, Hkv, D, dtype), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,library", [(torch.bfloat16, "attention_tc"),
                                           (torch.float32, "attention")])
def test_flash_attention_routes_by_dtype(card, monkeypatch, dtype, library):
    """bf16 launches the tensor-core kernel of attention_tc.cu, float32 the
    CUDA-core kernel of attention.cu; either counts one launch."""
    asked = []
    real_lib = _build.lib

    def spy(name):
        asked.append(name)
        return real_lib(name)

    monkeypatch.setattr(_build, "lib", spy)
    q, k, v = _attn_inputs(0, 1, 16, 16, 8, 2, 64, dtype)
    ops.reset_launches()
    ops.attention(q, k, v, causal=True)
    ops.attention(q, k, v, causal=True, impl="ref")   # plain: no launch
    torch.cuda.synchronize()
    assert asked == [library]
    assert ops.kernel_launches()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv", [(2, 77, 77), (1, 40, 96),
                                      (1, 70, 50)])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_at_head_dim_112(card, dtype, causal, group,
                                                B, Sq, Skv):
    """D 112: a row is 14 16-byte chunks, Q K^T 7 k-steps, O 14 n8
    tiles on the tensor cores; 28 float4 columns on the CUDA cores."""
    q, k, v = _attn_inputs(Sq + group, B, Sq, Skv, group * 2, 2, 112, dtype)
    got = _check_attention(q, k, v, causal)
    if causal and Sq > Skv:
        assert (got[:, :Sq - Skv] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_at_zamba2_prompt(card, dtype):
    """zamba2-7b's shared attention block on a 256-token bucket."""
    _check_attention(*_attn_inputs(112, 1, 256, 256, 32, 32, 112, dtype),
                     True)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 48, 96, 120, 256])
def test_attention_kernels_refuse_other_head_dims(card, D):
    """A head dim outside {16, 32, 64, 112, 128} raises ValueError in
    every wrapper before any launch."""
    f = lambda *s: torch.zeros(s, device="cuda", dtype=torch.bfloat16)
    i32 = lambda *s: torch.zeros(s, device="cuda", dtype=torch.int32)
    q1, kv = f(2, 1, 4, D), f(2, 16, 2, D)
    pool, bt, ln = f(4, 8, 2, D), i32(2, 2), i32(2)
    ops.reset_launches()
    for call in (lambda: flash_attention(f(1, 8, 4, D), f(1, 8, 2, D),
                                         f(1, 8, 2, D)),
                 lambda: flash_decode(q1, kv, kv, ln),
                 lambda: paged_decode(q1, pool, pool, bt, ln),
                 lambda: paged_prefill(f(2, 3, 4, D), pool, pool, bt, ln,
                                       i32(2))):
        with pytest.raises(ValueError, match="head dim"):
            call()
    assert sum(ops.kernel_launches().values()) == 0


# ------------------------------------------------------------ decode
# KV heads of the served decode shapes, by GQA group: moonshot-v1-16b-a3b
# (1), phi3.5-moe (4), qwen2-1.5b (6), tinyllama-1.1b (8); each at head
# dims 64 and 128. Other groups take one KV head.
DECODE_HEADS = {1: 16, 4: 8, 6: 2, 8: 4}
DECODE_S, DECODE_BS = 1024, 16


def _decode_lengths(Hkv, group):
    """Per-slot lengths that hit the bf16 kernel's edges: idle, one key,
    either side of the first 16-key share step and of one full 64-key
    tile per block of the cluster, the whole cache, and past it."""
    c, _ = _build.decode_plan(8, Hkv, group)
    return [0, 1, 16 * c - 1, 16 * c + 1, 64 * c - 1, 64 * c + 1,
            DECODE_S, DECODE_S + 300]


def _decode_case(seed, group, D, dtype, paged):
    """q and either a contiguous cache or pools with scrambled tables whose
    entries past each allocation are garbage (some negative, some past
    the pool)."""
    Hkv = DECODE_HEADS.get(group, 1)
    lens = _decode_lengths(Hkv, group)
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    q = f(len(lens), 1, group * Hkv, D)
    if not paged:
        return q, f(len(lens), DECODE_S, Hkv, D), \
            f(len(lens), DECODE_S, Hkv, D), i32(lens)
    MB = DECODE_S // DECODE_BS
    NB = len(lens) * MB
    perm = list(rng.permutation(NB))
    bt = rng.integers(-5, 3 * NB, (len(lens), MB)).astype(np.int32)
    for b, L in enumerate(lens):
        n = -(-min(L, DECODE_S) // DECODE_BS)
        bt[b, :n] = [perm.pop() for _ in range(n)]
    return (q, f(NB, DECODE_BS, Hkv, D), f(NB, DECODE_BS, Hkv, D), i32(bt),
            i32(lens))


def _check_decode(args, paged):
    fn, ref_fn = ((paged_decode, paged_decode_ref) if paged
                  else (flash_decode, decode_ref))
    name = fn.__name__
    ops.reset_launches()
    got = fn(*args)
    want = ref_fn(*args)
    torch.cuda.synchronize()
    q = args[0]
    assert ops.kernel_launches()[name] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[q.dtype], err
    assert (got[0] == 0).all()              # idle slot: exact zeros
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 6, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_match_plain_versions(card, dtype, group, D, paged):
    _check_decode(_decode_case(group * D + paged, group, D, dtype, paged),
                  paged)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("group,D", [(2, 16), (24, 32), (128, 64)])
def test_decode_kernels_at_other_groups_and_head_dims(card, group, D,
                                                      paged):
    """Small head dims, and groups above 16 heads, which take more than
    one 16-row slice of the grid (the last one partly used); one KV
    head."""
    _check_decode(_decode_case(group + D, group, D, torch.bfloat16, paged),
                  paged)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_at_head_dim_112(card, dtype, group, paged):
    """D 112 at the split's edges, groups 1 (zamba2's) and 4: in bf16
    both on the tensor cores (7 k-steps, 14 n8 output tiles)."""
    _check_decode(_decode_case(group + 112 + paged, group, 112, dtype,
                               paged), paged)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_decode_kernels_at_zamba2_shape(card, paged):
    """8 slots of 100-384 keys, 32/32 heads of 112, bf16."""
    rng = np.random.default_rng(112)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", torch.bfloat16)
    lens = [int(x) for x in rng.integers(100, 385, 8)]
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    q = f(8, 1, 32, 112)
    if paged:
        MB = DECODE_S // DECODE_BS
        bt = np.arange(8 * MB, dtype=np.int32).reshape(8, MB)[:, ::-1]
        args = (q, f(8 * MB, DECODE_BS, 32, 112), f(8 * MB, DECODE_BS, 32,
                                                     112),
                i32(bt.copy()), i32(lens))
        fn, ref_fn = paged_decode, paged_decode_ref
    else:
        args = (q, f(8, DECODE_S, 32, 112), f(8, DECODE_S, 32, 112),
                i32(lens))
        fn, ref_fn = flash_decode, decode_ref
    ops.reset_launches()
    got, want = fn(*args), ref_fn(*args)
    torch.cuda.synchronize()
    assert ops.kernel_launches()[fn.__name__] == 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_decode_kernels_replay_in_a_cuda_graph(card, paged):
    """A captured launch replays with new lengths: the shares follow the
    device's lengths, with nothing kept between launches."""
    args = _decode_case(3, 8, 64, torch.bfloat16, paged)
    fn, ref_fn = ((paged_decode, paged_decode_ref) if paged
                  else (flash_decode, decode_ref))
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn(*args)
    lengths = args[-1]
    for lens in ([5, 0, 300, 17, 1024, 64, 65, 2],
                 [0, 0, 0, 0, 0, 0, 0, 1]):
        lengths.copy_(torch.as_tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        err = (got.float() - ref_fn(*args).float()).abs().max().item()
        assert err <= ATTN_TOL[torch.bfloat16], err


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype,library", [(torch.bfloat16, "decode_tc"),
                                           (torch.float32, "attention")])
def test_decode_routes_by_dtype(card, monkeypatch, dtype, library, paged):
    """bf16 launches the tensor-core kernel of decode_tc.cu, float32 the
    CUDA-core kernel of attention.cu; either counts one launch, the plain
    version none."""
    asked = []
    real_lib = _build.lib

    def spy(name):
        asked.append(name)
        return real_lib(name)

    monkeypatch.setattr(_build, "lib", spy)
    args = _decode_case(1, 8, 64, dtype, paged)
    q, k, v, *rest = args
    lengths, tables = rest[-1], (rest[0] if paged else None)
    ops.reset_launches()
    ops.attention(q, k, v, lengths=lengths, block_tables=tables)
    ops.attention(q, k, v, lengths=lengths, block_tables=tables,
                  impl="paged_ref" if paged else "decode_ref")
    torch.cuda.synchronize()
    assert asked == [library]
    counts = ops.kernel_launches()
    assert counts["paged_decode" if paged else "flash_decode"] == 1
    assert sum(counts.values()) == 1


@pytest.mark.cuda
def test_decode_tc_build_failure_raises(card, tmp_path, monkeypatch):
    """A source that does not compile raises from the first launch; there
    is no fallback to the plain version or the CUDA-core kernel."""
    bad = tmp_path / "decode_tc.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "SOURCES", dict(_build.SOURCES,
                                                decode_tc=bad))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    q, k, v, lengths = _decode_case(0, 8, 64, torch.bfloat16, False)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flash_decode(q, k, v, lengths)
    assert ops.kernel_launches()["flash_decode"] == 0


# ------------------------------------------------------------ prefill
# KV heads of the served chunk shapes, by GQA group: moonshot-v1-16b-a3b
# (1), phi3.5-moe (4), tinyllama-1.1b (8). Other groups take two.
PREFILL_HEADS = {1: 16, 4: 8, 8: 4}
PREFILL_OFFSETS = (0, 37, 128, 300, 0)


def _prefill_case(seed, group, D, dtype, Sq):
    """q, pools, garbage-tailed scrambled tables, lengths and offsets of
    five sequences: from 0, at a mid-block offset, at a block-aligned one,
    with a padded tail of Sq // 3 + 1 rows, and of length 0."""
    Hkv = PREFILL_HEADS.get(group, 2)
    offs = list(PREFILL_OFFSETS)
    lens = [o + Sq for o in offs]
    lens[3] -= Sq // 3 + 1
    lens[4] = 0
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    B = len(offs)
    MB = DECODE_S // DECODE_BS
    NB = B * MB
    perm = list(rng.permutation(NB))
    bt = rng.integers(-5, 3 * NB, (B, MB)).astype(np.int32)
    for b, L in enumerate(lens):
        n = -(-max(L, 0) // DECODE_BS)
        bt[b, :n] = [perm.pop() for _ in range(n)]
    return (f(B, Sq, group * Hkv, D), f(NB, DECODE_BS, Hkv, D),
            f(NB, DECODE_BS, Hkv, D), i32(bt), i32(lens), i32(offs))


def _check_prefill(args):
    ops.reset_launches()
    got = paged_prefill(*args)
    want = paged_prefill_ref(*args)
    torch.cuda.synchronize()
    q = args[0]
    assert ops.kernel_launches()["paged_prefill"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[q.dtype], err
    assert (got[4] == 0).all()              # length 0: exact zeros
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 24, 50, 64, 200])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_prefill_kernels_match_plain_version(card, dtype, group, D,
                                                   Sq):
    _check_prefill(_prefill_case(group * D + Sq, group, D, dtype, Sq))


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 24, 64, 200])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_prefill_kernels_at_head_dim_112(card, dtype, group, Sq):
    """D 112 (no served arch reaches chunked prefill there, the hybrid
    family refusing it, but the dispatch is shared): every sequence
    shape of ``_prefill_case``."""
    _check_prefill(_prefill_case(group * 112 + Sq, group, 112, dtype, Sq))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("group,D,Sq", [(8, 64, 64), (1, 128, 64),
                                        (1, 112, 64), (4, 16, 50),
                                        (2, 32, 200)])
def test_paged_prefill_at_every_cluster_size(card, monkeypatch, cluster,
                                             group, D, Sq):
    """The bf16 kernel's key split over clusters of 1 to 8 blocks (shares
    that are empty, partial and full), at small head dims too."""
    plan = _build.prefill_plan
    monkeypatch.setattr(_build, "prefill_plan", lambda *a: (
        cluster, plan(*a)[1]))
    _check_prefill(_prefill_case(cluster + D, group, D, torch.bfloat16, Sq))


@pytest.mark.cuda
def test_paged_prefill_replays_in_a_cuda_graph(card):
    """A captured launch replays with new offsets and lengths: the blocks
    read them on the device, with nothing kept between launches."""
    args = _prefill_case(5, 8, 64, torch.bfloat16, 64)
    paged_prefill(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = paged_prefill(*args)
    lengths, offsets = args[-2], args[-1]
    for offs, lens in (([64, 0, 500, 17, 3], [128, 10, 564, 70, 0]),
                       ([0, 0, 0, 0, 0], [0, 0, 0, 0, 0])):
        offsets.copy_(torch.as_tensor(offs, dtype=torch.int32))
        lengths.copy_(torch.as_tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        err = (got.float() - paged_prefill_ref(*args).float()).abs().max()
        assert err.item() <= ATTN_TOL[torch.bfloat16], err
    assert (got == 0).all()                 # every length 0: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,library", [(torch.bfloat16, "attention_tc"),
                                           (torch.float32, "attention")])
def test_paged_prefill_routes_by_dtype(card, monkeypatch, dtype, library):
    """bf16 launches the tensor-core kernel of attention_tc.cu, float32 the
    CUDA-core kernel of attention.cu; either counts one launch, the plain
    version none."""
    asked = []
    real_lib = _build.lib

    def spy(name):
        asked.append(name)
        return real_lib(name)

    monkeypatch.setattr(_build, "lib", spy)
    q, kp, vp, bt, lengths, offsets = _prefill_case(2, 8, 64, dtype, 24)
    ops.reset_launches()
    ops.attention(q, kp, vp, lengths=lengths, block_tables=bt,
                  q_offset=offsets)
    ops.attention(q, kp, vp, lengths=lengths, block_tables=bt,
                  q_offset=offsets, impl="paged_ref")
    torch.cuda.synchronize()
    assert asked == [library]
    counts = ops.kernel_launches()
    assert counts["paged_prefill"] == 1
    assert sum(counts.values()) == 1


@pytest.mark.cuda
def test_attention_tc_build_failure_raises(card, tmp_path, monkeypatch):
    """A source that does not compile raises from the first launch; there
    is no fallback to the plain version or the CUDA-core kernel."""
    bad = tmp_path / "attention_tc.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "SOURCES", dict(_build.SOURCES,
                                                attention_tc=bad))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    args = _prefill_case(0, 8, 64, torch.bfloat16, 24)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        paged_prefill(*args)
    assert ops.kernel_launches()["paged_prefill"] == 0


# ------------------------------------------------------- live migration
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_block_round_trip_is_bit_exact(card, dtype):
    """Blocks gathered from one pool on the card, copied to host memory
    and back, and scattered into other blocks of a second pool, arrive
    bit for bit; every other block of the second pool, the sink block
    (index num_blocks) included, is untouched."""
    from repro_torch.serve.engine import gather_kv, scatter_kv

    L, NB, bs, H, D = 22, 64, 16, 4, 64          # tinyllama-1.1b's pool
    g = torch.Generator(device="cuda").manual_seed(0)
    pool = lambda: torch.randn(L, NB + 1, bs, H, D, generator=g,
                               device="cuda").to(dtype)
    src, dst = (pool(), pool()), (pool(), pool())
    keep = tuple(d.clone() for d in dst)
    ids = torch.tensor([5, 0, 63, 17, 2], device="cuda")
    to = torch.tensor([9, 40, 1, 63, 33], device="cuda")
    host = tuple(b.cpu() for b in gather_kv(*src, ids))
    assert all(b.device.type == "cpu" and b.dtype == dtype for b in host)
    scatter_kv(*dst, to, *(b.to("cuda") for b in host))
    torch.cuda.synchronize()
    rest = torch.ones(NB + 1, dtype=torch.bool, device="cuda")
    rest[to] = False
    for s, d, k in zip(src, dst, keep):
        assert torch.equal(d[:, to], s[:, ids])
        assert torch.equal(d[:, rest], k[:, rest])
        assert torch.equal(d[:, NB], k[:, NB])


@pytest.mark.cuda
def test_migrating_fabric_on_the_card(card):
    """Two paged replicas of tinyllama-1.1b.smoke() on the card: a
    saturated replica 0 sheds a live sequence, replica 1's next step
    decodes it through paged_decode, the fabric terminates, and the
    tokens are those of one engine that kept everything."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, GLBReplicaBalancer, Request

    cfg = ARCHS["tinyllama-1.1b"].smoke()
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    kw = dict(max_slots=2, max_seq=64, pad_len=16, steps_per_sync=4,
              paged=True, block_size=8)
    mk = lambda: [Request(rid=i, prompt=[3, i + 1, 4, 7, 2], max_new=20)
                  for i in range(2)]
    engines = [Engine(cfg, params, replica_id=i, device="cuda", **kw)
               for i in range(2)]
    bal = GLBReplicaBalancer(engines, migrate=True)
    reqs = mk()
    for r in reqs:
        bal.submit(r, rr=0)
    engines[0].step()
    assert not bal.balance()
    assert bal.migration_modes["live"] == 1 and engines[1].load == 1
    ops.reset_launches()
    engines[1].step()
    torch.cuda.synchronize()
    assert ops.kernel_launches()["paged_decode"] > 0
    assert bal.run(max_steps=200) == "terminated"
    assert all(r.done for r in reqs)
    alone = Engine(cfg, params, device="cuda", **kw)
    ref = mk()
    for r in ref:
        alone.submit(r)
    while alone.load:
        alone.step()
    assert [r.out for r in reqs] == [r.out for r in ref]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_engine_on_the_card(card, paged):
    """zamba2-7b.smoke() at 4 layers (two applications of the shared
    block) served on the card: ssd_chunked, flash_attention and the
    mode's decode kernel launch, every request finishes, and the tokens
    equal those of the plain path (the plain versions on the card)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, Request

    base = dataclasses.replace(ARCHS["zamba2-7b"].smoke(), n_layers=4)
    params = init_lm(base, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    kw = dict(max_slots=2, max_seq=64, pad_len=16, steps_per_sync=4)
    if paged:
        kw.update(paged=True, block_size=8)
    outs = []
    for impl in ("auto", "ref"):
        cfg = dataclasses.replace(base, attn_impl=impl, decode_impl=impl)
        reqs = [Request(rid=i, prompt=[3, i + 1, 4, 7, 2, 9][: 3 + i],
                        max_new=10 + 3 * i) for i in range(3)]
        eng = Engine(cfg, params, device="cuda", **kw)
        ops.reset_launches()
        for r in reqs:
            eng.submit(r)
        while eng.load:
            eng.step()
        torch.cuda.synchronize()
        counts = ops.kernel_launches()
        assert all(r.done for r in reqs)
        if impl == "auto":
            decode = "paged_decode" if paged else "flash_decode"
            for name in ("ssd_chunked", "flash_attention", decode):
                assert counts[name] > 0, (name, counts)
        else:
            assert sum(counts.values()) == 0
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


# ------------------------------------------------- training: autograd
# Each kernel's gradient goes through its plain version, recomputed from
# the saved inputs (``kernels/autograd.py``), so for one call the kernel
# route's input gradients equal the plain route's exactly (the same
# backward on the same inputs and output gradient); the forward outputs
# differ within the limits above.
def _grad_routes(fn, plain, args, outs_used=(0,)):
    """(kernel-route outputs, gradients; plain-route outputs, gradients)
    of sum(out * w) over the used outputs, one launch counted."""
    res = []
    for route, f in (("kernel", fn), ("plain", plain)):
        leaves = [a.detach().requires_grad_(a.is_floating_point())
                  if torch.is_tensor(a) else a for a in args]
        ops.reset_launches()
        outs = f(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.cuda.synchronize()
        launched = sum(ops.kernel_launches().values())
        assert launched == (1 if route == "kernel" else 0)
        assert all(o.grad_fn is not None for o in outs)
        gen = torch.Generator(device="cuda").manual_seed(1)
        loss = sum((outs[i].float() * torch.randn(
            outs[i].shape, device="cuda", generator=gen)).sum()
            for i in outs_used)
        wrt = [a for a in leaves if torch.is_tensor(a) and a.requires_grad]
        grads = torch.autograd.grad(loss, wrt)
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
        res.append((outs, grads))
    return res


def _same_grads(res):
    (_, got), (_, want) = res
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (8, 512, 32, 4, 64),            # tinyllama-1.1b, batch 8 x seq 512
    (2, 128, 12, 4, 64),            # the 100m preset
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_gradient_through_the_kernel(card, dtype, B, S, Hq,
                                                     Hkv, D):
    q, k, v = _attn_inputs(S + D, B, S, S, Hq, Hkv, D, dtype)
    res = _grad_routes(
        lambda *a: flash_attention(*a, causal=True),
        lambda *a: attention_ref(*a, causal=True), (q, k, v))
    err = (res[0][0][0].float() - res[1][0][0].float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], err
    _same_grads(res)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,T,D,F", [
    ([320, 256, 0, 300, 200, 280, 312, 250], 2560, 768, 2048),  # 100m preset
    ([0, 5, 0, 40, 17, 0, 3], 80, 72, 100),  # empty groups, rows past them
])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_gmm_gradient_through_the_kernel(card, sizes, T, D, F, dtype, rel):
    x, w, gs = _gmm_inputs(T + F, sizes, T, D, F, dtype)
    res = _grad_routes(gmm, gmm_ref, (x, w, gs))
    assert _close(res[0][0][0], res[1][0][0], rel)
    _same_grads(res)
    dx = res[0][1][0]
    assert (dx[min(sum(sizes), T):] == 0).all()     # rows past the groups


@pytest.mark.cuda
@pytest.mark.parametrize("used", [(0,), (0, 1)])
@pytest.mark.parametrize("dtype,rel", SSD_RELS)
def test_ssd_chunked_gradient_through_the_kernel(card, dtype, rel, used):
    """mamba2-130m's training shape (8 x 512 tokens, 24 heads of 64, N
    128); with h unused its gradient counts as zeros."""
    x, dt, A, B, C = _inputs(5, 8, 512, 24, 64, 128)
    args = (x.to(dtype), dt, A, B, C)
    res = _grad_routes(lambda *a: ssd_chunked(*a, chunk=64),
                       lambda *a: ssd_chunked_ref(*a, chunk=64), args, used)
    assert _close(res[0][0][0], res[1][0][0], rel)
    assert _close(res[0][0][1], res[1][0][1], 0.0)
    _same_grads(res)


@pytest.mark.cuda
def test_inference_mode_takes_no_autograd_route(card):
    """Serving runs under torch.inference_mode(): inputs that require grad
    still launch the kernel once, directly, with the output of a call
    made without grad, and no grad_fn."""
    q, k, v = _attn_inputs(3, 1, 64, 64, 8, 2, 64, torch.bfloat16)
    x, w, gs = _gmm_inputs(4, [3, 5], 8, 64, 32, torch.bfloat16)
    s = _inputs(6, 1, 64, 4, 16, 16)
    calls = {"flash_attention": (lambda *a: flash_attention(*a),
                                 (q, k, v)),
             "gmm": (gmm, (x, w, gs)),
             "ssd_chunked": (lambda *a: ssd_chunked(*a, chunk=64), s)}
    for name, (fn, args) in calls.items():
        want = fn(*args)
        leaves = [a.detach().requires_grad_(a.is_floating_point())
                  for a in args]
        ops.reset_launches()
        with torch.inference_mode():
            got = fn(*leaves)
        torch.cuda.synchronize()
        assert ops.kernel_launches()[name] == 1
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            assert g.grad_fn is None
            assert torch.equal(g, w_)


@pytest.mark.cuda
def test_engine_with_float32_masters_that_require_grad_serves_as_before(
        card):
    """The engine serves from parameters that require grad (training's
    float32 masters) exactly as from detached copies: the same tokens and
    the same launch counts, none through the autograd route."""
    from repro_torch.configs import ARCHS
    from repro_torch.serve import Engine, Request
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import init_train_state

    cfg = ARCHS["tinyllama-1.1b"].smoke()
    params, _ = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    detached = tree_map(lambda t: t.detach().clone(), params)
    tree_map(lambda t: t.requires_grad_(True), params)
    outs, counts = [], []
    for p in (params, detached):
        reqs = [Request(rid=i, prompt=[3, i + 1, 4, 7, 2, 9][: 3 + i],
                        max_new=8 + 2 * i) for i in range(3)]
        eng = Engine(cfg, p, device="cuda", max_slots=2, max_seq=64,
                     pad_len=16, steps_per_sync=4)
        ops.reset_launches()
        for r in reqs:
            eng.submit(r)
        while eng.load:
            eng.step()
        torch.cuda.synchronize()
        outs.append([r.out for r in reqs])
        counts.append(ops.kernel_launches())
    assert outs[0] == outs[1]
    assert counts[0] == counts[1]
    assert counts[0]["flash_attention"] > 0 and counts[0]["flash_decode"] > 0
