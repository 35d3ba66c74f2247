"""Dispatch layer: the attention, SSD and grouped-matmul (MoE expert
compute) entry points the models call, and the UTS node expansion the
task executor's UTS problem calls.

The routing rules and error checks are those of ``repro.kernels.ops``
(``attention``, ``ssd``, ``gmm``, ``expand_uts``). With ``impl="auto"`` a
CUDA tensor goes to the hand-written kernel and a CPU tensor to its plain
version (each kernel wrapper makes that choice from the tensor's device);
the ``*_ref`` impls (and ``ssd``'s ``ref`` / ``chunked``, ``gmm``'s and
``expand_uts``'s ``ref``) force a plain version, which is the yardstick
the kernels are held to. ``attention``'s ``chunked`` is the reference's
memory-bounded plain path (``attention_chunked``), plain on every
device; with ``lengths`` or ``block_tables`` it is the plain decode or
paged version, as JAX normalises it. Every TPU kernel of the JAX package
has its kernel here: the four attention kernels, ``ssd_chunked``, ``gmm``
and ``uts_expand``.

DTensors (the models under ``dist.sharding``'s rules). ``attention``
and ``ssd`` run their function on each rank's local shards
(``dist.sharding.local_call``), where that is embarrassingly parallel:
attention over the batch and the heads (each rank with the kv heads its
q heads read), the SSD scan over the batch and its heads. A mesh dim
that splits anything else (the sequence), or splits unevenly, is
gathered first. So on a CUDA mesh the kernel runs on
local heads; on a CPU mesh the plain version runs on them, as it runs on
a CPU tensor. ``decode_sharded`` is the decode against a
sequence-sharded cache: the masked full-cache softmax, each rank over its
own slice of the cache, combined by an all-reduce of the maxima, then of
the sums (JAX's decode cells take the masked plain path too). A ``meta``
tensor takes the plain version wherever ``impl`` is ``auto`` (a kernel
wrapper refuses one): that is what the dry run traces.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import like, local_call

from .flash_attention import attention_chunked, attention_ref, flash_attention
from .flash_decode import decode_ref, flash_decode
from .mamba2_ssd import ssd_chunked, ssd_chunked_ref, ssd_ref
from .mla_decode import mla_paged_decode, mla_paged_decode_ref
from .moe_gmm import gmm as gmm_kernel
from .moe_gmm import gmm_ref
from .paged_decode import (paged_decode, paged_decode_ref, paged_prefill,
                           paged_prefill_ref)
from .uts_expand import uts_expand, uts_expand_ref

IMPLS = ("auto", "ref", "chunked", "decode", "decode_ref", "paged",
         "paged_ref")
CHUNKED_BLOCK_Q = 512       # repro/kernels/ops.py:117's block_q
SSD_IMPLS = ("auto", "ref", "chunked")
GMM_IMPLS = ("auto", "ref")
UTS_IMPLS = ("auto", "ref")
KERNELS = (flash_attention, flash_decode, paged_decode, paged_prefill,
           ssd_chunked, gmm_kernel, uts_expand, mla_paged_decode)


def kernel_launches() -> Dict[str, int]:
    """Launch count of each kernel wrapper, by name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def attention(q, k, v, *, causal=True, scale=None, impl: str = "auto",
              lengths=None, block_tables=None, q_offset=None):
    """impl: auto | ref | chunked | decode | decode_ref | paged | paged_ref

    ``lengths`` ((B,) i32 visible-window sizes against a padded KV cache)
    plus Sq == 1 selects the decode path. ``block_tables`` ((B,
    max_blocks) i32) marks k/v as flat (num_blocks, block_size, Hkv, D)
    pools indirected through the table: Sq == 1 is paged decode, and with
    ``q_offset`` ((B,) i32) a chunked prefill of Sq rows starting there.
    Every impl spelling is normalized so one config knob drives all paths:
    the window mask and table walk are never dropped."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")
    if q_offset is not None and block_tables is None:
        raise ValueError(
            "q_offset is a paged chunked-prefill parameter and requires "
            "block_tables; the contiguous paths would silently ignore "
            "the offset and compute wrong attention"
        )
    if lengths is not None and q.shape[1] != 1 and block_tables is None:
        raise ValueError(
            f"lengths is only supported for Sq == 1 decode, got Sq="
            f"{q.shape[1]}; dropping the window mask would silently "
            "attend to dead cache rows"
        )
    if isinstance(q, DTensor):
        if block_tables is not None:
            raise NotImplementedError(
                "paged attention on DTensors: the paged engine is not "
                "sharded (nor is the reference's)")
        if lengths is not None:
            return decode_sharded(q, k, v, lengths, scale=scale)
        return _head_parallel(
            lambda q, k, v: attention(q, k, v, causal=causal, scale=scale,
                                      impl=impl), q, k, v)
    ref = impl.endswith("ref") or impl == "chunked" or _meta(q)
    if block_tables is not None:
        if lengths is None:
            raise ValueError("block_tables requires lengths")
        if q_offset is not None or q.shape[1] != 1:
            if q_offset is None:
                raise ValueError(
                    "paged attention with Sq > 1 is chunked prefill and "
                    "requires q_offset (the chunk's start position)"
                )
            fn = paged_prefill_ref if ref else paged_prefill
            return fn(q, k, v, block_tables, lengths, q_offset, scale=scale)
        fn = paged_decode_ref if ref else paged_decode
        return fn(q, k, v, block_tables, lengths, scale=scale)
    if impl.startswith("paged"):
        raise ValueError(f"impl {impl!r} needs block_tables")
    if lengths is not None:
        fn = decode_ref if ref else flash_decode
        return fn(q, k, v, lengths, scale=scale)
    if impl.startswith("decode"):
        raise ValueError(f"impl {impl!r} needs Sq == 1 and lengths")
    if impl == "chunked":
        return attention_chunked(q, k, v, causal=causal, scale=scale,
                                 block_q=CHUNKED_BLOCK_Q)
    fn = attention_ref if ref else flash_attention
    return fn(q, k, v, causal=causal, scale=scale)


def latent_attention(q, pool, block_tables, lengths, *, v_dim: int,
                     scale: float, impl: str = "auto"):
    """MLA decode, the absorbed form: q (B, H, Dk) against the paged pool
    of latent rows (NB, Bs, Dk), values the rows' first ``v_dim``
    columns. ``impl`` is the model's ``decode_impl`` (one of ``IMPLS``):
    ``auto`` and the kernel spellings run ``mla_paged_decode`` (the
    kernel for a CUDA tensor, its plain version for a CPU one), every
    ``*ref`` or ``chunked`` spelling ``mla_paged_decode_ref``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")
    ref = impl.endswith("ref") or impl == "chunked" or _meta(q)
    fn = mla_paged_decode_ref if ref else mla_paged_decode
    return fn(q, pool, block_tables, lengths, v_dim=v_dim, scale=scale)


def ssd(x, dt, A, B, C, *, chunk: int = 64, impl: str = "auto"):
    """impl: auto | ref | chunked. ``auto`` runs ``ssd_chunked`` (the
    kernel for a CUDA tensor, its plain version for a CPU one); ``ref``
    forces the sequential ``ssd_ref``; ``chunked`` forces
    ``ssd_chunked_ref`` at chunk ``max(chunk, 128)``, as JAX's does."""
    if impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {impl!r}; have {SSD_IMPLS}")
    if isinstance(x, DTensor):
        return _ssd_parallel(
            lambda *a: ssd(*a, chunk=chunk, impl=impl), x, dt, A, B, C)
    if impl == "ref" or (impl == "auto" and _meta(x)):
        return ssd_ref(x, dt, A, B, C)
    if impl == "chunked":
        return ssd_chunked_ref(x, dt, A, B, C, chunk=max(chunk, 128))
    return ssd_chunked(x, dt, A, B, C, chunk=chunk)


def gmm(x, w, group_sizes, *, impl: str = "auto"):
    """Grouped matmul for MoE expert compute. impl: auto | ref. ``auto``
    runs the ``gmm`` kernel wrapper (the kernel for a CUDA tensor, its
    plain version for a CPU one); ``ref`` forces ``gmm_ref``."""
    if impl not in GMM_IMPLS:
        raise ValueError(f"unknown gmm impl {impl!r}; have {GMM_IMPLS}")
    if impl == "ref" or _meta(x):
        return gmm_ref(x, w, group_sizes)
    return gmm_kernel(x, w, group_sizes)


def expand_uts(d0, d1, base, thresholds, *, width: int = 64,
               impl: str = "auto"):
    """impl: auto | ref. ``auto`` runs ``uts_expand`` (the kernel for a
    CUDA tensor, its plain version for a CPU one); ``ref`` forces
    ``uts_expand_ref``."""
    if impl not in UTS_IMPLS:
        raise ValueError(f"unknown uts impl {impl!r}; have {UTS_IMPLS}")
    if impl == "ref":
        return uts_expand_ref(d0, d1, base, thresholds, width)
    return uts_expand(d0, d1, base, thresholds, width=width)


# ------------------------------------------------------------- DTensors
def _meta(t) -> bool:
    return t.device.type == "meta"


def _on(pl, dims) -> bool:
    return isinstance(pl, Shard) and pl.dim in dims


def _head_parallel(fn, q, k, v):
    """``fn(q, k, v)`` of (B, S, H, D) tensors on each rank's batch rows
    and heads. A mesh dim keeps its split where q, k and v are all split
    there on the batch, or all on the heads, or q on its heads while k
    and v are whole there (each rank then takes the kv heads its q heads
    read: GSPMD's layout when the kv heads do not divide); the others are
    gathered. The output has q's placements."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    pq, pkv = [], []
    for md in range(mesh.ndim):
        dq, dk, dv = (t.placements[md].dim if isinstance(
            t.placements[md], Shard) else None for t in (q, k, v))
        if dq == dk == dv and dq in (0, 2):
            pq.append(q.placements[md])
            pkv.append(q.placements[md])
        elif dq == 2 and dk == dv is None:
            pq.append(q.placements[md])
            pkv.append(Replicate())
        else:
            pq.append(Replicate())
            pkv.append(Replicate())
    for md in range(mesh.ndim):
        if not (_even(q.shape, pq, mesh, md) and _even(k.shape, pkv, mesh,
                                                       md)):
            pq[md] = pkv[md] = Replicate()
    q = q.redistribute(mesh, pq)
    k, v = (t.redistribute(mesh, pkv) for t in (k, v))
    hq0, hk0 = shard_offset(q, 2), shard_offset(k, 2)
    nq = Hq // _splits(q, 2)
    lo, hi = hq0 * Hkv // Hq, ((hq0 + nq - 1) * Hkv // Hq) + 1
    if nq % (hi - lo):
        raise ValueError(f"attention: {nq} local q heads of {Hq} do not "
                         f"split over the {hi - lo} kv heads they read")

    def local(q, k, v):
        return fn(q, k[:, :, lo - hk0:hi - hk0], v[:, :, lo - hk0:hi - hk0])

    return local_call(local, tuple(pq), q, k, v)


def _even(shape, pls, mesh, md: int) -> bool:
    """Whether mesh dim ``md``'s split under placements ``pls`` leaves
    even shards (DTensor's propagation can leave uneven ones, which a
    local call would mistake for even)."""
    p = pls[md]
    if not isinstance(p, Shard):
        return True
    n = 1
    for m in range(md + 1):
        if _on(pls[m], (p.dim,)):
            n *= mesh.size(m)
    return shape[p.dim] % n == 0


def _splits(t, dim: int) -> int:
    """Into how many shards the mesh splits ``t``'s dim ``dim``."""
    n = 1
    for md, p in enumerate(t.placements):
        if _on(p, (dim,)):
            n *= t.device_mesh.size(md)
    return n


def _ssd_parallel(fn, x, dt, A, B, C):
    """``fn(x, dt, A, B, C)`` on each rank's batch rows and heads: x
    (Bt, T, H, P) keeps its batch and head splits, dt (Bt, T, H) and A
    (H,) follow them, B and C (Bt, T, N) follow the batch only. Returns
    (y like x, h (Bt, H, N, P))."""
    mesh = x.device_mesh
    px, pdt, pA, pB, ph = [], [], [], [], []
    for md in range(mesh.ndim):
        p = x.placements[md]
        if not _even(x.shape, x.placements, mesh, md):
            row = (Replicate(),) * 5
        elif _on(p, (0,)):
            row = (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0))
        elif _on(p, (2,)):
            row = (Shard(2), Shard(2), Shard(0), Replicate(), Shard(1))
        else:
            row = (Replicate(),) * 5
        for lst, pl in zip((px, pdt, pA, pB, ph), row):
            lst.append(pl)
    x = x.redistribute(mesh, px)
    dt = dt.redistribute(mesh, pdt)
    A = A.redistribute(mesh, pA)
    B = B.redistribute(mesh, pB)
    C = C.redistribute(mesh, pB)
    return local_call(fn, (tuple(px), tuple(ph)), x, dt, A, B, C)


def shard_offset(t: DTensor, dim: int) -> int:
    """Where this rank's shard of ``t`` starts along ``dim``."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    off, n = 0, t.shape[dim]
    for md, p in enumerate(t.placements):
        if _on(p, (dim,)):
            n //= mesh.size(md)
            off += coord[md] * n
    return off


def decode_sharded(q, k, v, lengths, scale=None):
    """One query token a row, q (B, 1, Hq, D), against a k/v cache (B, S,
    Hkv, D) whose sequence may be split over mesh dims: the masked
    full-cache softmax of ``decode_ref`` (rows past ``lengths`` hidden,
    an empty window giving zeros), each rank over its own rows and the
    slices combined by all-reduces (the maxima, then the sums and the
    weighted values). The batch and the kv heads keep the cache's splits;
    q follows them."""
    mesh = k.device_mesh
    B, S, Hkv, hd = k.shape
    Hq = q.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    # per mesh dim: q's placement, the lengths', and that of the (B, Hkv,
    # g, .) statistics, None where the mesh dim splits the sequence (the
    # statistics are partial there)
    pq, pl, st = [], [], []
    for p in k.placements:
        pq.append(p if _on(p, (0, 2)) else Replicate())
        pl.append(p if _on(p, (0,)) else Replicate())
        st.append(None if _on(p, (1,)) else Shard(1) if _on(p, (2,))
                  else p)
    q = q.redistribute(mesh, pq)
    lengths = like(k, lengths).redistribute(mesh, pl)
    off = shard_offset(k, 1)

    def scores(q, k, lens):
        Bl, Sl, Hk = k.shape[0], k.shape[1], k.shape[2]
        qf = q.float().reshape(Bl, Hk, g, hd)
        s = torch.einsum("bgqd,bsgd->bgqs", qf, k.float()) * scale
        pos = off + torch.arange(Sl, device=k.device)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]
        return s.masked_fill(~mask, float("-inf")), mask

    def local_max(q, k, lens):
        s, _ = scores(q, k, lens)
        return s.amax(-1, keepdim=True)                # (B, Hkv, g, 1)

    def stat(kind):
        return tuple(Partial(kind) if p is None else p for p in st)

    done = [Replicate() if p is None else p for p in st]
    m = local_call(local_max, stat("max"), q, k, lengths)
    m = m.redistribute(mesh, done)

    def weighted(q, k, v, lens, m):
        s, mask = scores(q, k, lens)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        o = torch.einsum("bgqs,bsgd->bgqd", p, v.float())
        return o, p.sum(-1, keepdim=True)

    o, l = local_call(weighted, (stat("sum"), stat("sum")), q, k, v,
                      lengths, m)
    o, l = o.redistribute(mesh, done), l.redistribute(mesh, done)
    return local_call(
        lambda o, l: torch.where(l > 0, o / l, 0.0).reshape(
            o.shape[0], 1, o.shape[1] * g, hd).to(q.dtype),
        tuple(Shard(2) if _on(p, (1,)) else p for p in done), o, l)
