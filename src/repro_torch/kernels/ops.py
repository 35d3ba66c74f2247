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
"""
from __future__ import annotations

from typing import Dict

from .flash_attention import attention_chunked, attention_ref, flash_attention
from .flash_decode import decode_ref, flash_decode
from .mamba2_ssd import ssd_chunked, ssd_chunked_ref, ssd_ref
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
           ssd_chunked, gmm_kernel, uts_expand)


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
    ref = impl.endswith("ref") or impl == "chunked"
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


def ssd(x, dt, A, B, C, *, chunk: int = 64, impl: str = "auto"):
    """impl: auto | ref | chunked. ``auto`` runs ``ssd_chunked`` (the
    kernel for a CUDA tensor, its plain version for a CPU one); ``ref``
    forces the sequential ``ssd_ref``; ``chunked`` forces
    ``ssd_chunked_ref`` at chunk ``max(chunk, 128)``, as JAX's does."""
    if impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {impl!r}; have {SSD_IMPLS}")
    if impl == "ref":
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
    if impl == "ref":
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
