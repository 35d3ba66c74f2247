"""Dispatch layer: the one attention entry point the models call.

The routing rules and error checks are those of ``repro.kernels.ops.
attention``. With ``impl="auto"`` a CUDA tensor goes to the hand-written
kernel and a CPU tensor to its plain version (each kernel
wrapper makes that choice from the tensor's device); the ``*_ref`` impls
force the plain version, which is the yardstick the kernels are held to.
"""
from __future__ import annotations

from typing import Dict

from .flash_attention import attention_ref, flash_attention
from .flash_decode import decode_ref, flash_decode
from .paged_decode import (paged_decode, paged_decode_ref, paged_prefill,
                           paged_prefill_ref)

IMPLS = ("auto", "ref", "decode", "decode_ref", "paged", "paged_ref")
KERNELS = (flash_attention, flash_decode, paged_decode, paged_prefill)


def kernel_launches() -> Dict[str, int]:
    """Launch count of each kernel wrapper, by name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def attention(q, k, v, *, causal=True, scale=None, impl: str = "auto",
              lengths=None, block_tables=None, q_offset=None):
    """impl: auto | ref | decode | decode_ref | paged | paged_ref

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
    ref = impl.endswith("ref")
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
    fn = attention_ref if ref else flash_attention
    return fn(q, k, v, causal=causal, scale=scale)
