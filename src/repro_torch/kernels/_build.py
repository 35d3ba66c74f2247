"""Build and load the CUDA kernels of ``csrc/*.cu``.

Each source (``attention.cu``, ``attention_tc.cu``, ``decode_tc.cu``,
``mla_decode.cu``, ``ssd.cu``, ``uts.cu``, ``gmm.cu``) is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface (no
PyTorch headers, so it builds in seconds) and loaded with ctypes. The builds land in
``build/repro_torch/`` at the root of the checkout, each named by a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds its own library only and an unchanged one is
reused. Nothing is built at import: the first launch of a kernel builds
its library, and ``build_all`` builds every library at once, one
``nvcc`` per source, all running together. A missing ``nvcc`` or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("attention", "attention_tc", "decode_tc",
                        "mla_decode", "ssd", "uts", "gmm")}
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each library's entry points (all return the launch's
# cudaError_t).
SIGNATURES = {
    "attention": {
        # dtype, q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, scale,
        # nsplit, bq, stream
        "repro_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _I, _I, _P],
        # dtype, q, k, v, out, lengths, B, S, Hq, Hkv, D, scale, nsplit,
        # stream
        "repro_flash_decode": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _F, _I, _P],
        # dtype, q, k, v, out, tables, lengths, B, NB, Bs, max_blocks, Hq,
        # Hkv, D, scale, nsplit, stream
        "repro_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _F, _I, _P],
        # dtype, q, k, v, out, tables, lengths, q_offset, B, Sq, NB, Bs,
        # max_blocks, Hq, Hkv, D, scale, nsplit, bq, stream
        "repro_paged_prefill": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    "attention_tc": {
        # q, k, v, out, B, Sq, Skv, Hq, Hkv, D, Dv, causal, scale, stream
        "repro_flash_attention_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _F, _P],
        # q, k, v, out, tables, lengths, q_offset, B, Sq, NB, Bs,
        # max_blocks, Hq, Hkv, D, scale, cluster, stream
        "repro_paged_prefill_tc": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _I, _P],
    },
    "decode_tc": {
        # q, k, v, out, lengths, B, S, Hq, Hkv, D, scale, cluster, stream
        "repro_flash_decode_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _I, _P],
        # q, k, v, out, tables, lengths, B, NB, Bs, max_blocks, Hq, Hkv, D,
        # scale, cluster, stream
        "repro_paged_decode_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _I, _P],
    },
    "mla_decode": {
        # q, pool, out, tables, lengths, B, NB, Bs, max_blocks, H, Dk, Dv,
        # scale, cluster, stream
        "repro_mla_paged_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _P],
    },
    "ssd": {
        # dtype, x, dt, A, B, C, y, h, Bt, T, H, P, N, L, cluster, tile,
        # stream
        "repro_ssd_chunked": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P],
        # dtype, x, dt, A, B, C, y, h, Bt, T, H, P, N, L, stream
        "repro_ssd_chunked_loop": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _P],
    },
    "uts": {
        # d0, d1, base, thresholds, cd0, cd1, m, M, W, stream
        "repro_uts_expand": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
        "repro_uts_expand_lane": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "gmm": {
        # dtype, x, w, group_sizes, out, T, D, F, E, stream
        "repro_gmm": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels need the CUDA toolkit to build"
        )
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes()
        + b"".join(h.read_bytes() for h in HEADERS)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start compiling ``name`` unless it is built; returns (output path,
    temporary path, process), the process None when there is nothing to
    do."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc) -> Path:
    if proc is None:
        return out
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(stdout + stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCES[name]}:\n"
            f"{stderr[-4000:]}"
        )
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return out


def build(name: str) -> Path:
    """Compile one library unless this source was already built; returns
    its path. The compiler's report (registers, spills) is kept beside it
    as ``<lib>.log``."""
    return _finish(name, *_start(name))


def build_all() -> Dict[str, Path]:
    """Compile every library, one ``nvcc`` process per source, all started
    before any is waited for."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, *s) for name, s in started.items()}


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    if name not in _libs:
        handle = ctypes.CDLL(str(build(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(handle, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = handle
    return _libs[name]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def launch_plan(rows: int, group: int, other_blocks: int) -> tuple:
    """(nsplit, bq) of the CUDA-core kernels of ``attention.cu`` (float32
    attention, decode and paged prefill) for a grid of ceil(rows / bq)
    * other_blocks blocks of bq * group * nsplit lanes (at most 128).
    Split each (row, head) pair over more lanes, with fewer rows per
    block, until the grid holds two blocks per SM of an H100 (132 SMs) or
    the pairs are split 32 ways."""
    if group > 128:
        raise ValueError(f"GQA group {group} > 128 is not supported")
    nsplit = 1
    while nsplit < 32 and group * nsplit * 2 <= 128:
        bq = max(1, 128 // (group * nsplit))
        if -(-rows // bq) * other_blocks >= 264:
            break
        nsplit *= 2
    return nsplit, max(1, 128 // (group * nsplit))


MAX_CLUSTER = 8      # the portable thread-block cluster size
DECODE_ROWS = 16     # query heads a bf16 decode block serves: the mma's M


def decode_plan(batch: int, kv_heads: int, group: int) -> tuple:
    """(cluster size c, grid) of the bf16 decode kernels of
    ``decode_tc.cu``: each (slot, KV head, 16-head slice of the group) is
    served by a cluster of c blocks that split its keys, on a grid of (c,
    kv_heads * ceil(group / 16), batch). c is the largest power of two up
    to 8 that keeps the grid within two blocks per SM of an H100 (132
    SMs): one wave, since a second wave of blocks costs more than the
    longer shares it saves. Static shapes only: the blocks size their
    shares from the lengths on the device."""
    if not 1 <= group <= 128:
        raise ValueError(f"GQA group {group} is not in [1, 128]")
    slices = kv_heads * -(-group // DECODE_ROWS)
    c = 1
    while c < MAX_CLUSTER and batch * slices * c * 2 <= 2 * 132:
        c *= 2
    return c, (c, slices, batch)


def latent_decode_plan(batch: int) -> tuple:
    """(cluster size c, grid) of ``mla_paged_decode_kernel``
    (``mla_decode.cu``): each slot is served by a cluster of c blocks
    that split its keys, on a grid of (c, 1, batch); c is the largest
    power of two up to 8 that keeps the grid within two blocks per SM of
    an H100 (132 SMs), as ``decode_plan``. Static shapes only."""
    c = 1
    while c < MAX_CLUSTER and batch * c * 2 <= 2 * 132:
        c *= 2
    return c, (c, 1, batch)


PREFILL_ROWS = 64    # (query row, head) pairs a bf16 prefill block serves
PREFILL_CLUSTER = 4  # the cluster of a bf16 prefill grid that is split
PREFILL_SPLIT_BLOCKS = 16   # ... when the grid has at most this many tiles


def prefill_plan(batch: int, kv_heads: int, group: int, rows: int) -> tuple:
    """(cluster size c, grid) of the bf16 ``paged_prefill_tc_kernel`` of
    ``attention_tc.cu``: each (tile of 64 (query row, head) pairs, KV
    head, sequence) is served by a cluster of c blocks that split its
    keys, on a grid of (c * ceil(rows * group / 64), kv_heads, batch).
    c is ``PREFILL_CLUSTER`` when there are at most
    ``PREFILL_SPLIT_BLOCKS`` tiles (an eighth of an H100's 132 SMs), else
    1: on the card (``tools/prefill_ab.py``) moonshot-v1-16b-a3b's
    64-token chunk (16 tiles of D 128) ran fastest in clusters of 4 and
    tinyllama-1.1b's (32 tiles of D 64) unsplit, the cluster merge costing
    more than its shorter walks saved. Static shapes only: the blocks size
    their shares from the offsets and lengths on the device."""
    if group < 1 or rows < 1:
        raise ValueError(f"prefill_plan: group {group}, rows {rows}")
    tiles = -(-rows * group // PREFILL_ROWS)
    blocks = batch * kv_heads * tiles
    c = PREFILL_CLUSTER if blocks <= PREFILL_SPLIT_BLOCKS else 1
    return c, (c * tiles, kv_heads, batch)


SMEM_LIMIT = 232_448   # dynamic shared memory a block of an H100 may use
SSD_TILES = (16, 32, 64)    # columns of P a block of ssd_chunked_kernel


def ssd_smem_bytes(N: int, pt: int) -> int:
    """Shared memory of one block of ``ssd_chunked_kernel`` (``ssd.cu``'s
    ChunkLayout): C and B of a chunk split into bf16 hi and lo planes (64
    rows of round16(N) + 8), the same for dt x and its weighted copy (64
    rows of pt + 8), the masked C B^T (64 x 72) and h_in (round16(N) rows
    of pt + 8); the float32 run state (round16(N) rows of pt + 4) and the
    scan's 3 x 64 floats and 4 decays."""
    np_ = -(-N // 16) * 16
    ldp, ldx, lds = np_ + 8, pt + 8, pt + 4
    return (2 * 2 * 64 * ldp * 2 + 2 * 2 * 64 * ldx * 2 + 2 * 64 * 72 * 2
            + 2 * np_ * ldx * 2 + np_ * lds * 4 + 3 * 64 * 4 + 16)


def ssd_plan(batch: int, T: int, heads: int, P: int, N: int, L: int,
             cluster: int | None = None, tile: int | None = None) -> tuple:
    """(cluster size c, column tile pt, most chunks a block takes, grid)
    of ``ssd_chunked_kernel`` in ``ssd.cu``: each (row, head, tile of pt
    columns of P) is a cluster of c blocks, block k taking the chunks
    [k n / c, (k + 1) n / c) of the n = T / L chunks, on a grid of (c,
    heads * ceil(P / pt), batch). pt is the narrowest tile that covers P
    (64 past it) whose shared memory fits, so that one block serves a
    whole head where it can and C B^T is made once per head and chunk. c
    is the largest power of two up to 8 and n (no block without a chunk)
    that keeps the grid within one wave of an H100's 132 SMs (a block
    takes an SM): on the card (``tools/ssd_ab.py``) the 1024-token bucket
    ran faster in clusters of 4 than of 8, whose second wave cost more
    than the shorter runs saved. ``cluster`` and ``tile`` override the
    choice (the design sweep and the card tests use them). Static shapes
    only."""
    if L < 1 or T % L or min(batch, heads, P, N) < 1:
        raise ValueError(f"ssd_plan: T {T}, L {L}, batch {batch}, heads "
                         f"{heads}, P {P}, N {N}")
    n = T // L
    pt = tile
    if pt is None:
        fits = [t for t in SSD_TILES if ssd_smem_bytes(N, t) <= SMEM_LIMIT]
        if not fits:
            raise ValueError(f"ssd_plan: state size {N} does not fit")
        pt = next((t for t in fits if t >= P), fits[-1])
    if pt not in SSD_TILES or ssd_smem_bytes(N, pt) > SMEM_LIMIT:
        raise ValueError(f"ssd_plan: tile {pt} at state size {N}")
    runs = batch * heads * -(-P // pt)       # blocks at c = 1
    c = cluster
    if c is None:
        c = 1
        while c < MAX_CLUSTER and 2 * c <= n and 2 * c * runs <= 132:
            c *= 2
    if c not in (1, 2, 4, 8):
        raise ValueError(f"ssd_plan: cluster {c} is not 1, 2, 4 or 8")
    return c, pt, -(-n // c), (c, heads * -(-P // pt), batch)


DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C side's dtype codes
HEAD_DIMS = (16, 32, 64, 112, 128)
# (q/k, v) widths beyond HEAD_DIMS: MLA's expanded prefill (qk 192, v 128,
# bf16 flash_attention only) and its latent decode (mla_paged_decode)
SPLIT_DIMS = ((192, 128),)
LATENT_DIMS = ((576, 512),)


def check_tensors(name: str, q, *tensors) -> int:
    """Shared wrapper checks: CUDA device, one supported dtype, contiguous,
    16-byte aligned, supported head dim. Returns the dtype code."""
    code = DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if (q.shape[-1], tensors[-1].shape[-1]) in SPLIT_DIMS:
        if q.dtype != torch.bfloat16:
            raise TypeError(f"{name}: widths {SPLIT_DIMS} are bfloat16 "
                            "only")
    elif q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    for t in (q, *tensors):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} / {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return code


def check_index(name: str, t, shape, device) -> None:
    if t.dtype != torch.int32 or t.device != device:
        raise TypeError(f"{name}: index tensors must be int32 on {device}, "
                        f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: index tensor shape {tuple(t.shape)}, "
                         f"want contiguous {tuple(shape)}")
