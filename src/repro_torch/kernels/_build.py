"""Build and load the CUDA kernels of ``csrc/attention.cu``.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so it builds in seconds) and
loaded with ctypes. The build lands in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built at
import: the first kernel launch builds. A missing ``nvcc`` or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "attention.cu"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each entry point (all return the launch's cudaError_t).
SIGNATURES = {
    # dtype, q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, scale,
    # nsplit, bq, stream
    "repro_flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _F, _I, _I, _P],
    # dtype, q, k, v, out, lengths, B, S, Hq, Hkv, D, scale, nsplit, stream
    "repro_flash_decode": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                           _I, _P],
    # dtype, q, k, v, out, tables, lengths, B, NB, Bs, max_blocks, Hq,
    # Hkv, D, scale, nsplit, stream
    "repro_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _P],
    # dtype, q, k, v, out, tables, lengths, q_offset, B, Sq, NB, Bs,
    # max_blocks, Hq, Hkv, D, scale, nsplit, bq, stream
    "repro_paged_prefill": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _F, _I, _I, _P],
}

_lib = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels need the CUDA toolkit to build"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libattention_{digest}.so"


def build() -> Path:
    """Compile the kernels unless this source was already built; returns
    the library's path. The compiler's report (registers, spills) is kept
    beside it as ``<lib>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def launch_plan(rows: int, group: int, other_blocks: int) -> tuple:
    """(nsplit, bq) for a grid of ceil(rows / bq) * other_blocks blocks of
    bq * group * nsplit lanes (at most 128). Split each (row, head) pair
    over more lanes, with fewer rows per block, until the grid holds two
    blocks per SM of an H100 (132 SMs) or the pairs are split 32 ways."""
    if group > 128:
        raise ValueError(f"GQA group {group} > 128 is not supported")
    nsplit = 1
    while nsplit < 32 and group * nsplit * 2 <= 128:
        bq = max(1, 128 // (group * nsplit))
        if -(-rows // bq) * other_blocks >= 264:
            break
        nsplit *= 2
    return nsplit, max(1, 128 // (group * nsplit))


DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C side's dtype codes
HEAD_DIMS = (16, 32, 64, 128)


def check_tensors(name: str, q, *tensors) -> int:
    """Shared wrapper checks: CUDA device, one supported dtype, contiguous,
    16-byte aligned, supported head dim. Returns the dtype code."""
    code = DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if q.shape[-1] not in HEAD_DIMS:
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
