"""Mamba2 SSD (state-space duality) chunk scan: the ssm family's prefill.

``ssd_chunked`` launches ``ssd_chunked_kernel`` of ``csrc/ssd.cu`` (it
replaces the Pallas kernel ``repro/kernels/mamba2_ssd.py:ssd_chunked``):
the chunks of a sequence run in parallel in a thread-block cluster that
passes the state on through distributed shared memory, the products on
the tensor cores as bf16x3 (each float32 operand split once into two bf16
halves), for float32 and bfloat16 x alike.
``_launch(..., loop=True)`` runs the first version of the kernel
(``ssd_chunked_loop_kernel``: one block walks every chunk in order), which
only the card tests, ``chip_smoke.py`` and ``tools/ssd_ab.py`` call.
Its plain PyTorch versions are ``ssd_ref``, the sequential scan, and
``ssd_chunked_ref``, the chunk-matmul form that does the kernel's
arithmetic (the counterparts of ``repro.kernels.ref.ssd_ref`` and
``ssd_chunked_ref``). The recurrence, for a chunk of L tokens with the
inclusive log-decay prefix s_t = A * sum_{tau<=t} dt_tau:

    y_intra = ((C B^T) o M) (dt x)      M[t, tau] = exp(s_t - s_tau) [tau<=t]
    y_inter = exp(s_t) (C h_in)
    h_out   = exp(s_L) h_in + B^T diag(exp(s_L - s_t) dt) x

Layouts are JAX's: x (Bt, T, H, P), dt (Bt, T, H), A (H,), B and C
(Bt, T, N) (one group) -> y (Bt, T, H, P) in x's dtype and the final state
h (Bt, H, N, P) in float32. All math is float32. The chunk contract is
JAX's: L = min(chunk, T) must divide T.
"""
from __future__ import annotations

import torch

from . import _build
from .autograd import KernelFunction, needs_grad

MAX_CHUNK = 64      # the kernel's longest chunk
MAX_STATE = 256     # the kernel's largest N


def ssd_ref(x, dt, A, B, C, h0=None):
    """Sequential state-space scan (the Mamba2 SSD semantics); h0 is an
    optional (Bt, H, N, P) initial state."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), B.float(), C.float(), \
        A.float()
    # the zero state takes x's type (a DTensor on x's mesh, replicated)
    h = (x.new_zeros((Bt, H, N, P), dtype=torch.float32)
         if h0 is None else h0.float())
    ys = []
    for t in range(T):
        a = torch.exp(Af[None, :] * dtf[:, t])                  # (Bt, H)
        dx = dtf[:, t, :, None] * xf[:, t]                      # (Bt, H, P)
        upd = Bf[:, t, None, :, None] * dx[:, :, None, :]       # (Bt,H,N,P)
        h = h * a[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), h


def chunk_len(T: int, chunk: int) -> int:
    """L = min(chunk, T); raises unless it divides T (JAX's contract)."""
    L = min(chunk, T)
    if L < 1 or T % L:
        raise ValueError(f"ssd: sequence length {T} is not a multiple of "
                         f"the chunk length {L}")
    return L


def ssd_chunked_ref(x, dt, A, B, C, chunk: int = 256):
    """Chunk-matmul SSD in plain PyTorch: a loop over T / L chunks with
    matrix products inside, the same math as the kernel."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    L = chunk_len(T, chunk)
    nck = T // L
    xf = x.float().reshape(Bt, nck, L, H, P)
    dtf = dt.float().reshape(Bt, nck, L, H)
    Bf = B.float().reshape(Bt, nck, L, N)
    Cf = C.float().reshape(Bt, nck, L, N)
    Af = A.float()
    tri = torch.tril(x.new_ones((L, L), dtype=torch.float32))
    h = x.new_zeros((Bt, H, N, P), dtype=torch.float32)
    ys = []
    for c in range(nck):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        s = Af[None, None, :] * torch.cumsum(dtc, dim=1)        # (Bt,L,H)
        dx = dtc[..., None] * xc                                # (Bt,L,H,P)
        G = torch.einsum("btn,bun->btu", Cc, Bc)                # (Bt,L,L)
        logm = s[:, :, None] - s[:, None, :]                    # (Bt,L,L,H)
        M = torch.exp(logm.clamp(max=0.0)) * tri[None, :, :, None]
        y = torch.einsum("btu,btuh,buhp->bthp", G, M, dx)
        y = y + torch.exp(s)[..., None] * torch.einsum(
            "btn,bhnp->bthp", Cc, h)
        s_l = s[:, -1]                                          # (Bt, H)
        wts = torch.exp(s_l[:, None] - s)[..., None] * dx       # (Bt,L,H,P)
        h = torch.exp(s_l)[:, :, None, None] * h + torch.einsum(
            "bun,buhp->bhnp", Bc, wts)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bt, T, H, P)
    return y.to(x.dtype), h


def _check(x, dt, A, B, C, chunk: int) -> tuple:
    """The kernels' contract; returns (chunk length L, dtype code) or
    raises before any launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"ssd_chunked: bad ranks x {tuple(x.shape)} "
                         f"B {tuple(B.shape)}")
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    if (tuple(dt.shape) != (Bt, T, H) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (Bt, T, N) or C.shape != B.shape):
        raise ValueError(
            f"ssd_chunked: bad shapes x {tuple(x.shape)} dt "
            f"{tuple(dt.shape)} A {tuple(A.shape)} B {tuple(B.shape)} "
            f"C {tuple(C.shape)}")
    L = chunk_len(T, chunk)
    if L > MAX_CHUNK:
        raise ValueError(f"ssd_chunked: chunk {L} > {MAX_CHUNK}")
    if N % 4 or N > MAX_STATE:
        raise ValueError(f"ssd_chunked: state size {N} must be a multiple "
                         f"of 4 up to {MAX_STATE}")
    code = _build.DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"ssd_chunked: x dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunked: {name} must be float32, got "
                            f"{t.dtype}")
    for t in (x, dt, A, B, C):
        if t.device != x.device:
            raise ValueError(f"ssd_chunked: tensors on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("ssd_chunked: inputs must be contiguous")
    if B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("ssd_chunked: B and C must be 16-byte aligned")
    return L, code


def _launch(x, dt, A, B, C, chunk: int, *, cluster=None, tile=None,
            loop: bool = False):
    """One launch of ``ssd_chunked_kernel`` on the plan of
    ``_build.ssd_plan`` (``cluster`` and ``tile`` override it), or with
    ``loop`` of ``ssd_chunked_loop_kernel``, the first version of the
    kernel; counts nothing. Returns (y, h)."""
    L, code = _check(x, dt, A, B, C, chunk)
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    args = (code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, T, H, P, N, L)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.lib("ssd")
    if loop:
        err = lib.repro_ssd_chunked_loop(*args, stream)
    else:
        c, pt, _, _ = _build.ssd_plan(Bt, T, H, P, N, L, cluster, tile)
        err = lib.repro_ssd_chunked(*args, c, pt, stream)
    _build.check(err, "ssd_chunked_loop" if loop else "ssd_chunked")
    return y, h


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 64):
    """x (Bt, T, H, P) float32 or bfloat16; dt (Bt, T, H), A (H,), B and C
    (Bt, T, N) float32. Returns (y like x, h_final (Bt, H, N, P) float32).

    A CPU tensor goes to ``ssd_chunked_ref``; a CUDA tensor launches
    ``ssd_chunked_kernel`` (or raises), in either dtype: chunk lengths up
    to 64, N a multiple of 4 up to 256. Where autograd needs the
    gradient, the launch runs inside ``KernelFunction``, whose backward is
    that of ``ssd_chunked_ref`` at the same chunk (a None gradient of h
    counts as zeros)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)
    if needs_grad(x, dt, A, B, C):
        return KernelFunction.apply(_counted, ssd_chunked_ref, x, dt, A, B,
                                    C, chunk)
    return _counted(x, dt, A, B, C, chunk)


def _counted(x, dt, A, B, C, chunk):
    out = _launch(x, dt, A, B, C, chunk)
    ssd_chunked.launches += 1
    return out


ssd_chunked.launches = 0   # kernel launches (the CPU path never counts)
