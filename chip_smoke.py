#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  — requires CUDA; prints the card's name and power limit.
  2. build   — compiles the CUDA kernels (csrc/attention.cu) with nvcc.
  3. kernels — each of the four attention kernels against its plain
               PyTorch version at the serving path's full-width shapes
               (tinyllama-1.1b: 32 query heads, 4 KV heads, head dim 64)
               in bf16 and f32, plus edge cases (idle slot, garbage table
               entries, ragged tail, mid-block q_offset); times each kernel,
               its plain version and scaled_dot_product_attention on the
               same work (a yardstick only: the port never calls it),
               replayed from a CUDA graph and issued eagerly.
  4. serve   — tinyllama-1.1b at full width (22 layers, random weights
               from a seed, bf16) serving 16 requests through the engine
               in its three modes: contiguous, paged, and paged with
               prefix cache + chunked prefill. Every request must finish
               and every kernel must have been launched. Then a profile
               of steady contiguous decode: host time per engine step
               against the device time of its kernels, by kind.
  5. parity  — kernel path vs plain path end to end: identical greedy
               tokens on the f32 smoke config in every mode, and close
               last-position prefill logits at full width.
The last two lines of standard output are one JSON object with each
kernel's numbers and the contract line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and dense
# FLOP/s by type (bf16 on the tensor cores, f32 outside them).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Kernel vs plain version on the same inputs: bf16 outputs are rounded
# once from f32 accumulators in both, so they differ by at most ~1 bf16
# ulp of |o| <= 2 (2^-7); f32 differs only in summation order.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "flash_decode": "src/repro/kernels/flash_decode.py:90",
    "paged_decode": "src/repro/kernels/paged_decode.py:101",
    "paged_prefill": "src/repro/kernels/paged_decode.py:215",
}
SOURCE = "src/repro_torch/csrc/attention.cu"

# Full-width serving configuration (phase 4).
SERVE = dict(max_slots=8, max_seq=1024, pad_len=256, steps_per_sync=8)
BLOCK = 16
N_REQ = 16
CHUNK = 64
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------- timing
def time_ms(fn, iters: int = 20) -> tuple:
    """(device ms, eager ms) per call of ``fn``, both from CUDA events.
    Device: ``iters`` calls captured in one CUDA graph and replayed, so
    the host's issue rate does not enter. Eager: the same calls issued one
    by one from Python, as the engine issues them; where that is larger,
    the host, not the card, sets the pace. Inputs stay in L2 across calls
    (a few MB), so both are warm-cache times."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, eager


# ------------------------------------------------------------ phase 1
def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ------------------------------------------------------------ phase 2
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.time()
    path = _build.build()
    _build.lib()
    report = path.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(s) for s in
                 re.findall(r"(\d+) bytes spill stores", report))
    log(f"[build] {path.name} in {time.time() - t0:.1f} s; "
        f"{len(regs)} kernels, max {max(regs)} registers, "
        f"{spills} bytes of spill stores in all")


# ------------------------------------------------------------ phase 3
def _tables(rng, lens, max_blocks, num_blocks, garbage=False):
    """Disjoint scrambled block tables; past each allocation -1 (or, with
    garbage, random out-of-range values)."""
    import numpy as np

    perm = list(rng.permutation(num_blocks))
    bt = np.full((len(lens), max_blocks), -1, np.int32)
    if garbage:
        bt[:] = rng.integers(-5, 10 * num_blocks, bt.shape)
    for b, L in enumerate(lens):
        n = -(-L // BLOCK)
        bt[b, :n] = [perm.pop() for _ in range(n)]
    return bt


def kernel_cases(dtype_name: str, rng):
    """(kernel name, case label, kernel fn, plain fn, library fn or None,
    bytes, flops) for the main-path shapes and the edge cases."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd

    dev = DEVICE
    dt = getattr(torch, dtype_name)
    el = torch.tensor([], dtype=dt).element_size()
    Hq, Hkv, D = 32, 4, 64
    rnd = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dt)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    sdpa = F.scaled_dot_product_attention
    cases = []

    # flash_attention: one prompt bucket, causal (main path), plus a
    # ragged row count and the non-causal form.
    for label, B, Sq, Skv, causal in (("main", 1, 256, 256, True),
                                      ("ragged", 2, 77, 77, True),
                                      ("noncausal", 1, 40, 96, False)):
        q, k, v = rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
        vis = sum(min(Skv, i + Skv - Sq + 1) if causal else Skv
                  for i in range(Sq)) * B
        lib = (lambda q=q, k=k, v=v, c=causal: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=c, enable_gqa=True))
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal: fa.flash_attention(
                q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal: fa.attention_ref(
                q, k, v, causal=c),
            lib if label == "main" else None,
            (2 * q.numel() + 2 * k.numel()) * el, 4 * D * Hq * vis))

    # flash_decode: 8 slots of a 1024-row cache, mixed lengths; edge: an
    # idle slot (length 0) that must output exact zeros.
    S = SERVE["max_seq"]
    for label, lens in (("main", rng.integers(100, 385, 8)),
                        ("idle", [0, 1, 700, 1024, 0, 64, 65, 3])):
        B = len(lens)
        q, k, v = rnd(B, 1, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        ln = i32(lens)
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])
        mask = mask[:, None, None, :]
        lib = (lambda q=q, k=k, v=v, m=mask: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m, enable_gqa=True))
        n = int(np.sum(lens))
        cases.append((
            "flash_decode", label,
            lambda q=q, k=k, v=v, ln=ln: fd.flash_decode(q, k, v, ln),
            lambda q=q, k=k, v=v, ln=ln: fd.decode_ref(q, k, v, ln),
            lib if label == "main" else None,
            2 * q.numel() * el + 2 * n * Hkv * D * el + 4 * B,
            4 * D * Hq * n))

    # paged_decode: the engine's pool (8 slots x 64 blocks of 16 tokens),
    # scrambled tables; edge: idle slot and garbage entries past each
    # allocation.
    MB = S // BLOCK
    NB = SERVE["max_slots"] * MB
    for label, lens, garbage in (
            ("main", rng.integers(100, 385, 8), False),
            ("idle+garbage", [0, 17, 1024, 300, 0, 16, 1, 999], True)):
        B = len(lens)
        q = rnd(B, 1, Hq, D)
        kp, vp = rnd(NB, BLOCK, Hkv, D), rnd(NB, BLOCK, Hkv, D)
        bt = i32(_tables(rng, lens, MB, NB, garbage))
        ln = i32(lens)
        kg, vg = pd._gather(kp, bt, B), pd._gather(vp, bt, B)
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])
        mask = mask[:, None, None, :]
        lib = (lambda q=q, k=kg, v=vg, m=mask: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m, enable_gqa=True))
        n = int(np.sum(lens))
        nblk = sum(-(-int(L) // BLOCK) for L in lens)
        cases.append((
            "paged_decode", label,
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln: pd.paged_decode(
                q, kp, vp, bt, ln),
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln: pd.paged_decode_ref(
                q, kp, vp, bt, ln),
            lib if label == "main" else None,
            2 * q.numel() * el + 2 * n * Hkv * D * el + 4 * (B + nblk),
            4 * D * Hq * n))

    # paged_prefill: one 64-token chunk of a long prompt (main path:
    # chunked prefill with prefill_chunk=64), block-aligned offset; edges:
    # mid-block offset, a one-token chunk, a padded tail (window shorter
    # than the chunk), garbage entries.
    for label, offs, Sq, tail, garbage in (
            ("main", [128], CHUNK, 0, False),
            ("midblock", [37, 200], 50, 0, False),
            ("one-token", [300, 5], 1, 0, True),
            ("padded-tail", [16, 90], 24, 9, True)):
        B = len(offs)
        lens = [o + Sq - tail for o in offs]
        q = rnd(B, Sq, Hq, D)
        kp, vp = rnd(NB, BLOCK, Hkv, D), rnd(NB, BLOCK, Hkv, D)
        bt = i32(_tables(rng, lens, MB, NB, garbage))
        ln, off = i32(lens), i32(offs)
        kg, vg = pd._gather(kp, bt, B), pd._gather(vp, bt, B)
        kpos = torch.arange(kg.shape[1], device=dev)
        qpos = off[:, None] + torch.arange(Sq, device=dev)[None, :]
        mask = ((kpos[None, None, :] <= qpos[:, :, None])
                & (kpos[None, None, :] < ln[:, None, None]))[:, None]
        lib = (lambda q=q, k=kg, v=vg, m=mask: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m, enable_gqa=True))
        vis = sum(max(0, min(L, o + i + 1)) for o, L in zip(offs, lens)
                  for i in range(Sq))
        keys = sum(lens)
        cases.append((
            "paged_prefill", label,
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln, off=off:
                pd.paged_prefill(q, kp, vp, bt, ln, off),
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln, off=off:
                pd.paged_prefill_ref(q, kp, vp, bt, ln, off),
            lib if label == "main" else None,
            2 * q.numel() * el + 2 * keys * Hkv * D * el
            + 4 * (3 * B + sum(-(-L // BLOCK) for L in lens)),
            4 * D * Hq * vis))
    return cases


def phase_kernels():
    """Hold every kernel against its plain version; returns the main-path
    numbers of each kernel (bf16)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        for name, label, kern, plain, lib, nbytes, flops in kernel_cases(
                dtype_name, rng):
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{name}/{label}/{dtype_name}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= TOL[dtype_name]
            if label in ("idle", "idle+garbage"):
                # idle slots (length 0) must be exact zeros
                idle = got.float().reshape(got.shape[0], -1).abs().amax(1)
                ok = ok and bool((idle[[0, 4]] == 0).all())
            log(f"[kernels] {name:15s} {label:12s} {dtype_name:8s} "
                f"max_abs_err {err:.3e} (tol {TOL[dtype_name]:g}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"{name}/{label}/{dtype_name} disagrees with its "
                     f"plain version: {err}")
            if label != "main" or dtype_name != "bfloat16":
                continue
            bound_b = nbytes / PEAK_BYTES * 1e3
            bound_f = flops / PEAK_FLOPS[dtype_name] * 1e3
            ms, eager = time_ms(kern)
            (plain_ms, plain_eager), (lib_ms, lib_eager) = (
                time_ms(plain), time_ms(lib))
            row = dict(
                name=name, route="cuda", source=SOURCE,
                replaces=REPLACES[name], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=max(bound_b, bound_f),
                bound_by="bytes" if bound_b >= bound_f else "operations",
                library_ms=lib_ms,
            )
            rows[name] = row
            log(f"[kernels] {name:15s} kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, "
                f"{flops} flop); issued eagerly: kernel {eager:.4f} "
                f"plain {plain_eager:.4f} library {lib_eager:.4f} ms")
    return rows


# ------------------------------------------------------------ phase 4
def _requests(rng, vocab, n=N_REQ):
    """Prompts of 100-256 tokens (the first 64 a shared system prompt, so
    the prefix cache has something to hit) and 32-128 new tokens."""
    from repro_torch.serve import Request

    system = [int(t) for t in rng.integers(1, vocab, 64)]
    out = []
    for i in range(n):
        length = int(rng.integers(100, 257))
        body = [int(t) for t in rng.integers(1, vocab, length - 64)]
        out.append(Request(rid=i, prompt=system + body,
                           max_new=int(rng.integers(32, 129))))
    return out


def _serve(engine, reqs, step=None, guard=5000):
    for r in reqs:
        engine.submit(r)
    step = step or engine.step
    n = 0
    while engine.load > 0 and n < guard:
        step()
        n += 1
    return n


MODES = {
    "contiguous": {},
    "paged": dict(paged=True, block_size=BLOCK),
    "paged+prefix+chunk": dict(paged=True, block_size=BLOCK,
                               prefix_cache=True, prefill_chunk=CHUNK,
                               token_budget=256),
}


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine

    cfg = ARCHS["tinyllama-1.1b"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    params = init_lm(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.dtype}, weights in "
        f"{time.time() - t0:.1f} s")
    totals = {name: 0 for name in ops.kernel_launches()}
    steps = {}
    for mode, kw in MODES.items():
        reqs = _requests(np.random.default_rng(1), cfg.vocab)
        eng = Engine(cfg, params, device=DEVICE, **SERVE, **kw)
        torch.cuda.synchronize()
        ops.reset_launches()               # counts of this run only
        t0 = time.time()
        n = _serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = ops.kernel_launches()
        for name, c in counts.items():
            totals[name] += c
        if not all(r.done for r in reqs):
            fail(f"{mode}: {sum(not r.done for r in reqs)} requests "
                 f"unfinished after {n} steps")
        for r in reqs:
            if not r.out or min(r.out) < 0 or max(r.out) >= cfg.vocab:
                fail(f"{mode}: request {r.rid} emitted bad ids")
        st = eng.stats()
        toks = st["tokens_out"]
        steps[mode] = st["steps"]
        log(f"[serve] {mode}: {len(reqs)} requests, {toks} tokens in "
            f"{wall:.2f} s = {toks / wall:.1f} tok/s; TTFT p50 "
            f"{st['ttft_ms_p50']:.1f} ms p99 {st['ttft_ms_p99']:.1f} ms; "
            f"{st['host_syncs'] / toks:.4f} host syncs/token; "
            f"{st['steps']} engine steps; launches {counts}")
    for name, c in totals.items():
        if c <= 0:
            fail(f"kernel {name} was never launched on the main path")
    log(f"[serve] launches over the three runs: {totals}")
    return params, totals, steps


def phase_profile(params):
    """Where a decode step's time goes: the contiguous engine with all
    slots busy, two engine steps (2 x steps_per_sync tokens per slot)
    timed on the host clock, then the same two steps again under
    torch.profiler, whose kernel records give the device time by kind."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.serve import Engine

    cfg = ARCHS["tinyllama-1.1b"]
    eng = Engine(cfg, params, device=DEVICE, **SERVE)
    for r in _requests(np.random.default_rng(4), cfg.vocab,
                       n=SERVE["max_slots"]):
        r.max_new = 128                # nobody finishes inside the window
        eng.submit(r)
    eng.step()                         # admits every slot; warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / 2 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
    kinds = {"attention kernels": 0.0, "matmul": 0.0, "copies": 0.0,
             "other": 0.0}
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("attention kernels" if "attention_kernel" in name
                or "decode_kernel" in name or "prefill_kernel" in name
                else "matmul" if any(s in name for s in (
                    "gemm", "gemv", "splitk", "nvjet", "xmma", "cutlass",
                    "cublas"))
                else "copies" if name.startswith(("memcpy", "memset"))
                else "other")
        ms = e.time_range.elapsed_us() / 1e3 / 2
        kinds[kind] += ms
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 0.5, t + ms)
        count += 1
    busy = sum(kinds.values())
    log(f"[profile] contiguous decode, {SERVE['max_slots']} busy slots: "
        f"{wall:.2f} ms per engine step ({SERVE['steps_per_sync']} tokens "
        f"per slot) on the host clock")
    if count == 0:
        log("[profile] device time not measured: the profiler recorded no "
            "kernel")
        return
    log(f"[profile] device busy {busy:.2f} ms per step = "
        f"{100 * busy / wall:.1f}% of the step; {count / 2:.0f} device "
        f"records per step; by kind (ms per step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"[profile]   {ms:8.3f} ms {n:6.0f}x per step  {name[:90]}")


# ------------------------------------------------------------ phase 5
def phase_parity(params_full):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import forward, init_lm
    from repro_torch.serve import Engine

    # (a) f32 smoke config: kernel path vs plain path, greedy tokens.
    base = ARCHS["tinyllama-1.1b"].smoke()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm(base, gen, device=DEVICE)
    kw = dict(max_slots=4, max_seq=128, pad_len=32, steps_per_sync=4)
    modes = dict(MODES, **{"paged+prefix+chunk": dict(
        paged=True, block_size=8, prefix_cache=True, prefill_chunk=16,
        token_budget=32)})
    modes["paged"] = dict(paged=True, block_size=8)
    for mode, mkw in modes.items():
        outs = []
        for impl in ("auto", "ref"):
            cfg = dataclasses.replace(base, attn_impl=impl, decode_impl=impl)
            rng = np.random.default_rng(2)
            reqs = [_smoke_req(rng, i) for i in range(8)]
            eng = Engine(cfg, params, device=DEVICE, **kw, **mkw)
            _serve(eng, reqs)
            if not all(r.done for r in reqs):
                fail(f"parity {mode}/{impl}: unfinished requests")
            outs.append([r.out for r in reqs])
        same = outs[0] == outs[1]
        log(f"[parity] f32 smoke {mode}: kernel vs plain greedy tokens "
            f"{'identical' if same else 'DIFFER'}")
        if not same:
            fail(f"greedy tokens differ between kernel and plain path "
                 f"({mode})")

    # (b) full width, bf16: last-position prefill logits.
    cfg = ARCHS["tinyllama-1.1b"]
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (1, 256)),
                           dtype=torch.int32, device=DEVICE)
    lg = {}
    with torch.inference_mode():
        for impl in ("auto", "ref"):
            c = dataclasses.replace(cfg, attn_impl=impl, decode_impl=impl)
            lg[impl] = forward(params_full, c, toks)[0][0, -1].float()
    if not torch.isfinite(lg["auto"]).all():
        fail("full-width prefill logits are not finite")
    err = (lg["auto"] - lg["ref"]).abs().max().item()
    scale = lg["ref"].abs().max().item()
    # Both paths round q/k/v and the attention output to bf16; 22 layers
    # compound one-ulp differences. Hold them to 5% of the logit range.
    ok = err <= 0.05 * scale
    log(f"[parity] full-width bf16 last-position logits: max_abs_err "
        f"{err:.4e} vs max |logit| {scale:.4e} (tol 5%) "
        f"{'ok' if ok else 'MISMATCH'}; argmax "
        f"{int(lg['auto'].argmax())} vs {int(lg['ref'].argmax())}")
    if not ok:
        fail("full-width prefill logits disagree")


def _smoke_req(rng, i):
    from repro_torch.serve import Request

    shared = [7, 3, 9, 2, 5, 8, 6, 4, 1, 2, 3, 4]
    tail = [int(t) for t in rng.integers(1, 512, int(rng.integers(3, 30)))]
    return Request(rid=i, prompt=shared + tail,
                   max_new=int(rng.integers(8, 40)))


# --------------------------------------------------------------- main
def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke FAILED: src/repro_torch not found beside "
              "chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    params, totals, steps = phase_serve()
    phase_profile(params)
    phase_parity(params)
    all_steps = sum(steps.values())
    for name, row in rows.items():
        row["launches"] = totals[name]
        log(f"[summary] {name}: {totals[name]} launches over {all_steps} "
            f"engine steps = {totals[name] / all_steps:.2f} per step")
    log(f"[summary] card: {smi}")
    print(json.dumps({"kernels": [rows[n] for n in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
