#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase dist   # phases 1, 2 and 9 alone
    python3 chip_smoke.py --phase spmd   # phases 1, 2 and 11 alone
    python3 chip_smoke.py --phase mla    # phases 1, 2 and 3c alone

Phases, in order; any failure exits non-zero:
  1. device  — requires CUDA; prints the card's name and power limit.
  2. build   — compiles the CUDA kernels (csrc/attention.cu,
               csrc/attention_tc.cu, csrc/decode_tc.cu, csrc/ssd.cu,
               csrc/uts.cu, csrc/gmm.cu) with nvcc, one process per source,
               in parallel.
  3. kernels — each of the four attention kernels against its plain
               PyTorch version at the serving path's full-width shapes
               (tinyllama-1.1b: 32 query heads, 4 KV heads, head dim 64;
               for each also moonshot-v1-16b-a3b's, 16/16 heads of 128,
               and zamba2-7b's, 32/32 heads of 112) in bf16 and f32,
               plus edge cases (idle slot, garbage table entries, ragged
               tail, mid-block q_offset, a sequence of length 0); the
               bf16 kernels of the four are timed beside the CUDA-core
               kernels they replaced for bf16 (paged_prefill at
               tinyllama's 64-token chunk and at moonshot's);
               ssd_chunked against ssd_chunked_ref (and ssd_ref) at the
               mamba2-130m prefill shape and its 1024-token bucket (16
               chunks) and at zamba2-7b's layer (112 heads of 64, state
               64), in bf16 and f32 x, plus edge cases (two rows, T
               shorter than the chunk, chunk 16 at N 256, two rows of 512,
               a ragged T that must raise), each with its launch plan,
               timed at both buckets and zamba2's beside the first
               version of its kernel (ssd_chunked_loop_kernel). Times each
               kernel, its plain version and, for attention,
               scaled_dot_product_attention on the same work (a yardstick
               only: the port never calls it), replayed from a CUDA graph
               and issued eagerly. gmm against gmm_ref at the two shapes
               the moonshot-v1-16b-a3b MoE layer gives it (64 experts of 1
               row at decode, of 30 rows for a 256-token prefill bucket;
               D 2048 / F 1408, and F 2048 / D 1408 for wo), the compact
               decode groups the MoE layer now gives it (10 of the 64
               experts with one row, the rest empty) and an uneven case
               (empty groups, rows past the last group), in bf16 and f32,
               timed beside torch.bmm on the same work.
  3b. moe    — moonshot-v1-16b-a3b at full width (its 48 layers cut to
               24, MOE_LAYERS; 64 experts top-6, random weights made on the
               card from a seed, bf16, 29 GB) serving 16 requests in the
               three engine modes; gmm
               and the mode's attention kernels must launch in each (their
               launches count beside the tinyllama runs'). A
               profile of one decode step (device busy, gmm's share), the
               share of routed slots decode drops at 8 slots, then its
               parity checks: kernel vs plain greedy tokens on the f32
               smoke config at capacity 8.0 and 1.25 in every mode, one
               full-width MoE layer (bf16 and f32) kernel vs plain element
               by element, the full-width last-position logits, and the GLB
               expert rebalancer on one layer's counts over 8 ranks (the
               permuted layer must give the same output). The weights are
               freed before the next phase.
  3c. mla    — Moonlight-16B-A3B's two MLA kernels at its benchmark
               cell's shapes, bf16: flash_attention at qk 192 / v 128 (16
               heads) on prompts of 3,072 and 7,712 tokens against
               attention_ref, timed beside scaled_dot_product_attention;
               mla_paged_decode over 64 slots of 1,224-7,821 latent rows
               (576, values 512, blocks of 16) against
               mla_paged_decode_ref, and with an idle slot (zeros). Each
               timed beside its plain version and its bound (bytes read
               once, pair FLOPs). Then Moonlight at full width, 4 of its
               27 layers, serving 12 requests of 1,224-7,712 prompt tokens
               through the paged engine, the launch counts reset just
               before: flash_attention once a layer an admission,
               mla_paged_decode once a layer a decode iteration, gmm
               three times a routed layer a forward, and no GQA attention
               kernel. Their rows join the kernels line.
  4. serve   — tinyllama-1.1b at full width (22 layers, random weights
               from a seed, bf16) serving 16 requests through the engine
               in its three modes: contiguous, paged, and paged with
               prefix cache + chunked prefill. Every request must finish
               and every attention kernel must have been launched. Then a
               profile of steady contiguous decode: host time per engine
               step against the device time of its kernels, by kind.
  5. fabric  — mamba2-130m at full width (24 layers, random weights from a
               seed, bf16) serving 16 requests through a 2-replica
               GLBReplicaBalancer (replica 0 contiguous, replica 1 paged),
               all placed on replica 0 so that tier-1 steals must happen.
               The fabric must terminate with every request done, and
               ssd_chunked must have been launched. Then one admission's
               prefill under torch.profiler: ssd_chunked's share of it.
  5b. migrate — tinyllama-1.1b at full width (phase 4's weights) through
               two paged replicas on the card (block 16, 8 slots, max_seq
               1024, prefix cache, prefill chunk 64), 8 requests of 244-256
               prompt tokens all admitted on replica 0 before the first
               balance pass. (a) Tier 2: replica 1's pool holds 64 blocks,
               so the pass lands three sequences live and the fourth
               radix-seeded; every transfer buffer must equal the
               victim's blocks and every live landing's blocks the buffer,
               bit for bit, its size the written blocks times the bytes of
               a block, and replica 1 must launch paged_decode and
               paged_prefill after its first landing; pack and land times
               (host clock), and the gather, copies and scatter of four
               live migrations between two fresh replicas under
               torch.profiler beside their bound; tokens against a run
               without migration, printed. (b) replica 1
               crashes at superstep 2 holding running sequences: the
               fabric must terminate with replica 1 dead and its running
               sequences re-admitted on replica 0. (c) predictive
               balancing with a cost model, an SLO monitor and a flight
               recorder an eighth the size of the run's trace: a diffusion
               move, a valid dump, and the same traffic under an unbounded
               tracer attributed and stitched by the analyzer. The path's
               kernels (flash_attention, paged_decode, paged_prefill) must
               launch over the three runs. The serve phase's profile also
               prints the card's own service times per prefill and decode
               token beside the cost model's defaults.
  5c. zoo    — the rest of the model zoo at full width, random bf16
               weights made on the card from a seed, one model at a time
               (each freed before the next): zamba2-7b (hybrid: 81
               Mamba2 layers of 112 SSM heads and one weight-shared
               attention + MLP block applied 13 times, 32/32 heads of
               112) serving 16 requests contiguous and paged, with
               ssd_chunked, flash_attention and the mode's decode kernel
               launched, one decode step and one admission profiled, and
               every layer held to the plain path on the plain path's
               hidden states (5% of its range) with the whole paths'
               argmax equal; mistral-nemo-12b (32/8 heads of 128) serving
               16 requests through the paged engine (flash_attention,
               paged_decode) and through it with the prefix cache and
               64-token chunks (paged_prefill, paged_decode), its
               last-position logits held to the plain path's (5%); qwen2-vl-2b (merged embeddings of a
               text + 8 x 16-patch image prompt with three M-RoPE position
               streams) and musicgen-medium (four codebook streams), each
               through lm.prefill of 256 positions and 32 greedy
               decode_steps, every step's last-position logits within 5%
               of the plain path's fed the same tokens. Peak memory of
               each.
  6. glb     — the GLB task executor. uts_expand against uts_expand_ref,
               bit for bit, at the UTS path's shape (1024 nodes x 256
               lanes) and edge shapes (odd widths, a threshold table that
               is not non-increasing), timed like the kernels above beside
               the first version of its kernel. Then
               the paper's UTS (geometric tree, b0 4, r 19; depth 12, one
               below the paper's smallest, so that the run stays near a
               minute) on 1024 places with n 256, w 2, steal_k 64: the
               count must equal the breadth-first count of the same tree
               (itself held to the sequential oracle at depth 9) and
               uts_expand must have been launched; a few of its
               supersteps run under torch.profiler. Then fib(24) and BC on an R-MAT graph of
               scale 10 on 64 places against their oracles, and UTS at
               depth 8 on 64 places through the kernel and through the
               plain expansion, which must agree in every number.
  7. parity  — kernel path vs plain path end to end: identical greedy
               tokens on the f32 smoke configs (tinyllama in every engine
               mode, the mamba2 fabric, a migrating tinyllama fabric
               of three paged replicas, whose decisions, live steals
               included, must be identical too, zamba2 at 4 layers with
               two applications of its shared block in both engine modes,
               and qwen2-vl and musicgen through lm.prefill and 16
               decode_steps), and close last-position prefill logits at
               full width (tinyllama and mamba2).
  8. train  — training through the CLI's entry point,
               ``repro_torch.launch.train.train``, on float32 master
               weights with AdamW, the three kernels of the training path
               (flash_attention, gmm, ssd_chunked) in the forward pass
               through their autograd route (``kernels/autograd.py``: the
               kernel forward, the plain version's backward). (a)
               tinyllama-1.1b at full width, bf16 compute, remat "full",
               8 x 512 tokens, 20 steps: the loss must fall by
               TRAIN_MIN_DROP and flash_attention launch 2 x 22 times a
               step; tokens/s, step ms p50, peak memory, and the step's
               forward / backward / optimizer split (CUDA events, and
               device busy under torch.profiler) with the device time of
               each kernel's backward through its plain version, read
               from its ``record_function`` range. (b)
               moonshot-v1-16b-a3b at the 100m preset with
               --rebalance-every 5: gmm launches 3 x 12 times a step and
               the rebalancer's line is printed twice. (c) mamba2-130m at
               full width: ssd_chunked launches 2 x 24 times a step. (d)
               gradient parity on the smoke configs of the dense, moe, ssm
               and hybrid families in float32 and bf16, kernel route
               against plain route (see ``_grad_parity``). (e) the
               --fail-at-step / --resume drill at the tiny preset against
               an uninterrupted run: bit-exact.
  9. dist   — distribution, on ranks that are processes sharing the card
               (spawned; gloo, whose collectives dist/collectives.py
               stages through host memory; NCCL only at world size 1,
               since it refuses two ranks on one device). Every line
               names its backend and world size. (a) GLB(mode=
               "shard_map") on 8 ranks, one place each: the paper's UTS
               (b0 4, r 19) at depth 8 (10 with --phase dist, which runs
               phases 1, 2 and 9 alone; DIST_SIZES) with n 256, w 2,
               steal_k 64, in
               the dense and the lifeline routing: the count must equal
               the breadth-first count, the supersteps and every counter
               run_sim's on 8 places of the card, every rank must launch
               uts_expand; nodes/s, host ms per superstep by phase and
               the wire bytes per superstep against the count from the
               code. (b) fib(20) (24) and BC on R-MAT scale 10 on 8 ranks
               against their oracles and run_sim. (c) UTS at depth 7 (9)
               on NCCL at world size 1 against run_sim on one place. On 4
               ranks: (d) one full-width moonshot-v1-16b-a3b MoE layer
               expert-parallel as (1 data x 4 model) and (2 x 2), bf16
               and f32, capacity 1.25: each data shard's y within TOL of
               the plain route (gmm_ref) on that shard, counts and drops
               equal, gmm launched on every rank, timed beside the global
               layer on one rank; (e) tinyllama-1.1b at full width as a
               2-stage pipeline of 4 microbatches of (2, 256) tokens,
               bf16: bit for bit the sequential forward, within TOL of it
               with the plain attention (or as close to the float32
               forward as that, plus TOL), flash_attention launched on
               both stages; (f) compressed_psum_mean over
               one full-width tinyllama layer's gradient-shaped leaves
               against the host rendering of its formula, timed beside a
               plain all_reduce, and the 60-step regression; (g) the
               sharding rules of all ten archs at full width on the
               production meshes' shapes, and tinyllama's parameters on
               a (2 x 2) mesh: local shard shapes as specified, the
               host-staged reassembly bit for bit.
  10. dryrun — the dry run (repro_torch.launch.dryrun), its peaks from
               repro_torch.analysis.roofline. (a) On this machine's CPU,
               in this process: tinyllama-1.1b/train_4k on the 16x16
               mesh and uts_glb, over a fake world of 256 ranks; both
               must read status ok with every record key; their roofline
               rows are printed (reckoned from data-sheet peaks, not
               measured). (b) Phase 8's training cell (tinyllama-1.1b at
               full width, 8 x 512, bf16 on float32 masters, remat full)
               dry-run on a world of one, then made on the card: the
               record's argument_size_in_bytes must equal the bytes of
               init_train_state's tensors and the batch, and
               memory_allocated must grow by exactly those bytes in the
               caching allocator's 512-byte blocks; two training steps
               (flash_attention launched 2 x 2 x 22 times), the second
               timed by CUDA events, printed beside the predicted peak
               (arguments + traced temp) against max_memory_allocated and
               t_compute / t_memory against the step, with model_flops /
               (ms x 989e12). (c) attention_chunked against attention_ref
               at that cell's attention shape (8, 512, 32/4 heads of 64),
               bf16 and f32, values and the gradients of q, k and v within
               TOL of max(1, max |ref|).
  11. spmd  — the models on DTensors: tinyllama-1.1b at full width, its
               parameters, batch and cache laid out by dist.sharding
               (distribute_tree of tree_shardings) on a (2 data x 2 model)
               mesh over 4 gloo ranks sharing the card (all-gathers staged
               through pinned host memory by dist.collectives.
               CollectiveLog), each step held to the same step on one rank
               (rank 0, plain tensors, the same weights). (a) prefill, 8 x
               256 bf16, flash_attention on each rank's local heads:
               logits and the cache within TOL of max |ref|, the next
               tokens equal; (b) 8 greedy decode steps on the
               sequence-sharded cache (the masked full-cache path): logits
               within TOL; (c) one training step, 4 x 512 (phase 8's batch
               halved, for the time limit), bf16 on float32 masters, remat
               full: the loss, and every gradient leaf
               within TOL of its max or as close to the float32 gradient
               as the one-rank route's plus TOL; (d) every rank's
               memory_allocated grows by exactly the dry run's per-device
               argument_size_in_bytes of that cell on a fake world of 4
               (in 512-byte blocks), its peak printed beside the predicted
               one; (e) each step's ms, and the bytes each rank handed to
               the collectives equal to analysis.comm.traced_lm's for the
               prefill, decode and training cells (traced on a fake world
               of 4 with this device's mesh); flash_attention's launches.
The last two lines of standard output are one JSON object with each
kernel's numbers and the contract line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
if os.path.isdir(os.path.join(SRC, "repro_torch")):
    sys.path.insert(0, SRC)
    # H100 SXM published peaks (NVIDIA data sheet), kept in one place:
    # HBM3 bytes/s, and dense FLOP/s by type (bf16 on the tensor cores, f32
    # outside them; int32 one operation per CUDA-core lane per clock, so
    # the bound it gives is a least time).
    from repro_torch.analysis.roofline import HBM_BW as PEAK_BYTES
    from repro_torch.analysis.roofline import \
        PEAK_FLOPS_BY_DTYPE as PEAK_FLOPS
# Kernel vs plain version on the same inputs: bf16 outputs are rounded
# once from f32 accumulators in both, so they differ by at most ~1 bf16
# ulp of |o| <= 2 (2^-7); f32 differs only in summation order.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# SSD outputs are not bounded, so they are held element by element:
# |got - want| <= SSD_REL * |want| + 1e-4 * max(1, max |want|). The
# absolute term is f32 summation order; the relative one, for bf16 y,
# two bf16 ulps (one ulp is at most 2^-7 of the value).
SSD_REL = {"bfloat16": 2.0 ** -6, "float32": 0.0}

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "flash_decode": "src/repro/kernels/flash_decode.py:90",
    "paged_decode": "src/repro/kernels/paged_decode.py:101",
    "paged_prefill": "src/repro/kernels/paged_decode.py:215",
    "ssd_chunked": "src/repro/kernels/mamba2_ssd.py:80",
    "gmm": "src/repro/kernels/moe_gmm.py:51",
    "uts_expand": "src/repro/kernels/uts_expand.py:54",
}
SOURCES = {name: "src/repro_torch/csrc/attention.cu" for name in REPLACES}
# bf16, the main path's dtype, takes the tensor-core kernels; float32 stays
# on attention.cu's CUDA-core kernels.
SOURCES["flash_attention"] = "src/repro_torch/csrc/attention_tc.cu"
SOURCES["flash_decode"] = "src/repro_torch/csrc/decode_tc.cu"
SOURCES["paged_decode"] = "src/repro_torch/csrc/decode_tc.cu"
SOURCES["paged_prefill"] = "src/repro_torch/csrc/attention_tc.cu"
SOURCES["ssd_chunked"] = "src/repro_torch/csrc/ssd.cu"
SOURCES["uts_expand"] = "src/repro_torch/csrc/uts.cu"
SOURCES["gmm"] = "src/repro_torch/csrc/gmm.cu"
ATTENTION = ("flash_attention", "flash_decode", "paged_decode",
             "paged_prefill")
# The kernels' names as torch.profiler records them, by family.
ATTENTION_KERNELS = ("flash_attention_kernel", "flash_attention_tc_kernel",
                     "flash_decode_kernel", "flash_decode_tc_kernel",
                     "paged_decode_kernel", "paged_decode_tc_kernel",
                     "paged_prefill_kernel", "paged_prefill_tc_kernel")
GMM_KERNELS = ("gmm_kernel", "gmm_tc_kernel")

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
    paths = _build.build_all()
    wall = time.time() - t0
    for name, path in paths.items():
        _build.lib(name)
        report = path.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                           report)]
        spills = sum(int(s) for s in
                     re.findall(r"(\d+) bytes spill stores", report))
        log(f"[build] {path.name}: {len(regs)} kernels, max {max(regs)} "
            f"registers, {spills} bytes of spill stores in all")
    log(f"[build] {len(paths)} libraries in {wall:.1f} s (nvcc in "
        "parallel)")


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


def _cuda_core_attention(q, k, v, causal):
    """attention.cu's CUDA-core flash_attention_kernel on q's dtype, as the
    wrapper launched it for bf16 before the tensor-core route replaced it:
    timed beside its successor in the same run, never called by the port."""
    import torch

    from repro_torch.kernels import _build

    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    nsplit, bq = _build.launch_plan(Sq, Hq // Hkv, Hkv * B)
    err = _build.lib("attention").repro_flash_attention(
        _build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(causal),
        1.0 / D ** 0.5, nsplit, bq, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention (CUDA-core kernel)")
    return out


def _cuda_core_decode(q, k, v, lengths, tables=None):
    """attention.cu's CUDA-core flash_decode_kernel (or, with block
    tables, paged_decode_kernel) on q's dtype, as the wrappers launched
    them for bf16 before the tensor-core route replaced them: timed beside
    their successors in the same run, never called by the port."""
    import torch

    from repro_torch.kernels import _build

    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    out = torch.empty_like(q)
    nsplit, _ = _build.launch_plan(1, Hq // Hkv, Hkv * B)
    lib, st = _build.lib("attention"), torch.cuda.current_stream().cuda_stream
    if tables is None:
        err = lib.repro_flash_decode(
            _build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lengths.data_ptr(), B, k.shape[1], Hq, Hkv, D,
            1.0 / D ** 0.5, nsplit, st)
    else:
        err = lib.repro_paged_decode(
            _build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), tables.data_ptr(), lengths.data_ptr(), B,
            k.shape[0], k.shape[1], tables.shape[1], Hq, Hkv, D,
            1.0 / D ** 0.5, nsplit, st)
    _build.check(err, "decode (CUDA-core kernel)")
    return out


def _cuda_core_prefill(q, kp, vp, tables, lengths, offsets):
    """attention.cu's CUDA-core paged_prefill_kernel on q's dtype, as the
    wrapper launched it for bf16 before the tensor-core route replaced it:
    timed beside its successor in the same run, never called by the port."""
    import torch

    from repro_torch.kernels import _build

    B, Sq, Hq, D = q.shape
    Hkv = kp.shape[2]
    out = torch.empty_like(q)
    nsplit, bq = _build.launch_plan(Sq, Hq // Hkv, Hkv * B)
    err = _build.lib("attention").repro_paged_prefill(
        _build.DTYPES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        out.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        offsets.data_ptr(), B, Sq, kp.shape[0], kp.shape[1], tables.shape[1],
        Hq, Hkv, D, 1.0 / D ** 0.5, nsplit, bq,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_prefill (CUDA-core kernel)")
    return out


# Timed cases of phase 3 (bf16); "main" gives each kernel's summary row.
TIMED = ("main", "moonshot", "zamba2")
# zamba2-7b's shared attention block: 32/32 heads of 3584 / 32 = 112.
ZAMBA_HEADS = (32, 32, 112)


def kernel_cases(dtype_name: str, rng):
    """(kernel name, case label, kernel fn, plain fn, library fn or None,
    replaced kernel fn or None, bytes, flops) for the main-path shapes and
    the edge cases."""
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

    # flash_attention: one prompt bucket, causal (main path; tinyllama's
    # heads, and moonshot-v1-16b-a3b's 16/16 heads of 128), plus a ragged
    # row count and the non-causal form.
    for label, B, Sq, Skv, causal, (hq, hkv, d) in (
            ("main", 1, 256, 256, True, (Hq, Hkv, D)),
            ("moonshot", 1, 256, 256, True, (16, 16, 128)),
            ("zamba2", 1, 256, 256, True, ZAMBA_HEADS),
            ("ragged", 2, 77, 77, True, (Hq, Hkv, D)),
            ("noncausal", 1, 40, 96, False, (Hq, Hkv, D))):
        q, k, v = rnd(B, Sq, hq, d), rnd(B, Skv, hkv, d), rnd(B, Skv, hkv, d)
        vis = sum(max(0, min(Skv, i + Skv - Sq + 1)) if causal else Skv
                  for i in range(Sq)) * B
        lib = (lambda q=q, k=k, v=v, c=causal: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=c, enable_gqa=True))
        old = (lambda q=q, k=k, v=v, c=causal: _cuda_core_attention(
            q, k, v, c))
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal: fa.flash_attention(
                q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal: fa.attention_ref(
                q, k, v, causal=c),
            lib if label in TIMED else None,
            old if label in TIMED else None,
            (2 * q.numel() + 2 * k.numel()) * el, 4 * d * hq * vis))

    # flash_decode: 8 slots of a 1024-row cache, mixed lengths (tinyllama's
    # heads, and moonshot-v1-16b-a3b's 16/16 heads of 128); edge: an idle
    # slot (length 0) that must output exact zeros.
    S = SERVE["max_seq"]
    for label, lens, (hq, hkv, d) in (
            ("main", rng.integers(100, 385, 8), (Hq, Hkv, D)),
            ("moonshot", rng.integers(100, 385, 8), (16, 16, 128)),
            ("zamba2", rng.integers(100, 385, 8), ZAMBA_HEADS),
            ("idle", [0, 1, 700, 1024, 0, 64, 65, 3], (Hq, Hkv, D))):
        B = len(lens)
        q, k, v = rnd(B, 1, hq, d), rnd(B, S, hkv, d), rnd(B, S, hkv, d)
        ln = i32(lens)
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])
        mask = mask[:, None, None, :]
        lib = (lambda q=q, k=k, v=v, m=mask: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m, enable_gqa=True))
        old = lambda q=q, k=k, v=v, ln=ln: _cuda_core_decode(q, k, v, ln)
        n = int(np.sum(lens))
        cases.append((
            "flash_decode", label,
            lambda q=q, k=k, v=v, ln=ln: fd.flash_decode(q, k, v, ln),
            lambda q=q, k=k, v=v, ln=ln: fd.decode_ref(q, k, v, ln),
            lib if label in TIMED else None,
            old if label in TIMED else None,
            2 * q.numel() * el + 2 * n * hkv * d * el + 4 * B,
            4 * d * hq * n))

    # paged_decode: the engine's pool (8 slots x 64 blocks of 16 tokens),
    # scrambled tables (tinyllama's heads and moonshot's); edge: idle slot
    # and garbage entries past each allocation.
    MB = S // BLOCK
    NB = SERVE["max_slots"] * MB
    for label, lens, garbage, (hq, hkv, d) in (
            ("main", rng.integers(100, 385, 8), False, (Hq, Hkv, D)),
            ("moonshot", rng.integers(100, 385, 8), False, (16, 16, 128)),
            ("zamba2", rng.integers(100, 385, 8), False, ZAMBA_HEADS),
            ("idle+garbage", [0, 17, 1024, 300, 0, 16, 1, 999], True,
             (Hq, Hkv, D))):
        B = len(lens)
        q = rnd(B, 1, hq, d)
        kp, vp = rnd(NB, BLOCK, hkv, d), rnd(NB, BLOCK, hkv, d)
        bt = i32(_tables(rng, lens, MB, NB, garbage))
        ln = i32(lens)
        kg, vg = pd._gather(kp, bt, B), pd._gather(vp, bt, B)
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])
        mask = mask[:, None, None, :]
        lib = (lambda q=q, k=kg, v=vg, m=mask: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m, enable_gqa=True))
        old = (lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln: _cuda_core_decode(
            q, kp, vp, ln, bt))
        n = int(np.sum(lens))
        nblk = sum(-(-int(L) // BLOCK) for L in lens)
        cases.append((
            "paged_decode", label,
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln: pd.paged_decode(
                q, kp, vp, bt, ln),
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln: pd.paged_decode_ref(
                q, kp, vp, bt, ln),
            lib if label in TIMED else None,
            old if label in TIMED else None,
            2 * q.numel() * el + 2 * n * hkv * d * el + 4 * (B + nblk),
            4 * d * hq * n))

    # paged_prefill: one 64-token chunk of a long prompt (main path:
    # chunked prefill with prefill_chunk=64), block-aligned offset
    # (tinyllama's heads, and moonshot-v1-16b-a3b's 16/16 heads of 128);
    # edges: mid-block offset, a one-token chunk, a padded tail (window
    # shorter than the chunk), garbage entries, and a sequence of length 0
    # whose rows see no key (exact zeros).
    for label, offs, Sq, tails, garbage, (hq, hkv, d) in (
            ("main", [128], CHUNK, [0], False, (Hq, Hkv, D)),
            ("moonshot", [128], CHUNK, [0], False, (16, 16, 128)),
            ("zamba2", [128], CHUNK, [0], False, ZAMBA_HEADS),
            ("midblock", [37, 200], 50, [0, 0], False, (Hq, Hkv, D)),
            ("one-token", [300, 5], 1, [0, 0], True, (Hq, Hkv, D)),
            ("padded-tail", [16, 90], 24, [9, 9], True, (Hq, Hkv, D)),
            ("idle-seq", [0, 40], 24, [24, 0], True, (Hq, Hkv, D))):
        B = len(offs)
        lens = [o + Sq - t for o, t in zip(offs, tails)]
        q = rnd(B, Sq, hq, d)
        kp, vp = rnd(NB, BLOCK, hkv, d), rnd(NB, BLOCK, hkv, d)
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
        old = (lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln, off=off:
               _cuda_core_prefill(q, kp, vp, bt, ln, off))
        vis = sum(max(0, min(L, o + i + 1)) for o, L in zip(offs, lens)
                  for i in range(Sq))
        keys = sum(lens)
        cases.append((
            "paged_prefill", label,
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln, off=off:
                pd.paged_prefill(q, kp, vp, bt, ln, off),
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln, off=off:
                pd.paged_prefill_ref(q, kp, vp, bt, ln, off),
            lib if label in TIMED else None,
            old if label in TIMED else None,
            2 * q.numel() * el + 2 * keys * hkv * d * el
            + 4 * (3 * B + sum(-(-L // BLOCK) for L in lens)),
            4 * d * hq * vis))
    return cases


def phase_kernels():
    """Hold every kernel against its plain version; returns the main-path
    numbers of each kernel (bf16)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        for (name, label, kern, plain, lib, old, nbytes,
             flops) in kernel_cases(dtype_name, rng):
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{name}/{label}/{dtype_name}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= TOL[dtype_name]
            if label in ("idle", "idle+garbage", "idle-seq"):
                # idle slots (length 0) must be exact zeros
                idle = got.float().reshape(got.shape[0], -1).abs().amax(1)
                slots = [0] if name == "paged_prefill" else [0, 4]
                ok = ok and bool((idle[slots] == 0).all())
            log(f"[kernels] {name:15s} {label:12s} {dtype_name:8s} "
                f"max_abs_err {err:.3e} (tol {TOL[dtype_name]:g}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"{name}/{label}/{dtype_name} disagrees with its "
                     f"plain version: {err}")
            if label not in TIMED or dtype_name != "bfloat16":
                continue
            bound_b = nbytes / PEAK_BYTES * 1e3
            bound_f = flops / PEAK_FLOPS[dtype_name] * 1e3
            ms, eager = time_ms(kern)
            (plain_ms, plain_eager), (lib_ms, lib_eager) = (
                time_ms(plain), time_ms(lib))
            row = dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=max(bound_b, bound_f),
                bound_by="bytes" if bound_b >= bound_f else "operations",
                library_ms=lib_ms,
            )
            if label == "main":
                rows[name] = row
            log(f"[kernels] {name:15s} {label:8s} kernel_ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B, "
                f"{flops} flop); issued eagerly: kernel {eager:.4f} "
                f"plain {plain_eager:.4f} library {lib_eager:.4f} ms")
            if old is not None:
                old_err = (old().float() - want.float()).abs().max().item()
                old_ms, old_eager = time_ms(old)
                log(f"[kernels] {name:15s} {label:8s} the CUDA-core kernel "
                    f"it replaced for bf16: {old_ms:.4f} ms (eagerly "
                    f"{old_eager:.4f}), max_abs_err {old_err:.3e}; the "
                    f"new kernel takes {ms / old_ms:.3f} of its time")
    rows["ssd_chunked"] = kernel_ssd(rng)
    rows["gmm"] = kernel_gmm(rng)
    return rows


# The mamba2-130m prefill: one 256-token bucket, 24 heads of 64, state
# 128, chunks of 64 (the chunk mamba_fwd asks for); and the 1024-token
# bucket a prompt of 769-1024 tokens takes at max_seq 1024 (16 chunks).
SSD_MAIN = dict(Bt=1, T=256, H=24, P=64, N=128)
SSD_LONG = dict(SSD_MAIN, T=1024)
# zamba2-7b's Mamba2 layer on its 256-token bucket: d_inner 7168 in 112
# heads of 64, state 64.
SSD_ZAMBA = dict(SSD_MAIN, H=112, N=64)
SSD_CHUNK = 64


def _ssd_inputs(rng, dtype, Bt, T, H, P, N):
    """x, dt, A, B, C distributed as mamba_fwd makes them at init:
    dt = softplus(normal), A = -exp(small normal)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(DEVICE)
    return (f(Bt, T, H, P).to(dtype), F.softplus(f(Bt, T, H)),
            -torch.exp(0.5 * f(H)), f(Bt, T, N), f(Bt, T, N))


def _ssd_err(got, want, rel):
    """(max |got - want|, largest share of its element's limit used):
    limit = rel * |want| + 1e-4 * max(1, max |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = rel * want.abs() + 1e-4 * max(1.0, want.abs().max().item())
    return err.max().item(), (err / limit).max().item()


def _ssd_bounds(args, y, h, chunk):
    """(bytes, f32 flops, bytes bound ms, ops bound ms, which ops bound):
    each input read once, y and h written once; the causal half of C B^T
    (L(L+1)/2 entries) once per chunk (one B/C group), then per head and
    chunk the masked product with dt x (lower triangle), C h_in and the
    state update. The operations bound is the lower of those flops at the
    CUDA cores' f32 rate and, as the kernel computes them, three bf16
    passes (bf16x3) at the tensor cores' rate."""
    x = args[0]
    Bt, T, H, P = x.shape
    N = args[3].shape[-1]
    L = min(chunk, T)
    nck = T // L
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y, h))
    flops = (2 * Bt * nck * (L * (L + 1) // 2) * N
             + Bt * H * nck * (L * (L + 1) * P + 4 * L * N * P))
    f32 = flops / PEAK_FLOPS["float32"] * 1e3
    tc3 = 3 * flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (nbytes, flops, nbytes / PEAK_BYTES * 1e3, min(f32, tc3),
            "bf16x3 at the bf16 rate" if tc3 < f32 else "f32")


def kernel_ssd(rng):
    """ssd_chunked against ssd_chunked_ref at the main shape, the 1024-token
    bucket and the edge cases (and against the sequential ssd_ref at the
    main shape), in both dtypes of x; logs each case's launch plan; times
    both buckets beside the first version of the kernel
    (ssd_chunked_loop_kernel). Returns the main shape's row of the
    summary."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_ssd as ms

    cases = (("main", "bfloat16", SSD_MAIN, SSD_CHUNK),
             ("f32-x", "float32", SSD_MAIN, SSD_CHUNK),
             ("two-rows", "bfloat16", dict(SSD_MAIN, Bt=2, T=128), SSD_CHUNK),
             ("short-T", "bfloat16", dict(SSD_MAIN, T=24), SSD_CHUNK),
             ("short-T", "float32", dict(SSD_MAIN, T=24), SSD_CHUNK),
             ("T1024", "bfloat16", SSD_LONG, SSD_CHUNK),
             ("T1024", "float32", SSD_LONG, SSD_CHUNK),
             ("chunk16-N256", "bfloat16", dict(SSD_MAIN, N=256), 16),
             ("chunk16-N256", "float32", dict(SSD_MAIN, N=256), 16),
             ("two-rows-512", "bfloat16", dict(SSD_MAIN, Bt=2, T=512),
              SSD_CHUNK),
             ("zamba2", "bfloat16", SSD_ZAMBA, SSD_CHUNK),
             ("zamba2", "float32", SSD_ZAMBA, SSD_CHUNK))
    row = None
    for label, dtype_name, shp, chunk in cases:
        args = _ssd_inputs(rng, getattr(torch, dtype_name), **shp)
        kern = lambda a=args, c=chunk: ms.ssd_chunked(*a, chunk=c)
        plain = lambda a=args, c=chunk: ms.ssd_chunked_ref(*a, chunk=c)
        (y, h), (yr, hr) = kern(), plain()
        wants = [("ssd_chunked_ref", yr, hr)]
        if label == "main":
            wants.append(("ssd_ref", *ms.ssd_ref(*args)))
        torch.cuda.synchronize()
        Bt, T, H, P, N = (shp[k] for k in ("Bt", "T", "H", "P", "N"))
        L = min(chunk, T)
        c, pt, per, grid = _build.ssd_plan(Bt, T, H, P, N, L)
        log(f"[kernels] ssd_chunked     {label:12s} {dtype_name:8s} x "
            f"({Bt}, {T}, {H}, {P}) N {N} chunk {L}: plan c {c}, pt {pt}, "
            f"up to {per} chunks a block, grid {grid} = "
            f"{grid[0] * grid[1] * grid[2]} blocks")
        if not (torch.isfinite(y.float()).all() and torch.isfinite(h).all()):
            fail(f"ssd_chunked/{label}/{dtype_name}: non-finite output")
        for ref_name, yw, hw in wants:
            (ey, ry), (eh, rh) = (_ssd_err(y, yw, SSD_REL[dtype_name]),
                                  _ssd_err(h, hw, 0.0))
            ok = ry <= 1.0 and rh <= 1.0
            log(f"[kernels] ssd_chunked     {label:12s} {dtype_name:8s} "
                f"vs {ref_name}: y max_abs_err {ey:.3e}, {ry:.3f} of its "
                f"limit ({SSD_REL[dtype_name]:g} x |want| + 1e-4 x max); "
                f"h max_abs_err {eh:.3e}, {rh:.3f} of its limit (1e-4 x "
                f"max) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"ssd_chunked/{label}/{dtype_name} disagrees with "
                     f"{ref_name}: y {ey}, h {eh}")
        if label not in ("main", "T1024", "zamba2") or \
                dtype_name != "bfloat16":
            continue
        # The first version of the kernel (chunks in order, CUDA cores),
        # replaced: held to the same limits, timed in the same run.
        old = lambda a=args: ms._launch(*a, SSD_CHUNK, loop=True)
        yo, ho = old()
        torch.cuda.synchronize()
        (_, roy), (_, roh) = (_ssd_err(yo, yr, SSD_REL[dtype_name]),
                              _ssd_err(ho, hr, 0.0))
        if roy > 1.0 or roh > 1.0:
            fail(f"ssd_chunked_loop_kernel/{label} disagrees with "
                 f"ssd_chunked_ref: y {roy}, h {roh}")
        nbytes, flops, bound_b, bound_f, ops_by = _ssd_bounds(
            args, y, h, SSD_CHUNK)
        ms_k, eager = time_ms(kern)
        ms_p, plain_eager = time_ms(plain)
        ms_o, old_eager = time_ms(old)
        bound = max(bound_b, bound_f)
        by = "bytes" if bound_b >= bound_f else "operations"
        log(f"[kernels] ssd_chunked     {label}: kernel_ms {ms_k:.4f} "
            f"plain_ms {ms_p:.4f} library_ms none (no single PyTorch call "
            f"computes the SSD scan) bound_ms {bound:.5f} ({by}: {nbytes} "
            f"B at {PEAK_BYTES:g} B/s = {bound_b:.5f} ms; {flops} f32 flop "
            f"= {flops / PEAK_FLOPS['float32'] * 1e3:.5f} ms at "
            f"{PEAK_FLOPS['float32']:g}/s, or as bf16x3 "
            f"{3 * flops / PEAK_FLOPS['bfloat16'] * 1e3:.5f} ms at "
            f"{PEAK_FLOPS['bfloat16']:g}/s: {ops_by}); issued eagerly: "
            f"kernel {eager:.4f} plain {plain_eager:.4f} ms")
        log(f"[kernels] ssd_chunked     {label}: the first version of its "
            f"kernel (ssd_chunked_loop_kernel) {ms_o:.4f} ms (eagerly "
            f"{old_eager:.4f}), within its limits (y {roy:.3f}, h "
            f"{roh:.3f}); the new kernel takes {ms_k / ms_o:.3f} of its "
            f"time")
        if label == "main":
            row = dict(
                name="ssd_chunked", route="cuda",
                source=SOURCES["ssd_chunked"],
                replaces=REPLACES["ssd_chunked"], launches=0,
                max_abs_err=(y.float() - yr.float()).abs().max().item(),
                ms=ms_k, plain_ms=ms_p, bound_ms=bound, bound_by=by,
                library_ms=None)
    # The chunk contract (JAX's): a ragged last chunk raises.
    args = _ssd_inputs(rng, torch.bfloat16, **dict(SSD_MAIN, T=100))
    try:
        ms.ssd_chunked(*args, chunk=SSD_CHUNK)
    except ValueError as e:
        log(f"[kernels] ssd_chunked     ragged-T     T=100, chunk 64 "
            f"raises as it must: {e}")
    else:
        fail("ssd_chunked accepted a ragged last chunk")
    return row


# The moonshot-v1-16b-a3b MoE layer's grouped products: 64 experts, d_model
# 2048, d_ff 1408; cap 1 row per expert at decode (8 slots x top-6), 30 for
# a 256-token prefill bucket (capacity factor 1.25).
MOE = "moonshot-v1-16b-a3b"
GMM_E, GMM_D, GMM_F = 64, 2048, 1408
GMM_CAPS = {"decode": 1, "prefill": 30}
# Experts that keep a row at decode once the MoE layer packs its capacity
# buffer by expert (about 9.5 of 64 a layer at 8 slots with random weights).
GMM_COMPACT = 10


def _gmm_inputs(rng, dtype, sizes, T, D, F):
    import numpy as np
    import torch

    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(DEVICE)
    x = f(T, D).to(dtype)
    w = (f(len(sizes), D, F) / D ** 0.5).to(dtype)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=DEVICE)


def kernel_gmm(rng):
    """gmm against gmm_ref at the MoE layer's decode and prefill shapes
    (wg / wi: D 2048 -> F 1408; wo: 1408 -> 2048), at decode's compact
    groups (GMM_COMPACT experts of one row, the others empty, zero rows
    after them) and an uneven case (empty groups, a tail past the last
    group), bf16 and f32, under the SSD check's element-wise rule. Times
    the bf16 shapes beside gmm_ref and, at equal group sizes, torch.bmm on
    (E, cap, D) x (E, D, F), which computes the same function; no PyTorch
    call skips the empty groups of the compact case. The bytes bound counts
    the weights of the experts with a row only. Returns the row of the
    decode shape in which every expert has its row."""
    import numpy as np
    import torch

    from repro_torch.kernels.moe_gmm import gmm, gmm_ref

    E = GMM_E
    uneven = [int(n) for n in rng.integers(0, 41, E) * (rng.random(E) < .8)]
    compact = [0] * E
    for e in rng.choice(E, GMM_COMPACT, replace=False):
        compact[int(e)] = 1
    # (label, sizes, T, D, F, timed, rows an expert for torch.bmm or None)
    cases = []
    for label, cap in GMM_CAPS.items():
        cases.append((label, [cap] * E, E * cap, GMM_D, GMM_F, True, cap))
        cases.append((label + "-wo", [cap] * E, E * cap, GMM_F, GMM_D, True,
                      cap))
    cases.append(("compact", compact, E, GMM_D, GMM_F, True, None))
    cases.append(("compact-wo", compact, E, GMM_F, GMM_D, True, None))
    cases.append(("uneven", uneven, sum(uneven) + 37, GMM_D, GMM_F, False,
                  None))
    row = None
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for label, sizes, T, D, F, timed, cap in cases:
            x, w, gs = _gmm_inputs(rng, dt, sizes, T, D, F)
            kern = lambda a=(x, w, gs): gmm(*a)
            # the plain version reads the sizes on the host: give it a host
            # copy, so that a CUDA graph can capture it
            plain = lambda a=(x, w, gs.cpu()): gmm_ref(*a)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                fail(f"gmm/{label}/{dtype_name}: non-finite output")
            err, share = _ssd_err(got, want, SSD_REL[dtype_name])
            total = min(sum(sizes), T)
            tail_zero = bool((got[total:] == 0).all())
            ok = share <= 1.0 and tail_zero
            log(f"[kernels] gmm             {label:12s} {dtype_name:8s} "
                f"T={T} D={D} F={F} E={E}: max_abs_err {err:.3e}, "
                f"{share:.3f} of its limit ({SSD_REL[dtype_name]:g} x |want| "
                f"+ 1e-4 x max); {T - total} rows past the groups "
                f"{'zero' if tail_zero else 'NOT ZERO'} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"gmm/{label}/{dtype_name} disagrees with gmm_ref: {err}")
            if dtype_name != "bfloat16" or not timed:
                continue
            el = x.element_size()
            used = sum(1 for n in sizes if n > 0)   # experts whose w is read
            nbytes = (x.numel() + used * D * F) * el + 4 * E + T * F * el
            flops = 2 * total * D * F        # the rows this input routes
            bound_b = nbytes / PEAK_BYTES * 1e3
            bound_f = flops / PEAK_FLOPS[dtype_name] * 1e3
            ms_k, eager = time_ms(kern)
            ms_p, plain_eager = time_ms(plain)
            if cap is not None:
                lib = lambda x=x, w=w, c=cap: torch.bmm(x.view(E, c, -1), w)
                ms_l, lib_eager = time_ms(lib)
                lib_note = (f"library_ms {ms_l:.4f} (torch.bmm, eagerly "
                            f"{lib_eager:.4f})")
            else:
                lib_note = "library_ms none (no call skips empty groups)"
            log(f"[kernels] gmm             {label:12s} {used} experts read: "
                f"kernel_ms {ms_k:.4f} plain_ms {ms_p:.4f} {lib_note} "
                f"bound_ms {max(bound_b, bound_f):.5f} ("
                f"{'bytes' if bound_b >= bound_f else 'operations'}: "
                f"{nbytes} B, {flops} flop); issued eagerly: kernel "
                f"{eager:.4f} plain {plain_eager:.4f} ms")
            if label == "decode":
                row = dict(
                    name="gmm", route="cuda", source=SOURCES["gmm"],
                    replaces=REPLACES["gmm"], launches=0, max_abs_err=err,
                    ms=ms_k, plain_ms=ms_p, bound_ms=max(bound_b, bound_f),
                    bound_by="bytes" if bound_b >= bound_f else "operations",
                    library_ms=ms_l)
    return row


# ------------------------------------------------------------ phase 3b
# Requests served in each engine mode (tinyllama's N_REQ).
MOE_N_REQ = N_REQ
# moonshot's 48 layers cut to 24, so that the whole run ends within its
# time (PERF.md §6)
MOE_LAYERS = 24
# The attention kernels each engine mode runs, beside gmm.
MOE_MODE_KERNELS = {
    "contiguous": ("flash_attention", "flash_decode"),
    "paged": ("flash_attention", "paged_decode"),
    "paged+prefix+chunk": ("paged_prefill", "paged_decode"),
}
# A full-width bf16 MoE layer, kernel path vs plain path: routing is the
# same on both (it precedes gmm), but the gate, up and down products and
# the combine each round to bf16, so an output carries a few bf16 ulps of
# the output's scale from the one-ulp differences of the gmm outputs. Held
# element by element to 2^-6 |want| + 2^-6 max |want| (two ulps of the
# value and two of the largest output); f32 to the SSD rule.
MOE_LAYER_ABS = {"bfloat16": 2.0 ** -6, "float32": 1e-4}


def phase_moe():
    """moonshot-v1-16b-a3b at full width, its depth cut to MOE_LAYERS:
    serve, profile, parity. Returns each kernel's launches over the three
    serving runs."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(ARCHS[MOE], n_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    params = init_lm(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts of "
        f"d_ff {cfg.d_ff}, top-{cfg.top_k}, capacity factor "
        f"{cfg.capacity_factor}, vocab {cfg.vocab}; "
        f"{cfg.param_count() / 1e9:.2f} B parameters, {cfg.dtype}: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, made "
        f"there in {time.time() - t0:.1f} s")
    totals = {name: 0 for name in ops.kernel_launches()}
    for mode, kw in MODES.items():
        reqs = _requests(np.random.default_rng(1), cfg.vocab, n=MOE_N_REQ)
        eng = Engine(cfg, params, device=DEVICE, **SERVE, **kw)
        torch.cuda.synchronize()
        ops.reset_launches()               # counts of this run only
        t0 = time.time()
        n = _serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = ops.kernel_launches()
        if not all(r.done for r in reqs):
            fail(f"moe {mode}: {sum(not r.done for r in reqs)} requests "
                 f"unfinished after {n} steps")
        for r in reqs:
            if not r.out or min(r.out) < 0 or max(r.out) >= cfg.vocab:
                fail(f"moe {mode}: request {r.rid} emitted bad ids")
        st = eng.stats()
        toks = st["tokens_out"]
        log(f"[moe] {mode}: {len(reqs)} requests, {toks} tokens in "
            f"{wall:.2f} s = {toks / wall:.1f} tok/s; TTFT p50 "
            f"{st['ttft_ms_p50']:.1f} ms p99 {st['ttft_ms_p99']:.1f} ms; "
            f"{st['host_syncs'] / toks:.4f} host syncs/token; "
            f"{st['steps']} engine steps; launches {counts}")
        for name in ("gmm",) + MOE_MODE_KERNELS[mode]:
            if counts[name] <= 0:
                fail(f"moe {mode}: kernel {name} was never launched")
        for name, c in counts.items():
            totals[name] += c
        del eng
    log(f"[moe] launches over the three runs: {totals}")
    _moe_profile(cfg, params)
    _moe_parity(cfg, params)
    log(f"[moe] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB; freeing the weights")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _moe_profile(cfg, params):
    """One engine step of contiguous decode with every slot busy (8 token
    iterations per slot) on the host clock, another under torch.profiler:
    device busy share and gmm's share of the device time. Then one more
    decode step's routing statistics: the share of routed slots dropped."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward
    from repro_torch.models.moe import capacity
    from repro_torch.serve import Engine

    eng = Engine(cfg, params, device=DEVICE, **SERVE)
    for r in _requests(np.random.default_rng(4), cfg.vocab,
                       n=SERVE["max_slots"]):
        r.max_new = 128                # nobody finishes inside the window
        eng.submit(r)
    eng.step()                         # admits every slot; warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    eng.step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.step()
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) * 1e3
    busy = kern = attn = 0.0
    records = n_gmm = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        records += 1
        if any(k in e.name for k in GMM_KERNELS):
            kern += ms
            n_gmm += 1
        elif any(k in e.name for k in ATTENTION_KERNELS):
            attn += ms
    if records == 0 or n_gmm == 0:
        fail(f"moe profile: torch.profiler recorded {records} kernels, "
             f"{n_gmm} of them gmm")
    log(f"[moe] contiguous decode, {SERVE['max_slots']} busy slots: "
        f"{wall:.2f} ms per engine step ({SERVE['steps_per_sync']} tokens "
        f"per slot) on the host clock; profiled step {wall_prof:.2f} ms: "
        f"device busy {busy:.2f} ms = {100 * busy / wall:.1f}% of the step "
        f"({100 * busy / wall_prof:.1f}% of the profiled one) in "
        f"{records} records; gmm {kern:.2f} ms in {n_gmm} launches "
        f"= {100 * kern / busy:.1f}% of the device time "
        f"({kern / n_gmm * 1e3:.1f} us each); attention kernels {attn:.2f}"
        f" ms")
    # Routing statistics of one decode iteration of the 8 busy slots.
    lens = torch.as_tensor(eng.lens, device=DEVICE)
    toks = torch.as_tensor(eng.tokens, device=DEVICE)
    with torch.inference_mode():
        _, _, aux = forward(params, cfg, toks, cache=eng.cache,
                            cache_len=lens, mode="decode")
    routed = cfg.n_layers * SERVE["max_slots"] * cfg.top_k
    dropped = float(aux["dropped"])
    log(f"[moe] one decode iteration at {SERVE['max_slots']} slots: "
        f"capacity {capacity(SERVE['max_slots'], cfg)} slot(s) per expert "
        f"per layer, {dropped:.0f} of "
        f"{routed} routed slots dropped = {100 * dropped / routed:.1f}% "
        f"(the reference's capacity factor {cfg.capacity_factor})")


def _moe_parity(cfg, params):
    """Kernel path vs plain path for the MoE family."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import init_lm
    from repro_torch.models.glb_moe import (glb_expert_rebalance,
                                            permute_expert_params)
    from repro_torch.models.moe import moe_fwd
    from repro_torch.serve import Engine

    # (a) f32 smoke config: greedy tokens, kernel vs plain, every mode, at
    # capacity 8.0 (dropless) and the config's own 1.25.
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    base = cfg.smoke()
    sparams = init_lm(base, gen, device=DEVICE)
    kw = dict(max_slots=4, max_seq=128, pad_len=32, steps_per_sync=4)
    modes = dict(MODES, paged=dict(paged=True, block_size=8))
    modes["paged+prefix+chunk"] = dict(paged=True, block_size=8,
                                       prefix_cache=True, prefill_chunk=16,
                                       token_budget=32)
    for factor in (8.0, base.capacity_factor):
        for mode, mkw in modes.items():
            outs = []
            for impl in ("auto", "ref"):
                c = _impl_cfg(dataclasses.replace(base,
                                                  capacity_factor=factor),
                              impl)
                rng = np.random.default_rng(2)
                reqs = [_smoke_req(rng, i) for i in range(8)]
                _serve(Engine(c, sparams, device=DEVICE, **kw, **mkw), reqs)
                if not all(r.done for r in reqs):
                    fail(f"moe parity {mode}/{impl}: unfinished requests")
                outs.append([r.out for r in reqs])
            same = outs[0] == outs[1]
            log(f"[parity] f32 smoke {base.name} capacity {factor} {mode}: "
                f"kernel vs plain greedy tokens "
                f"{'identical' if same else 'DIFFER'}")
            if not same:
                fail(f"MoE greedy tokens differ between kernel and plain "
                     f"path ({mode}, capacity {factor})")

    # (b) one full-width MoE layer, kernel vs plain, element by element,
    # at the prefill bucket and at decode; bf16 weights, and the same
    # weights in f32.
    p = params["blocks"][0]["moe"]
    rng = np.random.default_rng(8)
    counts = None
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        lp = {k: v.to(dt) for k, v in p.items()}
        for B, S in ((1, SERVE["pad_len"]), (SERVE["max_slots"], 1)):
            x = torch.from_numpy(rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)).to(DEVICE, dt)
            with torch.inference_mode():
                y, aux = moe_fwd(lp, x, cfg)
                yr, auxr = moe_fwd(lp, x, _impl_cfg(cfg, "ref"))
            torch.cuda.synchronize()
            same_routing = all(torch.equal(aux[k], auxr[k]) for k in
                               ("expert_counts", "dropped"))
            err = (y.float() - yr.float()).abs()
            big = yr.float().abs().max().item()
            limit = (SSD_REL[dtype_name] * yr.float().abs()
                     + MOE_LAYER_ABS[dtype_name] * max(1.0, big))
            share = (err / limit).max().item()
            ok = (share <= 1.0 and same_routing
                  and bool(torch.isfinite(y.float()).all()))
            log(f"[parity] {cfg.name} one MoE layer {dtype_name} x ({B}, "
                f"{S}, {cfg.d_model}), capacity {aux['capacity']}: routing "
                f"{'identical' if same_routing else 'DIFFERS'} "
                f"({float(aux['dropped']):.0f} slots dropped); y "
                f"max_abs_err {err.max().item():.3e} vs max |y| {big:.3e}, "
                f"{share:.3f} of its limit {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"{cfg.name}: full-width MoE layer differs between "
                     f"kernel and plain path ({dtype_name}, {B}x{S})")
            if counts is None:
                counts, x0, y0 = aux["expert_counts"], x, y
        del lp

    # (c) the full-width last-position logits.
    _logit_parity(cfg, params)

    # (d) the GLB expert rebalancer on the card: the layer's counts over 8
    # ranks; the permuted layer (and, in case the rebalancer leaves the
    # placement as it was, a random placement too) must give the
    # unpermuted layer's output bit for bit: every row meets the same
    # weights in the same kernel, and the combine adds in the same order.
    ranks = 8
    perm0 = np.arange(cfg.n_experts)
    res = glb_expert_rebalance(counts.cpu().numpy(), perm0, n_ranks=ranks)
    log(f"[parity] GLB expert rebalance of one layer's counts over {ranks} "
        f"ranks: loads {res.loads_before.tolist()} -> "
        f"{res.loads_after.tolist()} in {len(res.swaps)} swaps")
    for name, perm in (("rebalanced", res.perm),
                       ("random", rng.permutation(cfg.n_experts))):
        moved = permute_expert_params({k: p[k] for k in ("wg", "wi", "wo")},
                                      perm0, perm)
        with torch.inference_mode():
            y1, _ = moe_fwd(dict(p, **moved), x0, cfg,
                            expert_perm=torch.as_tensor(perm, device=DEVICE))
        same = torch.equal(y1, y0)
        log(f"[parity] {name} placement ({int((perm != perm0).sum())} "
            f"experts moved): layer output "
            f"{'identical' if same else 'DIFFERS'} (max_abs_err "
            f"{(y1.float() - y0.float()).abs().max().item():.3e})")
        if not same:
            fail(f"the permuted MoE layer ({name}) does not compute the "
                 "same output")


# ------------------------------------------------------------ phase 3c
# Moonlight-16B-A3B's attention at its benchmark cell's shapes (the docqa
# traffic on 64 slots): the expanded prefill (qk 192, v 128, 16 heads)
# of a median prompt (3,072 tokens) and the longest (7,712), and one
# decode iteration of 64 slots whose windows span the cell's (1,224 to
# 7,821 keys) over the pool of latent rows (576 wide, values its first
# 512, blocks of 16). Then a served run at Moonlight's widths, its depth
# cut to MLA_LAYERS, whose launches the two kernels must account for.
MLA_HEADS, MLA_QK, MLA_V = 16, 192, 128
MLA_DK, MLA_DV = 576, 512
MLA_PROMPTS = (3072, 7712)
MLA_SLOTS, MLA_WINDOWS = 64, (1224, 7821)
MLA_LAYERS = 4                  # one dense layer, three routed
MLA_SERVE = dict(max_slots=8, max_seq=8192, pad_len=8064, steps_per_sync=8,
                 paged=True, block_size=BLOCK)
MLA_N_REQ = 12
MLA_SOURCES = {"flash_attention": "src/repro_torch/csrc/attention_tc.cu",
               "mla_paged_decode": "src/repro_torch/csrc/mla_decode.cu"}


def _mla_cases(rng):
    """(kernel, label, kernel fn, plain fn, library fn or None, bytes,
    flops) at the cell's shapes, bf16; the bytes read each input once and
    write the output once, the flops count each (query, visible key)
    pair's two products."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md

    el = 2
    rnd = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(DEVICE, torch.bfloat16)
    H = MLA_HEADS
    cases = []
    for S in MLA_PROMPTS:
        q, k = rnd(1, S, H, MLA_QK), rnd(1, S, H, MLA_QK)
        v = rnd(1, S, H, MLA_V)
        lib = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True))
        cases.append((
            "flash_attention", f"prefill {S}",
            lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: fa.attention_ref(q, k, v, causal=True),
            lib, el * S * H * (2 * MLA_QK + 2 * MLA_V),
            2 * H * (MLA_QK + MLA_V) * S * (S + 1) // 2))
    mb = 8192 // BLOCK
    scale = 1.0 / math.sqrt(MLA_QK)
    for label, idle in (("decode 64 slots", False),
                        ("decode, an idle slot", True)):
        lens = rng.integers(MLA_WINDOWS[0], MLA_WINDOWS[1] + 1, MLA_SLOTS)
        lens[:2] = MLA_WINDOWS
        if idle:
            lens[3] = 0
        nb = sum(-(-int(n) // BLOCK) for n in lens)
        pool = rnd(nb + 8, BLOCK, MLA_DK)
        bt = torch.as_tensor(_tables(rng, [int(n) for n in lens], mb,
                                     nb + 8), device=DEVICE)
        ln = torch.as_tensor(lens.astype(np.int32), device=DEVICE)
        q = rnd(MLA_SLOTS, H, MLA_DK)
        kw = dict(v_dim=MLA_DV, scale=scale)
        n = int(lens.sum())
        cases.append((
            "mla_paged_decode", label,
            lambda q=q, p=pool, bt=bt, ln=ln: md.mla_paged_decode(
                q, p, bt, ln, **kw),
            lambda q=q, p=pool, bt=bt, ln=ln: md.mla_paged_decode_ref(
                q, p, bt, ln, **kw),
            None, el * (MLA_SLOTS * H * (MLA_DK + MLA_DV) + n * MLA_DK)
            + 4 * (MLA_SLOTS + nb), 2 * H * (MLA_DK + MLA_DV) * n))
    return cases


def kernel_mla(rng):
    """The MLA kernels against their plain versions at the cell's shapes;
    returns the rows of the timed shapes (the longest prompt for
    ``flash_attention``)."""
    import torch

    rows = {}
    for name, label, kern, plain, lib, nbytes, flops in _mla_cases(rng):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name}/{label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= TOL["bfloat16"]
        if "idle" in label:
            ok = ok and bool((got[3] == 0).all())   # an idle slot: zeros
        log(f"[mla] {name:16s} {label:20s} max_abs_err {err:.3e} (tol "
            f"{TOL['bfloat16']:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name}/{label} disagrees with its plain version: {err}")
        if "idle" in label:
            continue
        bound_b = nbytes / PEAK_BYTES * 1e3
        bound_f = flops / PEAK_FLOPS["bfloat16"] * 1e3
        ms, eager = time_ms(kern)
        plain_ms, plain_eager = time_ms(plain)
        lib_ms, lib_eager = time_ms(lib) if lib is not None else (None,
                                                                   None)
        row = dict(
            name=name, shape=label, route="cuda", source=MLA_SOURCES[name],
            replaces=None, launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(bound_b, bound_f),
            bound_by="bytes" if bound_b >= bound_f else "operations",
            library_ms=lib_ms)
        rows[name] = row
        lib_txt = (f"library_ms {lib_ms:.4f} (eagerly {lib_eager:.4f}) "
                   if lib is not None else "")
        log(f"[mla] {name:16s} {label:20s} kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} {lib_txt}bound_ms {row['bound_ms']:.5f} "
            f"({row['bound_by']}: {nbytes} B, {flops} flop); issued "
            f"eagerly: kernel {eager:.4f} plain {plain_eager:.4f} ms")
    return rows


def _mla_requests(rng, vocab, n=MLA_N_REQ):
    from repro_torch.serve import Request

    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        1, vocab, int(rng.integers(1224, 7713)))],
        max_new=int(rng.integers(9, 110))) for i in range(n)]


def phase_mla():
    """The MLA kernels at the Moonlight cell's shapes, then a served run
    at Moonlight's widths (MLA_LAYERS deep) through ``Engine(paged=True)``
    with the launch counts reset just before it: ``flash_attention``
    launches once a layer an admission, ``mla_paged_decode`` once a layer
    a decode iteration, ``gmm`` three times a routed layer a forward.
    Returns the two kernels' rows with those launches."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import init_lm
    from repro_torch.models.config import MLAConfig
    from repro_torch.serve import Engine

    rows = kernel_mla(np.random.default_rng(0))
    torch.cuda.empty_cache()
    cfg = MLAConfig(
        name="moonlight-16b-a3b", family="moe", n_layers=MLA_LAYERS,
        d_model=2048, n_heads=MLA_HEADS, n_kv_heads=MLA_HEADS, d_ff=11264,
        vocab=163840, rope_theta=50000.0, norm_eps=1e-5,
        tie_embeddings=False, n_experts=64, top_k=6, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        moe_d_ff=1408, n_shared_experts=2, first_k_dense=1,
        routed_scale=2.446, dtype="bfloat16")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm(cfg, gen, device=DEVICE)
    for blk in params["blocks"][1:]:
        blk["moe"]["router_bias"].normal_(0.0, 0.02, generator=gen)
    eng = Engine(cfg, params, device=DEVICE, **MLA_SERVE)
    reqs = _mla_requests(np.random.default_rng(2), cfg.vocab)
    loops = [0]
    decode_n = eng._decode_n

    def counted(*a):
        loops[0] += 1
        return decode_n(*a)

    eng._decode_n = counted
    torch.cuda.synchronize()
    ops.reset_launches()               # counts of this run only
    t0 = time.time()
    n = _serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.kernel_launches()
    if not all(r.done for r in reqs):
        fail(f"mla: {sum(not r.done for r in reqs)} requests unfinished "
             f"after {n} steps")
    for r in reqs:
        if not r.out or min(r.out) < 0 or max(r.out) >= cfg.vocab:
            fail(f"mla: request {r.rid} emitted bad ids")
    st = eng.stats()
    adm = int(st["admissions"])
    iters = loops[0] * MLA_SERVE["steps_per_sync"]
    want = {"flash_attention": adm * MLA_LAYERS,
            "mla_paged_decode": iters * MLA_LAYERS,
            "gmm": 3 * (MLA_LAYERS - 1) * (adm + iters)}
    log(f"[mla] served {len(reqs)} requests ({adm} admissions of 1,224-"
        f"7,712 tokens, {int(st['tokens_out'])} tokens out) at Moonlight's "
        f"widths, {MLA_LAYERS} layers, in {wall:.2f} s over {n} engine "
        f"steps ({iters} decode iterations); launches {counts}")
    for name, c in want.items():
        if counts[name] != c:
            fail(f"mla: {name} launched {counts[name]} times, not {c}")
    for name in ("paged_decode", "flash_decode", "paged_prefill"):
        if counts[name]:
            fail(f"mla: {name} launched on the latent path")
    for name in rows:
        rows[name]["launches"] = counts[name]
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return [rows["flash_attention"], rows["mla_paged_decode"]]


def _impl_cfg(cfg, impl):
    """cfg with every kernel knob set to ``auto`` (the kernels) or ``ref``
    (the plain versions)."""
    import dataclasses

    return dataclasses.replace(cfg, attn_impl=impl, decode_impl=impl,
                               moe_impl="ref" if impl == "ref" else "auto")


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
    totals = {name: 0 for name in ATTENTION}
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
        for name in ATTENTION:
            totals[name] += counts[name]
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
    admit_ms = []
    for r in _requests(np.random.default_rng(4), cfg.vocab,
                       n=SERVE["max_slots"]):
        r.max_new = 128                # nobody finishes inside the window
        eng.submit(r)
        torch.cuda.synchronize()       # one admission at a time, timed
        t0 = time.time()
        with torch.inference_mode():
            eng._admit()
        torch.cuda.synchronize()
        admit_ms.append((time.time() - t0) * 1e3)
    eng.step()                         # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / 2 * 1e3
    _service_times(admit_ms, wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
    kinds = dict.fromkeys(KINDS, 0.0)
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / 2
        kinds[_kind(e.name)] += ms
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 0.5, t + ms)
        count += 1
    busy = sum(kinds.values())
    log(f"[profile] contiguous decode, {SERVE['max_slots']} busy slots: "
        f"{wall:.2f} ms per engine step ({SERVE['steps_per_sync']} tokens "
        f"per slot) on the host clock")
    if count == 0:
        fail("profile: torch.profiler recorded no kernel of the decode step")
    log(f"[profile] device busy {busy:.2f} ms per step = "
        f"{100 * busy / wall:.1f}% of the step; {count / 2:.0f} device "
        f"records per step; by kind (ms per step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"[profile]   {ms:8.3f} ms {n:6.0f}x per step  {name[:90]}")


def _service_times(admit_ms, step_ms):
    """The card's own service times beside ``CostParams``' defaults (the
    reference's policy constants, which the port keeps): µs per prefill
    token from single admissions of a full bucket, and µs per decode
    token from steady decode steps with every slot busy."""
    import numpy as np

    from repro_torch.serve import CostParams

    cp = CostParams()
    pre = float(np.median(admit_ms)) * 1e3 / SERVE["pad_len"]
    per_seq = step_ms * 1e3 / SERVE["steps_per_sync"]
    log(f"[service] tinyllama-1.1b contiguous engine, host clock: an "
        f"admission ({SERVE['pad_len']}-token bucket) median "
        f"{np.median(admit_ms):.2f} ms of {len(admit_ms)} = {pre:.1f} us "
        f"per prefill token (CostParams.us_per_prefill_token "
        f"{cp.us_per_prefill_token:g}); a decode step {step_ms:.2f} ms = "
        f"{per_seq:.1f} us per decode token of one sequence at "
        f"{SERVE['max_slots']} busy slots (CostParams.us_per_decode_token "
        f"{cp.us_per_decode_token:g}), "
        f"{per_seq / SERVE['max_slots']:.1f} us per token of the batch")


# ------------------------------------------------------------ phase 5
def _fabric(cfg, params, reqs, kw, block_size):
    """Two replicas, 0 contiguous and 1 paged, every request on 0."""
    from repro_torch.serve import Engine, GLBReplicaBalancer

    engines = [Engine(cfg, params, replica_id=0, device=DEVICE, **kw),
               Engine(cfg, params, replica_id=1, device=DEVICE, paged=True,
                      block_size=block_size, **kw)]
    bal = GLBReplicaBalancer(engines)
    for r in reqs:
        bal.submit(r, rr=0)                 # tier-1 steals must happen
    return bal


def phase_fabric():
    """mamba2-130m at full width through the 2-replica GLB fabric."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import init_lm

    cfg = ARCHS["mamba2-130m"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[fabric] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.ssm_heads} SSM heads of {cfg.ssm_headdim}, state "
        f"{cfg.ssm_state}, {cfg.param_count() / 1e6:.1f} M parameters, "
        f"{cfg.dtype}")
    reqs = _requests(np.random.default_rng(5), cfg.vocab)
    bal = _fabric(cfg, params, reqs, SERVE, BLOCK)
    torch.cuda.synchronize()
    ops.reset_launches()                    # counts of this run only
    t0 = time.time()
    status = bal.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.kernel_launches()
    if status != "terminated":
        fail(f"fabric: run() returned {status!r}")
    if not all(r.done for r in reqs):
        fail(f"fabric: {sum(not r.done for r in reqs)} requests unfinished")
    for r in reqs:
        if not r.out or min(r.out) < 0 or max(r.out) >= cfg.vocab:
            fail(f"fabric: request {r.rid} emitted bad ids")
    if bal.queue_moves <= 0:
        fail("fabric: no tier-1 steal happened")
    n = counts["ssd_chunked"]
    if n <= 0 or n % cfg.n_layers or n < cfg.n_layers * len(reqs):
        fail(f"fabric: ssd_chunked launched {n} times, want "
             f"{cfg.n_layers} per admission for {len(reqs)} requests")
    if any(counts[name] for name in ATTENTION):
        fail(f"fabric: an attention kernel ran on an ssm model: {counts}")
    st = bal.merged_metrics().snapshot()
    toks = sum(e.tokens_out for e in bal.engines)
    log(f"[fabric] {len(reqs)} requests, {toks} tokens in {wall:.2f} s = "
        f"{toks / wall:.1f} tok/s; TTFT p50 {st['ttft_ms_p50']:.1f} ms p99 "
        f"{st['ttft_ms_p99']:.1f} ms; engine steps per replica "
        f"{[e.steps for e in bal.engines]}; {bal.supersteps} supersteps; "
        f"{len(bal.decisions)} steal decisions, {bal.queue_moves} requests "
        f"moved: {bal.decisions}; tokens per replica "
        f"{[e.tokens_out for e in bal.engines]}; run() {status!r}")
    log(f"[fabric] launches {counts}: {n // cfg.n_layers} admissions x "
        f"{cfg.n_layers} layers")
    return params, n


def phase_prefill_profile(params):
    """One admission of the mamba2-130m engine (a 256-token bucket through
    24 layers): host time of one admission, then another under
    torch.profiler, whose kernel records give ssd_chunked's share of that
    admission's device time and of its own host time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.serve import Engine

    cfg = ARCHS["mamba2-130m"]
    eng = Engine(cfg, params, device=DEVICE, **SERVE)
    reqs = _requests(np.random.default_rng(6), cfg.vocab, n=3)

    def admit(req):                     # prefill into the next free slot
        eng.submit(req)
        with torch.inference_mode():
            eng._admit()
        torch.cuda.synchronize()

    admit(reqs[0])                      # warm-up
    t0 = time.time()
    admit(reqs[1])
    wall = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        admit(reqs[2])
        wall_prof = (time.time() - t0) * 1e3
    busy = ssd = 0.0
    n_ssd = records = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        records += 1
        if "ssd_chunked_kernel" in e.name:
            ssd += ms
            n_ssd += 1
    log(f"[fabric] one admission (prefill of a {SERVE['pad_len']}-token "
        f"bucket, {cfg.n_layers} layers): {wall:.2f} ms on the host clock")
    if records == 0 or n_ssd == 0:
        fail(f"admission profile: torch.profiler recorded {records} kernels, "
             f"{n_ssd} of them ssd_chunked")
    log(f"[fabric] profiled admission (another request): {wall_prof:.2f} "
        f"ms on the host clock under the profiler; device busy {busy:.3f} "
        f"ms in {records} records; ssd_chunked {ssd:.3f} ms in {n_ssd} "
        f"launches = {100 * ssd / busy:.1f}% of its device time, "
        f"{100 * ssd / wall_prof:.1f}% of its host time")


# ------------------------------------------------------------ phase 5b
# Live KV migration (balancer tier 2), replica faults, predictive
# balancing, the SLO monitor and the flight recorder, on tinyllama-1.1b at
# full width: two paged replicas on the one card sharing phase 4's weights.
MIGRATE = dict(SERVE, paged=True, block_size=BLOCK, prefix_cache=True,
               prefill_chunk=CHUNK)
MIG_N_REQ = 8
# Replica 1's pool in run (a): the fewest blocks an engine takes (one
# full-length sequence, 64 blocks), so that the balancer's first pass
# lands some sequences live and then runs out of room for the next,
# which lands radix-seeded.
MIG_POOL1 = SERVE["max_seq"] // BLOCK
MIG_PATH = ("flash_attention", "paged_decode", "paged_prefill")
# Run (a)'s balancer gives work only from a victim with two units or more
# (the paper's min_give), so that the one sequence landed radix-seeded
# waits on replica 1 for its planted prefix instead of going straight
# back to replica 0, which its departure left hungry.
TIER2 = dict(min_give=2)


def _mig_requests(rng, vocab, n=MIG_N_REQ, max_new=(48, 97)):
    """Prompts of 244-256 tokens (a full bucket) behind a shared 64-token
    system prompt, so that a sequence has 17-19 blocks written when it
    migrates."""
    from repro_torch.serve import Request

    system = [int(t) for t in rng.integers(1, vocab, 64)]
    return [Request(rid=i, prompt=system + [
                int(t) for t in rng.integers(1, vocab,
                                             int(rng.integers(180, 193)))],
                    max_new=int(rng.integers(*max_new)))
            for i in range(n)]


def _saturate(engine, extra=2, guard=64):
    """Step replica 0 until every request it holds is decoding (its queue
    empty, no slot mid-prefill), then ``extra`` steps more: the balancer
    can then move only live sequences."""
    while engine.queue or any(engine.sched.mid_prefill(i)
                              for i in range(engine.max_slots)):
        engine.step()
        guard -= 1
        if guard == 0:
            fail("migrate: replica 0 never finished admitting its requests")
    for _ in range(extra):
        engine.step()


class _MigrationWatch:
    """Wraps the replicas' migrate_out / migrate_in / step to check and
    time every migration of a run: the gathered buffer equals the
    victim's pool blocks and, for a live landing, the thief's blocks at
    the injected table, bit for bit; its size is the written blocks times
    the bytes of a block; pack and land times on the host clock (ending
    in a synchronize); and the kernels each replica launches after its
    first landing."""

    def __init__(self, bal):
        self.pack_ms, self.land_ms = [], []
        self.modes, self.bytes, self.checked = [], [], 0
        self.landed = set()
        self.after = {e.replica_id: {} for e in bal.engines}
        for e in bal.engines:
            self._wrap(e)

    @staticmethod
    def block_bytes(e):
        k = e.cache["k"]
        return 2 * k.shape[0] * k[0, 0].numel() * k.element_size()

    @staticmethod
    def _timed(fn, times):
        """``fn()``, timed on the host clock (ending in a synchronize)
        into ``times``."""
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    def _wrap(self, e):
        import torch

        from repro_torch.kernels import ops

        out0, in0, step0 = e.migrate_out, e.migrate_in, e.step

        def migrate_out(slot):
            rid = e.slots[slot].rid
            blocks = e.pool.extract(rid)[0]
            mig = self._timed(lambda: out0(slot), self.pack_ms)
            nb = -(-mig.written // e.block_size)
            got = sum(b.nbytes for b in mig.kv.values())
            if got != nb * self.block_bytes(e) or len(blocks) != nb:
                fail(f"migrate: request {rid} shipped {got} bytes, want "
                     f"{nb} written blocks x {self.block_bytes(e)}")
            self.bytes.append(got)
            for n, buf in mig.kv.items():
                # the victim's freed blocks still hold what was gathered
                if not torch.equal(e.cache[n][:, blocks].cpu(), buf):
                    fail(f"migrate: the {n} buffer of request {rid} is not "
                         "the victim's blocks")
            return mig

        def migrate_in(mig):
            mode = self._timed(lambda: in0(mig), self.land_ms)
            self.modes.append(mode)
            if mode == "live":
                nb = mig.kv["k"].shape[1]
                table = e.pool.block_table(mig.req.rid)[:nb]
                for n, buf in mig.kv.items():
                    if not torch.equal(e.cache[n][:, table].cpu(), buf):
                        fail(f"migrate: replica {e.replica_id}'s {n} "
                             f"blocks {table} are not the transfer buffer "
                             f"of request {mig.req.rid}")
                self.checked += 1
            if mode in ("live", "seeded"):
                self.landed.add(e.replica_id)
            return mode

        def step():
            if e.replica_id not in self.landed:
                return step0()
            before = ops.kernel_launches()
            step0()
            for k, v in ops.kernel_launches().items():
                d = self.after[e.replica_id]
                d[k] = d.get(k, 0) + v - before[k]

        e.migrate_out, e.migrate_in, e.step = migrate_out, migrate_in, step


def _profile_migrations(cfg, weights, n=4):
    """The device work of ``n`` live migrations of one 17-block sequence
    between two fresh paged replicas (back and forth, each landing live),
    in one torch.profiler session that a throwaway ~1 ms kernel opens
    (the tracer can miss the records of its first moments). Returns
    ({kind: [ms per migration, records]}, bytes per migration): gather
    kernels (``index_select`` runs as a gather kernel on the card) and
    device->host copies of migrate_out; host->device copies (the buffer
    and both sides' block ids) and scatter kernels (``index_copy_``, an
    indexing kernel) of migrate_in. Each kind is averaged over the
    records it has, so that a record the tracer missed does not count as
    zero time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine

    engines = [Engine(cfg, weights, replica_id=i, device=DEVICE, **MIGRATE)
               for i in range(2)]
    req = _mig_requests(np.random.default_rng(10), cfg.vocab, n=1,
                        max_new=(200, 201))[0]
    engines[0].submit(req)
    _saturate(engines[0])
    nbytes = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if DEVICE == "cuda":
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        for i in range(n):
            src, dst = engines[i % 2], engines[1 - i % 2]
            mig = src.migrate_out(src.migratable_slots()[0])
            nbytes.append(sum(b.nbytes for b in mig.kv.values()))
            if dst.migrate_in(mig) != "live":
                fail("migrate: a profiled migration did not land live")
        torch.cuda.synchronize()
    per = {"gather": 2, "d2h": 2, "h2d": 4, "scatter": 2}   # a migration
    split = {k: [0.0, 0] for k in per}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.name.lower()
        kind = ("h2d" if "htod" in name else "d2h" if "dtoh" in name else
                "gather" if "gather" in name else
                "scatter" if "index" in name else None)
        if kind:
            split[kind][0] += ev.time_range.elapsed_us() / 1e3
            split[kind][1] += 1
    if any(v[1] < n for v in split.values()) or len(set(nbytes)) != 1:
        fail(f"migrate: the profiled migrations recorded {split}, bytes "
             f"{nbytes}")
    return {k: [v[0] / v[1] * per[k], v[1]] for k, v in split.items()}, \
        nbytes[0]


def _quantiles(xs):
    import numpy as np

    return float(np.percentile(xs, 50)), float(np.percentile(xs, 99))


def _mig_fabric(cfg, weights, reqs, pool1=None, migrate=True, kw=MIGRATE,
                params=None, **bkw):
    """Two paged replicas on the card sharing ``weights``, every request on
    replica 0, which admits them all before the balancer's first pass."""
    from repro_torch.core import GLBParams
    from repro_torch.serve import Engine, GLBReplicaBalancer

    engines = [Engine(cfg, weights, replica_id=i, device=DEVICE,
                      num_blocks=pool1 if i else None,
                      tracer=bkw.get("tracer"), **kw) for i in range(2)]
    bal = GLBReplicaBalancer(engines, GLBParams(**(params or {})),
                             migrate=migrate, **bkw)
    for r in reqs:
        bal.submit(r, rr=0)
    _saturate(engines[0])
    return bal


def _finish(tag, bal, reqs, vocab):
    status = bal.run()
    if status != "terminated":
        fail(f"migrate {tag}: run() returned {status!r}")
    if not all(r.done for r in reqs):
        fail(f"migrate {tag}: {sum(not r.done for r in reqs)} requests "
             "unfinished")
    for r in reqs:
        if not r.out or min(r.out) < 0 or max(r.out) >= vocab:
            fail(f"migrate {tag}: request {r.rid} emitted bad ids")


def phase_migrate(params):
    """tinyllama-1.1b at full width through two paged replicas: (a) tier 2
    with live and radix-seeded landings, (b) a replica crash, (c)
    predictive balancing with the SLO monitor and the flight recorder.
    Returns the launches of the path's kernels over the three runs."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.obs import (FlightRecorder, SLOMonitor, Tracer,
                                 parse_slo_spec, validate_chrome_trace)
    from repro_torch.obs.analyze import analyze_trace, check_invariants
    from repro_torch.serve import CostModel, FaultInjector

    cfg = ARCHS["tinyllama-1.1b"]
    launches = {name: 0 for name in MIG_PATH}

    def count(tag):
        c = ops.kernel_launches()
        for name in MIG_PATH:
            launches[name] += c[name]
        log(f"[migrate] {tag} launches {c}")

    # (a) tier 2: live landings until replica 1's pool is full, then a
    # radix-seeded one.
    reqs = _mig_requests(np.random.default_rng(7), cfg.vocab)
    bal = _mig_fabric(cfg, params, reqs, pool1=MIG_POOL1, params=TIER2)
    watch = _MigrationWatch(bal)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.time()
    _finish("(a)", bal, reqs, cfg.vocab)
    torch.cuda.synchronize()
    wall = time.time() - t0
    count("(a)")
    modes = bal.migration_modes
    e0, e1 = bal.engines
    log(f"[migrate] (a) {len(reqs)} requests on replica 0 (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, max_new "
        f"{min(r.max_new for r in reqs)}-{max(r.max_new for r in reqs)}), "
        f"admitted before the first pass; replica 1's pool "
        f"{MIG_POOL1} blocks of {BLOCK}, replica 0's "
        f"{e0.num_blocks}; {wall:.2f} s, {bal.supersteps} supersteps")
    log(f"[migrate] (a) decisions {bal.decisions}")
    log(f"[migrate] (a) landings {modes}: live {e1.migrations_in}, seeded "
        f"{e1.migrations_seeded} ({e1.prefix_cache.seeded_tokens} seeded "
        f"tokens), recompute {e1.migrations_recompute}; replica 1 "
        f"adoptions {e1.sched.adoptions}, cache hits "
        f"{e1.prefix_cache.hits}, preemptions {e1.sched.preemptions}")
    if modes["live"] < 1 or modes["seeded"] < 1:
        fail(f"migrate (a): want a live and a seeded landing, got {modes}")
    if watch.checked < 1:
        fail("migrate (a): no live landing was checked block for block")
    log(f"[migrate] (a) block identity: {watch.checked} live landings' "
        f"k/v blocks torch.equal to the transfer buffer, and "
        f"{len(watch.bytes)} buffers to the victim's blocks")
    bb = _MigrationWatch.block_bytes(e0)
    hist = bal.merged_metrics().histogram("migration_bytes")
    if hist.total != sum(watch.bytes) or hist.count != len(watch.bytes):
        fail(f"migrate (a): migration_bytes histogram {hist.total} over "
             f"{hist.count}, checked {sum(watch.bytes)} over "
             f"{len(watch.bytes)}")
    after = watch.after[1]
    log(f"[migrate] (a) replica 1 after its first landing launched "
        f"{ {k: v for k, v in after.items() if v} }; its radix cache "
        f"served {e1.prefix_cache.tokens_reused} tokens in "
        f"{e1.prefix_cache.hits} hits")
    for name in ("paged_decode", "paged_prefill"):
        if after.get(name, 0) <= 0:
            fail(f"migrate (a): {name} never launched on replica 1 after "
                 "a landing")
    p50, p99 = _quantiles(watch.pack_ms)
    l50, l99 = _quantiles(watch.land_ms)
    st = bal.merged_metrics().snapshot()
    log(f"[migrate] (a) {len(watch.bytes)} migrations, "
        f"{np.mean(watch.bytes) / 1e6:.3f} MB each on average "
        f"({bb} bytes a block, {min(watch.bytes)}-{max(watch.bytes)}); "
        f"migrate_pack_ms p50 {p50:.3f} p99 {p99:.3f}, migrate_land_ms p50 "
        f"{l50:.3f} p99 {l99:.3f} (host clock, each ending in a "
        f"synchronize; the engines' own histograms, bucketed: pack p50 "
        f"{st['migrate_pack_ms_p50']:.3f} p99 "
        f"{st['migrate_pack_ms_p99']:.3f}, land p50 "
        f"{st['migrate_land_ms_p50']:.3f} p99 "
        f"{st['migrate_land_ms_p99']:.3f})")
    split, nbytes = _profile_migrations(cfg, params)
    bound = 2 * nbytes / PEAK_BYTES * 1e3
    log(f"[migrate] (a) 4 live migrations of {nbytes} bytes between two "
        f"fresh replicas under torch.profiler, device ms a migration: "
        f"gather {split['gather'][0]:.4f} (2 kernels; bound {bound:.4f}: "
        f"2 x bytes / 3.35 TB/s), device->host {split['d2h'][0]:.4f} "
        f"({nbytes / split['d2h'][0] / 1e6:.1f} GB/s), host->device "
        f"{split['h2d'][0]:.4f}, both sides' block ids included "
        f"({nbytes / split['h2d'][0] / 1e6:.1f} GB/s), scatter "
        f"{split['scatter'][0]:.4f} (2 kernels; bound {bound:.4f}); "
        f"records { {k: v[1] for k, v in split.items()} }")
    mig_out = [list(r.out) for r in reqs]
    # The same traffic without tier 2 (replica 0 keeps everything): the
    # tokens are printed, not gated, since batch composition changes the
    # rounding of the bf16 matrix products.
    ref = _mig_requests(np.random.default_rng(7), cfg.vocab)
    _finish("(a) without migration",
            _mig_fabric(cfg, params, ref, pool1=MIG_POOL1, migrate=False,
                        params=TIER2),
            ref, cfg.vocab)
    same = sum(a == list(b.out) for a, b in zip(mig_out, ref))
    log(f"[migrate] (a) greedy tokens equal to a run without migration in "
        f"{same} of {len(ref)} requests (bf16; not gated)")

    # (b) replica 1 crashes at superstep 2, holding the sequences it
    # took at superstep 0; its running sequences come back to replica 0
    # as recompute resumes, prefilled in one bucket (flash_attention).
    plain = dict(SERVE, paged=True, block_size=BLOCK)
    reqs = _mig_requests(np.random.default_rng(8), cfg.vocab,
                         max_new=(32, 65))
    bal = _mig_fabric(cfg, params, reqs, kw=plain,
                      faults=FaultInjector().crash(1, at=2))
    torch.cuda.synchronize()
    ops.reset_launches()
    _finish("(b)", bal, reqs, cfg.vocab)
    torch.cuda.synchronize()
    count("(b)")
    log(f"[migrate] (b) crash of replica 1 at superstep 2: alive "
        f"{bal.alive}, dead {bal.replicas_dead}, re-admitted "
        f"{bal.readmitted_running} running / {bal.readmitted_queued} "
        f"queued; decisions {bal.decisions}; {bal.supersteps} supersteps")
    if bal.alive != [True, False] or bal.readmitted_running < 1:
        fail(f"migrate (b): alive {bal.alive}, "
             f"{bal.readmitted_running} running re-admitted")

    # (c) predictive balancing, an SLO monitor and a flight recorder far
    # smaller than the run's trace; then the same traffic under an
    # unbounded tracer through the analyzer.
    def run_c(tracer):
        reqs = _mig_requests(np.random.default_rng(9), cfg.vocab,
                             max_new=(32, 65))
        slo = SLOMonitor(parse_slo_spec("ttft_ms=5000,tpot_ms=200"))
        bal = _mig_fabric(cfg, params, reqs, cost_model=CostModel(),
                          predictive=True, slo=slo, tracer=tracer)
        torch.cuda.synchronize()
        ops.reset_launches()
        _finish("(c)", bal, reqs, cfg.vocab)
        torch.cuda.synchronize()
        if bal.diffusion_moves < 1:
            fail(f"migrate (c): no diffusion move ({bal.decisions})")
        return bal

    tracer = Tracer()
    run_c(tracer)                       # not counted: the analyzer's run
    a = analyze_trace(tracer)
    bad = check_invariants(a)
    moved = [r for r in a.requests if r.migrations]
    log(f"[migrate] (c) unbounded trace: {len(tracer.events)} events; "
        f"analyzer: {len(a.requests)} requests, max unattributed "
        f"{max(r.unattributed_frac for r in a.requests):.2e}, "
        f"{len(moved)} migrated, across pids "
        f"{sorted({tuple(r.replicas) for r in moved})}; violations {bad}")
    if bad or len(a.requests) != MIG_N_REQ or not moved or any(
            len(r.replicas) < 2 for r in moved):
        fail("migrate (c): the analyzer did not attribute and stitch the "
             "trace")
    capacity = len(tracer.events) // 8
    flight = FlightRecorder(capacity=capacity)
    bal = run_c(flight)
    count("(c)")
    dump = flight.dump()
    problems = validate_chrome_trace(dump)
    log(f"[migrate] (c) predictive: decisions {bal.decisions}; "
        f"{bal.diffusion_moves} diffusion moves; cost "
        f"{bal.collect()['_cost']}")
    for ln in bal.report().splitlines()[-4:]:
        log(f"[migrate] (c) {ln.strip()}")
    log(f"[migrate] (c) flight recorder: capacity {capacity} (an eighth of "
        f"the unbounded trace), {flight.dropped} events dropped, "
        f"{dump['otherData']['flight']['synthesized_opens']} opens "
        f"synthesized, validator problems {problems}")
    if problems or flight.dropped <= 0:
        fail(f"migrate (c): flight dump invalid or never wrapped "
             f"({problems[:3]}, dropped {flight.dropped})")
    for name, n in launches.items():
        if n <= 0:
            fail(f"migrate: kernel {name} was never launched on the path")
    log(f"[migrate] launches over (a), (b) and (c): {launches}")
    return launches


# ------------------------------------------------------------ phase 5c
# The rest of the model zoo at full width, one model on the card at a
# time: zamba2-7b (hybrid: 81 Mamba2 layers, one shared attention + MLP
# block applied 13 times, 32/32 heads of 112) through the engine in both
# cache layouts; mistral-nemo-12b (dense, 32/8 heads of 128) through the
# paged engine with the prefix cache and chunked prefill; qwen2-vl-2b
# (M-RoPE over merged embeddings) and musicgen-medium (4 codebooks)
# through lm.prefill and decode_step.
ZOO_HYBRID = "zamba2-7b"
ZOO_DENSE = "mistral-nemo-12b"
ZOO_VLM = "qwen2-vl-2b"
ZOO_AUDIO = "musicgen-medium"
ZOO_KERNELS = ("flash_attention", "flash_decode", "paged_decode",
               "paged_prefill", "ssd_chunked")
ZOO_HYBRID_MODES = {"contiguous": ("ssd_chunked", "flash_attention",
                                   "flash_decode"),
                    "paged": ("ssd_chunked", "flash_attention",
                              "paged_decode")}
ZOO_DECODE_STEPS = 32
ZOO_PROMPT = 256
# qwen2-vl's merged prompt: 64 text tokens, an image of 8 x 16 patches
# (128 tokens) at one temporal index, then 64 text tokens.
ZOO_IMAGE = dict(start=64, rows=8, cols=16)


def _zoo_weights(name):
    """init_lm at full width on the card from seed 0; logs the size."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_lm

    cfg = ARCHS[name]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.time()
    params = init_lm(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[zoo] {cfg.name} [{cfg.family}]: {cfg.n_layers} layers d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"{n / 1e9:.3f} B parameters made ({cfg.param_count() / 1e9:.2f} B "
        f"by param_count()), {cfg.dtype}: {nbytes / 1e9:.2f} GB of weights "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the "
        f"card in all), made there in {time.time() - t0:.1f} s")
    return cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _zoo_free(cfg, params):
    import gc

    import torch

    log(f"[zoo] {cfg.name}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; freeing the "
        "weights")
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _zoo_serve(cfg, params, tag, kw, want, totals):
    """16 requests through one engine; every request must finish with
    valid ids and every kernel of ``want`` must launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import Engine

    reqs = _requests(np.random.default_rng(1), cfg.vocab)
    eng = Engine(cfg, params, device=DEVICE, **SERVE, **kw)
    torch.cuda.synchronize()
    ops.reset_launches()                   # counts of this run only
    t0 = time.time()
    n = _serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.kernel_launches()
    if not all(r.done for r in reqs):
        fail(f"zoo {cfg.name} {tag}: {sum(not r.done for r in reqs)} "
             f"requests unfinished after {n} steps")
    for r in reqs:
        if not r.out or min(r.out) < 0 or max(r.out) >= cfg.vocab:
            fail(f"zoo {cfg.name} {tag}: request {r.rid} emitted bad ids")
    st = eng.stats()
    toks = st["tokens_out"]
    log(f"[zoo] {cfg.name} {tag}: {len(reqs)} requests, {toks} tokens in "
        f"{wall:.2f} s = {toks / wall:.1f} tok/s; TTFT p50 "
        f"{st['ttft_ms_p50']:.1f} ms p99 {st['ttft_ms_p99']:.1f} ms; "
        f"{st['steps']} engine steps; launches {counts}")
    for name in want:
        if counts[name] <= 0:
            fail(f"zoo {cfg.name} {tag}: kernel {name} was never launched")
    for name in ZOO_KERNELS:
        totals[name] += counts[name]
    return eng


# Device records by kind, as the profiles report them.
KINDS = ("ssd_chunked", "attention kernels", "matmul", "copies", "other")


def _kind(name):
    name = name.lower()
    if "ssd_chunked" in name:
        return "ssd_chunked"
    if any(k in name for k in ATTENTION_KERNELS):
        return "attention kernels"
    if any(s in name for s in ("gemm", "gemv", "splitk", "nvjet", "xmma",
                               "cutlass", "cublas")):
        return "matmul"
    if name.startswith(("memcpy", "memset")):
        return "copies"
    return "other"


def _zoo_profile(cfg, params):
    """One engine step of contiguous decode with every slot busy (8 token
    iterations a slot) on the host clock and another under
    torch.profiler: device busy and its shares by kind (a decode step runs
    the Mamba2 recurrence one token at a time, so ssd_chunked takes no
    part in it). Then one admission (a 256-token bucket) under the
    profiler: ssd_chunked's share of the prefill."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine

    eng = Engine(cfg, params, device=DEVICE, **SERVE)
    reqs = _requests(np.random.default_rng(4), cfg.vocab,
                     n=SERVE["max_slots"] + 1)
    for r in reqs[:-1]:
        r.max_new = 128                # nobody finishes inside the window
        eng.submit(r)
    eng.step()                         # admits every slot; warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    eng.step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3

    def kinds_of(prof):
        kinds = dict.fromkeys(KINDS, 0.0)
        records = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            kinds[_kind(e.name)] += e.time_range.elapsed_us() / 1e3
            records += 1
        return kinds, records

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.step()
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) * 1e3
    kinds, records = kinds_of(prof)
    busy = sum(kinds.values()) or float("nan")
    if records == 0 or kinds["attention kernels"] <= 0:
        fail(f"zoo {cfg.name} profile: {records} device records, "
             f"attention {kinds['attention kernels']} ms")
    log(f"[zoo] {cfg.name} contiguous decode, {SERVE['max_slots']} busy "
        f"slots: {wall:.2f} ms per engine step "
        f"({SERVE['steps_per_sync']} tokens per slot) on the host clock; "
        f"profiled step {wall_prof:.2f} ms: device busy {busy:.2f} ms = "
        f"{100 * busy / wall:.1f}% of the step in {records} records; by "
        "kind (ms per step, share of the device time): "
        + ", ".join(f"{k} {v:.3f} ({100 * v / busy:.1f}%)"
                    for k, v in kinds.items()))
    slot = next(i for i, r in enumerate(eng.slots) if r is not None)
    eng.slots[slot] = None             # free one slot for an admission
    eng.lens[slot] = -1
    eng.submit(reqs[-1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        with torch.inference_mode():
            eng._admit()
        torch.cuda.synchronize()
        wall_adm = (time.time() - t0) * 1e3
    kinds, records = kinds_of(prof)
    busy = sum(kinds.values()) or float("nan")
    if kinds["ssd_chunked"] <= 0:
        fail(f"zoo {cfg.name}: the profiled admission ran no ssd_chunked")
    log(f"[zoo] {cfg.name} one admission ({SERVE['pad_len']}-token "
        f"bucket) under the profiler: {wall_adm:.2f} ms on the host clock; "
        f"device busy {busy:.3f} ms in {records} records; by kind: "
        + ", ".join(f"{k} {v:.3f} ({100 * v / busy:.1f}%)"
                    for k, v in kinds.items()))


def _mrope_positions(S, a=ZOO_IMAGE["start"], rows=ZOO_IMAGE["rows"],
                     cols=ZOO_IMAGE["cols"]):
    """(1, S, 3) positions of a merged prompt: a text tokens, an image of
    rows x cols patches that share one temporal index and take their row
    and column on the h and w streams, then text from the image's
    largest index on."""
    import numpy as np

    n = rows * cols
    pos = np.zeros((1, S, 3), np.int32)
    pos[0, :a] = np.arange(a)[:, None]
    i = np.arange(n)
    pos[0, a:a + n] = np.stack([np.full(n, a), a + i // cols,
                                a + i % cols], axis=-1)
    pos[0, a + n:] = (a + max(rows, cols) + np.arange(S - a - n))[:, None]
    return pos


def _zoo_generate(cfg, params, batch, totals):
    """lm.prefill of ``batch`` and ZOO_DECODE_STEPS greedy decode_steps
    through the kernels, then the plain path fed the same inputs and
    tokens: the last-position logits of the prefill and of every decode
    step within 5% of the logit range; both paths' tokens printed.
    Returns the kernel path's launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, prefill

    K = cfg.n_codebooks
    shape = (1, 1, K) if K else (1, 1)
    max_seq = ZOO_PROMPT + ZOO_DECODE_STEPS
    logits, toks, argmax = {}, None, {}
    for impl in ("auto", "ref"):
        icfg = _impl_cfg(cfg, impl)
        ops.reset_launches()
        steps, own = [], []
        with torch.inference_mode():
            lg, cache = prefill(params, icfg, batch, max_seq)
            lg = lg[:, -1, ..., :cfg.vocab].float()
            for t in range(ZOO_DECODE_STEPS):
                steps.append(lg)
                own.append(lg.argmax(-1).reshape(-1).tolist())
                tok = (own[-1] if impl == "auto" else toks[t])
                lens = torch.full((1,), ZOO_PROMPT + t, dtype=torch.int32,
                                  device=DEVICE)
                lg, cache = decode_step(
                    params, icfg, torch.as_tensor(tok, dtype=torch.int32,
                                                  device=DEVICE).reshape(
                                                      shape), cache, lens)
                lg = lg[:, -1, ..., :cfg.vocab].float()
            steps.append(lg)
        torch.cuda.synchronize()
        if impl == "auto":
            counts = ops.kernel_launches()
            toks = own
        logits[impl], argmax[impl] = steps, own
    worst = 0.0
    for t, (a, b) in enumerate(zip(logits["auto"], logits["ref"])):
        if not torch.isfinite(a).all():
            fail(f"zoo {cfg.name}: non-finite logits at step {t}")
        share = (a - b).abs().max().item() / b.abs().max().item()
        worst = max(worst, share)
    agree = sum(x == y for x, y in zip(argmax["auto"], argmax["ref"]))
    log(f"[zoo] {cfg.name}: prefill of {ZOO_PROMPT} positions + "
        f"{ZOO_DECODE_STEPS} greedy decode steps; kernel vs plain (the "
        f"plain path fed the kernel path's tokens): largest last-position "
        f"logit error {100 * worst:.3f}% of max |logit| (tol 5%) "
        f"{'ok' if worst <= 0.05 else 'MISMATCH'}; argmax equal at "
        f"{agree} of {ZOO_DECODE_STEPS} steps; launches {counts}")
    log(f"[zoo] {cfg.name} kernel tokens: {argmax['auto']}")
    log(f"[zoo] {cfg.name} plain argmax: {argmax['ref']}")
    if worst > 0.05:
        fail(f"zoo {cfg.name}: kernel and plain logits disagree")
    for name in ZOO_KERNELS:
        totals[name] += counts[name]
    return counts


def phase_zoo():
    """zamba2-7b, mistral-nemo-12b, qwen2-vl-2b and musicgen-medium at full
    width, one at a time. Returns each kernel's launches over the zoo's
    serving and generation runs."""
    import numpy as np
    import torch

    totals = dict.fromkeys(ZOO_KERNELS, 0)

    # (a) zamba2-7b through the engine, contiguous and paged.
    cfg, params = _zoo_weights(ZOO_HYBRID)
    log(f"[zoo] {cfg.name}: {cfg.ssm_heads} SSM heads of "
        f"{cfg.ssm_headdim}, state {cfg.ssm_state}; the shared block after "
        f"layers {cfg.attn_every - 1}, {2 * cfg.attn_every - 1}, ...: "
        f"{cfg.n_layers // cfg.attn_every} applications, each on its own "
        "k/v cache layer")
    for mode, want in ZOO_HYBRID_MODES.items():
        kw = dict(paged=True, block_size=BLOCK) if mode == "paged" else {}
        _zoo_serve(cfg, params, mode, kw, want, totals)
    _zoo_profile(cfg, params)
    _mixer_parity(cfg, params)
    _zoo_free(cfg, params)

    # (b) mistral-nemo-12b: paged (whole prompts through flash_attention),
    # then paged with the prefix cache and 64-token chunks (every prompt
    # through paged_prefill).
    cfg, params = _zoo_weights(ZOO_DENSE)
    _zoo_serve(cfg, params, "paged", MODES["paged"],
               ("flash_attention", "paged_decode"), totals)
    _zoo_serve(cfg, params, "paged+prefix+chunk",
               MODES["paged+prefix+chunk"], ("paged_prefill",
                                             "paged_decode"), totals)
    _logit_parity(cfg, params)
    _zoo_free(cfg, params)

    # (c) qwen2-vl-2b: merged embeddings with three position streams.
    cfg, params = _zoo_weights(ZOO_VLM)
    rng = np.random.default_rng(8)
    emb = torch.from_numpy(rng.standard_normal(
        (1, ZOO_PROMPT, cfg.d_model)).astype(np.float32)).to(DEVICE)
    pos = torch.as_tensor(_mrope_positions(ZOO_PROMPT), device=DEVICE)
    c = _zoo_generate(cfg, params, {"embeds": emb, "positions": pos},
                      totals)
    if not (c["flash_attention"] and c["flash_decode"]):
        fail(f"zoo {cfg.name}: attention kernels not launched: {c}")
    _zoo_free(cfg, params)

    # (d) musicgen-medium: four codebook streams.
    cfg, params = _zoo_weights(ZOO_AUDIO)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (
        1, ZOO_PROMPT, cfg.n_codebooks)), dtype=torch.int32, device=DEVICE)
    c = _zoo_generate(cfg, params, {"tokens": toks}, totals)
    if not (c["flash_attention"] and c["flash_decode"]):
        fail(f"zoo {cfg.name}: attention kernels not launched: {c}")
    _zoo_free(cfg, params)
    log(f"[zoo] launches over the zoo's runs: {totals}")
    return totals


# ------------------------------------------------------------ phase 6
# The UTS path: P = 1024 places, each loop iteration expands one node per
# place at width n = 256 (gen_width 0).
UTS_MAIN = dict(M=1024, W=256)
# The paper's geometric tree (b0 4, r 19) cut from its smallest depth, 13
# (125,350,485 nodes, 207 s on one H100), to 12 (31,360,287 nodes).
UTS_TREE = dict(b0=4.0, depth=12, seed=19)
UTS_PARAMS = dict(n=256, w=2, steal_k=64)    # benchmarks/bench_uts.py uts_g
UTS_P = 1024
UTS_COMPARE_DEPTH = 8      # the kernel vs plain run (9 until the whole run
                           # grew past its time)
# uts_expand's int32 operations per lane: three fmix32 of 8 (3 shifts, 3
# xors, 2 multiplies), 7 to mix the index in, 32 compares and 32 adds.
UTS_OPS_PER_LANE = 95
PROFILE_STEPS = (200, 203)    # supersteps of the UTS run under the profiler


def _uts_inputs(rng, M, base_lo, base_hi, shuffle=False):
    """Descriptors with the high bit set (uint32 bits in int32), bases in
    [base_lo, base_hi), the thresholds of the b0 = 4 tree (with shuffle,
    in random order: a table that is not non-increasing)."""
    import numpy as np
    import torch

    from repro_torch.problems.uts import geom_thresholds

    bits = lambda: torch.from_numpy(
        (rng.integers(0, 2 ** 31, M, dtype=np.int64) | 2 ** 31)
        .astype(np.uint32).view(np.int32)).to(DEVICE)
    base = torch.from_numpy(
        rng.integers(base_lo, base_hi, M).astype(np.int32)).to(DEVICE)
    thr = geom_thresholds(4.0)
    if shuffle:
        thr = rng.permutation(thr)
    thr = torch.from_numpy(thr.view(np.int32)).to(DEVICE)
    return bits(), bits(), base, thr


def kernel_uts(rng):
    """uts_expand against uts_expand_ref, bit for bit, at the main shape
    and the edge cases (the first version of its kernel too, at the main
    shape); times the main shape beside that first version. Returns its
    row."""
    import torch

    from repro_torch.kernels import uts_expand as ue

    M, W = UTS_MAIN["M"], UTS_MAIN["W"]
    cases = (("main", M, W, 0, 32, False), ("M=1", 1, 8, 0, 32, False),
             ("ragged-M", 1000, 64, 0, 32, False),
             ("base~2^31", 77, 256, 2 ** 31 - 288, 2 ** 31 - 256, False),
             ("odd-W", 333, 37, 0, 32, False), ("W=3", 50, 3, 0, 32, False),
             ("unsorted", M, W, 0, 32, True))
    row = None
    for label, m, w, lo, hi, shuffle in cases:
        args = _uts_inputs(rng, m, lo, hi, shuffle)
        kern = lambda a=args, w=w: ue.uts_expand(*a, width=w)
        plain = lambda a=args, w=w: ue.uts_expand_ref(*a, w)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(g, x) for g, x in zip(got, want))
        log(f"[glb] uts_expand      {label:10s} M={m} W={w}: "
            f"{'bit-exact' if same else 'MISMATCH'} vs uts_expand_ref")
        if not same:
            fail(f"uts_expand/{label} differs from uts_expand_ref")
        if label != "main":
            continue
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *got))
        ops = UTS_OPS_PER_LANE * m * w
        bound_b = nbytes / PEAK_BYTES * 1e3
        bound_o = ops / PEAK_FLOPS["int32"] * 1e3
        ms_k, eager = time_ms(kern)
        ms_p, plain_eager = time_ms(plain)
        # the first version of the kernel (one thread a lane), replaced
        old = lambda a=args, w=w: ue._launch("repro_uts_expand_lane", *a, w)
        old_same = all(torch.equal(g, x) for g, x in zip(old(), want))
        old_ms, old_eager = time_ms(old)
        log(f"[glb] uts_expand      the first version of its kernel "
            f"(uts_expand_lane_kernel): {old_ms:.4f} ms (eagerly "
            f"{old_eager:.4f}), {'bit-exact' if old_same else 'MISMATCH'}; "
            f"the new kernel takes {ms_k / old_ms:.3f} of its time")
        if not old_same:
            fail("uts_expand_lane_kernel differs from uts_expand_ref")
        row = dict(
            name="uts_expand", route="cuda", source=SOURCES["uts_expand"],
            replaces=REPLACES["uts_expand"], launches=0, max_abs_err=max(
                (g.long() - x.long()).abs().max().item()
                for g, x in zip(got, want)),
            ms=ms_k, plain_ms=ms_p, bound_ms=max(bound_b, bound_o),
            bound_by="bytes" if bound_b >= bound_o else "operations",
            library_ms=None)
        log(f"[glb] uts_expand      kernel_ms {ms_k:.4f} plain_ms {ms_p:.4f} "
            f"library_ms none (no PyTorch call computes it) bound_ms "
            f"{row['bound_ms']:.5f} ({row['bound_by']}: {nbytes} B at "
            f"{PEAK_BYTES:g} B/s = {bound_b:.5f} ms, {ops} int32 ops "
            f"({UTS_OPS_PER_LANE} a lane) at {PEAK_FLOPS['int32']:g}/s = "
            f"{bound_o:.5f} ms); issued eagerly: kernel {eager:.4f} plain "
            f"{plain_eager:.4f} ms")
    return row


class _ProfileWindow:
    """A tracer for run_sim that records nothing but starts torch.profiler
    at the first superstep of ``steps`` and stops it after the last, to
    read the device's busy share over those supersteps."""

    enabled = True

    def __init__(self, steps):
        from torch.profiler import ProfilerActivity, profile

        self.first, self.last = steps
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.wall_ms = 0.0
        self._t0 = None

    def process_name(self, *a, **k):
        pass

    def thread_name(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def counter(self, *a, **k):
        pass

    def span(self, name, pid=0, args=None):
        import contextlib

        import torch

        step = args["n"]

        @contextlib.contextmanager
        def window():
            if step == self.first:
                torch.cuda.synchronize()
                self.prof.start()
                self._t0 = time.perf_counter()
            yield
            if step == self.last:
                torch.cuda.synchronize()
                self.wall_ms = (time.perf_counter() - self._t0) * 1e3
                self.prof.stop()
        return window()


def phase_glb():
    """The GLB task executor on the card: uts_expand, then UTS at the
    paper's size, fib, BC, and UTS through the kernel vs the plain
    expansion. Returns (uts_expand's row, its launches in the UTS run)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from repro_torch.core import GLB, GLBParams
    from repro_torch.kernels import ops
    from repro_torch.problems import bc, fib, rmat, uts

    row = kernel_uts(np.random.default_rng(7))

    # UTS at the paper's size. The sequential oracle is too slow at depth
    # 12, so the expected count is the breadth-first count of the same
    # tree, itself held to the oracle at depth 9 first.
    t0 = time.time()
    small = uts.uts_count_bfs(**dict(UTS_TREE, depth=9))
    if small != uts.uts_oracle(**dict(UTS_TREE, depth=9)):
        fail(f"uts_count_bfs disagrees with uts_oracle at depth 9: {small}")
    want = uts.uts_count_bfs(**UTS_TREE)
    log(f"[glb] UTS {UTS_TREE}: {want} nodes by the breadth-first count "
        f"(= uts_oracle at depth 9: {small}), {time.time() - t0:.1f} s")
    glb = GLB(uts.uts_problem(**UTS_TREE), GLBParams(**UTS_PARAMS),
              P=UTS_P, device=DEVICE)
    window = _ProfileWindow(PROFILE_STEPS)
    torch.cuda.synchronize()
    ops.reset_launches()                    # counts of this run only
    t0 = time.time()
    got = int(glb.run(seed=0, tracer=window))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.kernel_launches()["uts_expand"]
    S = glb.supersteps
    log(f"[glb] UTS on {UTS_P} places {UTS_PARAMS}: {got} nodes in "
        f"{wall:.2f} s = {got / wall:.0f} nodes/s; {S} supersteps; "
        f"superstep efficiency nodes / (supersteps x P x n) = "
        f"{got / (S * UTS_P * UTS_PARAMS['n']):.4f}; uts_expand launched "
        f"{launches} times ({launches / S:.1f} per superstep)")
    host = glb.last_run.host_ms
    log("[glb] host ms per superstep: " + ", ".join(
        f"{k} {v / S:.2f}" for k, v in host.items())
        + f"; the rest {(wall * 1e3 - sum(host.values())) / S:.2f}")
    if got != want:
        fail(f"UTS counted {got} nodes, want {want}")
    if launches <= 0:
        fail("uts_expand was never launched on the UTS run")
    busy, records, kern = 0.0, 0, 0.0
    for e in window.prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        records += 1
        if "uts_expand_kernel" in e.name:
            kern += ms
    n_prof = PROFILE_STEPS[1] - PROFILE_STEPS[0] + 1
    if records == 0:
        fail("UTS profile: torch.profiler recorded no kernel")
    log(f"[glb] supersteps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1]} under "
        f"torch.profiler: {window.wall_ms / n_prof:.2f} ms per superstep on "
        f"the host clock, device busy {busy / n_prof:.3f} ms "
        f"({100 * busy / window.wall_ms:.1f}%) in {records / n_prof:.0f} "
        f"records per superstep; uts_expand_kernel {kern / n_prof:.3f} ms "
        f"per superstep")

    # fib(24) through the default array bag, on 64 places.
    glb = GLB(fib.fib_problem(24), GLBParams(n=16, steal_k=16), P=64,
              device=DEVICE)
    t0 = time.time()
    got = int(glb.run(seed=0))
    log(f"[glb] fib(24) on 64 places: {got} (oracle {fib.fib_oracle(24)}) "
        f"in {glb.supersteps} supersteps, {time.time() - t0:.2f} s")
    if got != fib.fib_oracle(24):
        fail(f"fib(24) = {got}, want {fib.fib_oracle(24)}")

    # BC on an R-MAT graph of scale 10 (the exact oracle is O(N E) Python).
    adj, n = rmat.rmat_graph(scale=10, seed=7)
    t0 = time.time()
    oracle = rmat.brandes_bc_oracle(adj)
    t_oracle = time.time() - t0
    glb = GLB(bc.bc_problem(adj), GLBParams(n=8, steal_k=8), P=64,
              device=DEVICE)
    t0 = time.time()
    got = glb.run(seed=0)
    wall = time.time() - t0
    ok = np.allclose(got, oracle, rtol=1e-4, atol=1e-3)
    rel = float(np.max(np.abs(got - oracle) / np.maximum(np.abs(oracle),
                                                         1e-3)))
    log(f"[glb] BC R-MAT scale 10 ({n} vertices, {int(adj.sum())} edges) "
        f"on 64 places: {glb.supersteps} supersteps, {wall:.2f} s; max "
        f"relative error vs brandes_bc_oracle {rel:.3e} (rtol 1e-4, atol "
        f"1e-3) {'ok' if ok else 'MISMATCH'}; oracle {t_oracle:.1f} s")
    if not ok or not np.isfinite(got).all():
        fail("BC disagrees with the Brandes oracle")

    # The same UTS run through the kernel and through the plain expansion.
    runs = []
    compare = dict(UTS_TREE, depth=UTS_COMPARE_DEPTH)
    want = uts.uts_count_bfs(**compare)
    for impl in ("auto", "ref"):
        prob = uts.uts_problem(**compare, impl=impl)
        ops.reset_launches()
        glb = GLB(prob, GLBParams(**UTS_PARAMS), P=64, device=DEVICE)
        t0 = time.time()
        res = int(glb.run(seed=0))
        runs.append((res, glb.supersteps,
                     {k: v.tolist() for k, v in glb.stats.items()}))
        log(f"[glb] UTS depth {UTS_COMPARE_DEPTH} on 64 places, impl "
            f"{impl}: {res} nodes, "
            f"{glb.supersteps} supersteps, {time.time() - t0:.2f} s, "
            f"uts_expand launches {ops.kernel_launches()['uts_expand']}")
    same = runs[0] == runs[1]
    log(f"[glb] kernel vs plain expansion: result, supersteps and all "
        f"{len(runs[0][2])} counters {'identical' if same else 'DIFFER'}")
    if not same or runs[0][0] != want:
        fail("UTS through the kernel and the plain expansion differ")
    return row, launches


# ------------------------------------------------------------ phase 7
def phase_parity(params_full, mamba_full):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, GLBReplicaBalancer

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

    # (b) the mamba2 f32 smoke fabric (contiguous + paged replica, every
    # request on replica 0): kernel (ssd_chunked) vs plain (the
    # sequential ssd_ref) greedy tokens and steal decisions.
    base = ARCHS["mamba2-130m"].smoke()
    params = init_lm(base, gen, device=DEVICE)
    outs = []
    for impl in ("auto", "ref"):
        cfg = dataclasses.replace(base, attn_impl=impl, decode_impl=impl)
        rng = np.random.default_rng(2)
        reqs = [_smoke_req(rng, i) for i in range(8)]
        bal = _fabric(cfg, params, reqs, kw, 8)
        if bal.run() != "terminated" or not all(r.done for r in reqs):
            fail(f"parity mamba2 fabric/{impl}: did not finish")
        outs.append(([r.out for r in reqs], bal.decisions))
    same = outs[0] == outs[1]
    log(f"[parity] f32 smoke mamba2 fabric: kernel vs plain greedy tokens "
        f"and steal decisions {'identical' if same else 'DIFFER'} "
        f"({len(outs[0][1])} decisions)")
    if not same:
        fail("greedy tokens differ between kernel and plain path (mamba2 "
             "fabric)")

    # (c) a migrating tinyllama f32 smoke fabric (three paged replicas,
    # every request on replica 0, which admits them all first): kernel vs
    # plain greedy tokens and decisions, live landings included.
    base = ARCHS["tinyllama-1.1b"].smoke()
    params = init_lm(base, gen, device=DEVICE)
    mkw = dict(kw, paged=True, block_size=8, max_slots=2)
    outs = []
    for impl in ("auto", "ref"):
        cfg = dataclasses.replace(base, attn_impl=impl, decode_impl=impl)
        rng = np.random.default_rng(2)
        reqs = [_smoke_req(rng, i) for i in range(5)]
        engines = [Engine(cfg, params, replica_id=i, device=DEVICE, **mkw)
                   for i in range(3)]
        bal = GLBReplicaBalancer(engines, migrate=True)
        for r in reqs:
            bal.submit(r, rr=0)
        engines[0].step()
        if bal.run() != "terminated" or not all(r.done for r in reqs):
            fail(f"parity migrating fabric/{impl}: did not finish")
        outs.append(([r.out for r in reqs], bal.decisions))
    same = outs[0] == outs[1]
    live = sum(d[0] == "live" for d in outs[0][1])
    log(f"[parity] f32 smoke tinyllama migrating fabric: kernel vs plain "
        f"greedy tokens and decisions {'identical' if same else 'DIFFER'} "
        f"({len(outs[0][1])} decisions, {live} live steals: {outs[0][1]})")
    if not same or live < 1:
        fail("migrating fabric: kernel and plain paths differ, or no "
             "live steal happened")

    # (d) the zamba2 f32 smoke config at 4 layers, the shared block after
    # every second (k/v cache layers 0 and 1), in both engine modes:
    # kernel vs plain greedy tokens.
    base = dataclasses.replace(ARCHS["zamba2-7b"].smoke(), n_layers=4,
                               attn_every=2)
    params = init_lm(base, gen, device=DEVICE)
    for mode in ("contiguous", "paged"):
        outs = []
        for impl in ("auto", "ref"):
            cfg = dataclasses.replace(base, attn_impl=impl, decode_impl=impl)
            rng = np.random.default_rng(2)
            reqs = [_smoke_req(rng, i) for i in range(8)]
            eng = Engine(cfg, params, device=DEVICE, **kw, **modes[mode])
            _serve(eng, reqs)
            if not all(r.done for r in reqs):
                fail(f"parity zamba2 {mode}/{impl}: unfinished requests")
            outs.append([r.out for r in reqs])
        same = outs[0] == outs[1]
        log(f"[parity] f32 smoke zamba2 (4 layers, shared block every 2) "
            f"{mode}: kernel vs plain greedy tokens "
            f"{'identical' if same else 'DIFFER'}")
        if not same:
            fail(f"greedy tokens differ between kernel and plain path "
                 f"(zamba2 {mode})")

    # (e) the qwen2-vl and musicgen f32 smoke configs through lm.prefill
    # and decode_step: kernel vs plain greedy tokens.
    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(9)
    for name in ("qwen2-vl-2b", "musicgen-medium"):
        base = ARCHS[name].smoke()
        params = init_lm(base, gen, device=DEVICE)
        K, S = base.n_codebooks, 24
        if base.mrope:
            batch = {"embeds": torch.from_numpy(rng.standard_normal(
                (2, S, base.d_model)).astype(np.float32)).to(DEVICE),
                "positions": torch.as_tensor(np.repeat(
                    _mrope_positions(S, 4, 2, 4), 2, axis=0),
                    device=DEVICE)}
        else:
            batch = {"tokens": torch.as_tensor(rng.integers(
                0, base.vocab, (2, S, K)), dtype=torch.int32,
                device=DEVICE)}
        outs = []
        for impl in ("auto", "ref"):
            cfg = _impl_cfg(base, impl)
            with torch.inference_mode():
                lg, cache = prefill(params, cfg, batch, S + 16)
                toks = []
                for t in range(16):
                    tok = lg[:, -1, ..., :base.vocab].argmax(-1).to(
                        torch.int32)
                    toks.append(tok.tolist())
                    lg, cache = decode_step(
                        params, cfg, tok.reshape((2, 1, K) if K else (2, 1)),
                        cache, torch.full((2,), S + t, dtype=torch.int32,
                                          device=DEVICE))
            outs.append(toks)
        same = outs[0] == outs[1]
        log(f"[parity] f32 smoke {name} prefill + 16 greedy decode steps: "
            f"kernel vs plain tokens {'identical' if same else 'DIFFER'}")
        if not same:
            fail(f"greedy tokens differ between kernel and plain path "
                 f"({name})")

    # (f) full width, bf16: last-position prefill logits.
    _logit_parity(ARCHS["tinyllama-1.1b"], params_full)
    _logit_parity(ARCHS["mamba2-130m"], mamba_full)


def _logit_parity(cfg, params):
    """Kernel vs plain path on one 256-token prompt at full width, bf16:
    the last position's logits. Both paths round activations to bf16
    between layers, and 22-48 layers compound one-ulp differences: hold
    them to 5% of the logit range."""
    import numpy as np
    import torch

    from repro_torch.models import forward

    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (1, 256)),
                           dtype=torch.int32, device=DEVICE)
    lg = {}
    with torch.inference_mode():
        for impl in ("auto", "ref"):
            lg[impl] = forward(params, _impl_cfg(cfg, impl),
                               toks)[0][0, -1].float()
    if not torch.isfinite(lg["auto"]).all():
        fail(f"{cfg.name}: full-width prefill logits are not finite")
    err = (lg["auto"] - lg["ref"]).abs().max().item()
    scale = lg["ref"].abs().max().item()
    ok = err <= 0.05 * scale
    log(f"[parity] {cfg.name} full-width bf16 last-position logits: "
        f"max_abs_err {err:.4e} vs max |logit| {scale:.4e} (tol 5%) "
        f"{'ok' if ok else 'MISMATCH'}; argmax "
        f"{int(lg['auto'].argmax())} vs {int(lg['ref'].argmax())}")
    if not ok:
        fail(f"{cfg.name}: full-width prefill logits disagree")


def _mixer_parity(cfg, params):
    """Kernel vs plain path of the hybrid family at full width, bf16, on
    _logit_parity's prompt. At every layer, on the plain path's hidden
    state, the Mamba2 mixer's output (ssd_chunked's) and, where the shared
    block follows, its attention's output (flash_attention's) are computed
    both ways and held to 5% of the plain output's max |value|, the limit
    _logit_parity holds logits to. Each mixer's own output is held, not
    the layer's: the residual stream would dilute a fault in it. Then the
    last-position logits of the two whole paths, whose argmax must agree,
    their largest difference printed. The whole paths are not held to 5%:
    at zamba2-7b's 81 layers the two bf16 routes round apart by more than
    that, and each is farther still from the float32 function
    (tools/zoo_logits.py). tools/zoo_fault.py plants kernel faults that
    this check must catch."""
    import numpy as np
    import torch

    from repro_torch.models import apply_layer, embed_tokens, lm_logits
    from repro_torch.models.attention import attn_fwd
    from repro_torch.models.layers import mlp_fwd, rmsnorm
    from repro_torch.models.mamba2 import mamba_fwd

    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (1, 256)),
                           dtype=torch.int32, device=DEVICE)
    pos = torch.arange(256, dtype=torch.int32, device=DEVICE)[None]
    kern, plain = _impl_cfg(cfg, "auto"), _impl_cfg(cfg, "ref")
    eps, sp = cfg.norm_eps, params["shared"]
    worst = {"mamba": (0.0, 0), "attention": (0.0, 0)}

    def held(mixer, li, want, got):
        if not torch.isfinite(got).all():
            fail(f"{cfg.name}: layer {li}'s {mixer} output is not finite")
        share = ((got.float() - want.float()).abs().max()
                 / want.float().abs().max()).item()
        if share > worst[mixer][0]:
            worst[mixer] = (share, li)

    with torch.inference_mode():
        x = xk = embed_tokens(params, cfg, toks)
        for li in range(cfg.n_layers):
            bp = params["blocks"][li]
            u = rmsnorm(x, bp["ln"], eps)
            h = mamba_fwd(bp["mamba"], u, plain)[0]
            held("mamba", li, h, mamba_fwd(bp["mamba"], u, kern)[0])
            x = x + h
            if (li + 1) % cfg.attn_every == 0:
                u = rmsnorm(x, sp["ln1"], eps)
                h = attn_fwd(sp["attn"], u, pos, plain)[0]
                held("attention", li, h, attn_fwd(sp["attn"], u, pos,
                                                  kern)[0])
                x = x + h
                x = x + mlp_fwd(sp["mlp"], rmsnorm(x, sp["ln2"], eps))
            xk, _ = apply_layer(params, kern, li, xk, pos)
        lg = {name: lm_logits(params, cfg, rmsnorm(
            hs, params["final_ln"], eps))[0, -1].float()
              for name, hs in (("auto", xk), ("ref", x))}
    err = (lg["auto"] - lg["ref"]).abs().max().item()
    scale = lg["ref"].abs().max().item()
    top = (int(lg["auto"].argmax()), int(lg["ref"].argmax()))
    ok = max(w for w, _ in worst.values()) <= 0.05 and top[0] == top[1]
    (wm, at_m), (wa, at_a) = worst["mamba"], worst["attention"]
    log(f"[parity] {cfg.name} full-width bf16, each mixer on the plain "
        f"path's hidden states: largest difference {100 * wm:.3f}% of the "
        f"Mamba2 output's max |value| (layer {at_m}), {100 * wa:.3f}% of "
        f"the shared attention's (after layer {at_a}); tol 5%; whole paths' "
        f"last-position logits: max_abs_err {err:.4e} vs max |logit| "
        f"{scale:.4e} ({100 * err / scale:.2f}%), argmax {top[0]} vs "
        f"{top[1]} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{cfg.name}: full-width kernel and plain paths disagree")


def _smoke_req(rng, i):
    from repro_torch.serve import Request

    shared = [7, 3, 9, 2, 5, 8, 6, 4, 1, 2, 3, 4]
    tail = [int(t) for t in rng.integers(1, 512, int(rng.integers(3, 30)))]
    return Request(rid=i, prompt=shared + tail,
                   max_new=int(rng.integers(8, 40)))


# ------------------------------------------------------------ phase 8
TRAIN_KERNELS = ("flash_attention", "gmm", "ssd_chunked")
# (a) tinyllama-1.1b at full width: bf16 compute on float32 masters,
# remat "full" (its config's), 8 x 512 tokens a step.
TRAIN_MAIN = ["--arch", "tinyllama-1.1b", "--preset", "full", "--steps",
              "20", "--batch", "8", "--seq", "512", "--log-every", "1"]
# The loss must fall at least this far over the 20 steps: half of what the
# H100 runs measured (10.6022 -> 4.7015, 5.90, in each of three runs).
TRAIN_MIN_DROP = 3.0
TRAIN_MOE = ["--arch", MOE, "--preset", "100m", "--steps", "10", "--batch",
             "8", "--seq", "128", "--rebalance-every", "5", "--log-every",
             "5"]
TRAIN_SSM = ["--arch", "mamba2-130m", "--preset", "full", "--steps", "10",
             "--batch", "8", "--seq", "512", "--log-every", "5"]
TRAIN_DRILL = ["--arch", "tinyllama-1.1b", "--preset", "tiny", "--steps",
               "12", "--batch", "4", "--seq", "64", "--ckpt-every", "4",
               "--log-every", "12"]
# (d) gradient parity: smoke configs of these families; the kernel route
# runs under a remat policy (the plain route under none), so checkpointed
# layers that recompute the kernels are held too.
GRAD_ARCHS = {"tinyllama-1.1b": ("dots", ("flash_attention",)),
              MOE: ("full", ("flash_attention", "gmm")),
              "mamba2-130m": ("full", ("ssd_chunked",)),
              "zamba2-7b": ("dots", ("ssd_chunked", "flash_attention"))}


def _train_run(tag, argv, smi):
    """``launch.train.train(argv)`` on the card: per-step host ms (each
    step ends in a synchronise), each step's kernel launches, the peak of
    device memory over the run. Returns (params, opt, history, step ms,
    per-step launch counts, peak bytes, printed lines)."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    ms, launches = [], []
    last = [0.0, ops.kernel_launches()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), ops.kernel_launches()
        ms.append(1e3 * (now - last[0]))
        launches.append({k: counts[k] - last[1][k] for k in counts})
        last[0], last[1] = now, counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = io.StringIO()
    last[0], last[1] = time.perf_counter(), ops.kernel_launches()
    with contextlib.redirect_stdout(out):
        params, opt, hist = train(argv + ["--device", DEVICE],
                                  on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[train] {tag}: {line}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"train {tag}: a loss is not finite: {hist}")
    return params, opt, hist, ms, launches, peak, lines


def _per_step(tag, launches, name, want):
    got = sorted({c[name] for c in launches})
    if got != [want]:
        fail(f"train {tag}: {name} launched {got} times a step, want "
             f"{want}")


BACKWARD_RANGE = "KernelFunction.backward["


def _busy_ms(label, fn):
    """One call of ``fn`` under torch.profiler: (device busy ms, the
    kernel ms inside each ``KernelFunction.backward[...]`` range by the
    plain version's name, fn's result). Busy sums the device records
    (kernels and copies), leaving out the gaps where the device waits for
    the host. A ``record_function`` range also appears on the device as
    one span over its kernels, gaps included; the spans are not summed,
    they select the kernels inside them."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in dev if e.name.startswith(BACKWARD_RANGE)]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in dev
                     if not e.name.startswith(BACKWARD_RANGE))
    busy = sum(b - a for a, b in kernels) / 1e3
    if busy <= 0:
        fail(f"train: torch.profiler recorded no device time ({label})")
    starts = [a for a, _ in kernels]
    ranges = {}
    for sp in spans:
        name = sp.name[len(BACKWARD_RANGE):-1]
        lo = bisect.bisect_left(starts, sp.time_range.start)
        hi = bisect.bisect_right(starts, sp.time_range.end)
        inside = sum(b - a for a, b in kernels[lo:hi]
                     if b <= sp.time_range.end)
        ranges[name] = ranges.get(name, 0.0) + inside / 1e3
    return busy, ranges, out


def _step_split(cfg, params, opt, batch, iters=3):
    """A training step's forward (``train_loss``), backward
    (``torch.autograd.grad``) and optimizer (``adamw_update``): device ms
    by CUDA events, the median of ``iters`` steps (the device's clock,
    gaps where it waits for the host included); then device busy ms of
    one more step under torch.profiler, and of its backward the device ms
    of each kernel's backward through its plain version. Returns
    (elapsed, busy, ranges): elapsed and busy [forward, backward,
    optimizer] lists, ranges {plain version's name: ms}."""
    import torch

    from repro_torch.models import train_loss
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             tree_leaves)

    leaves = tree_leaves(params)
    oc = OptConfig(lr=1e-5, warmup_steps=1, total_steps=100)
    parts = []
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = train_loss(params, cfg, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        adamw_update(params, grads, opt, oc)   # grads in tree_leaves order
        ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del loss, grads
    parts.sort(key=sum)
    fwd, _, (loss, _) = _busy_ms("forward",
                                 lambda: train_loss(params, cfg, batch))
    bwd, ranges, grads = _busy_ms(
        "backward", lambda: torch.autograd.grad(loss, leaves))
    upd, _, _ = _busy_ms("optimizer",
                         lambda: adamw_update(params, grads, opt, oc))
    return parts[len(parts) // 2], [fwd, bwd, upd], ranges


def _backward_share(tag, cfg, params, opt, B, S, plain, smi):
    """The step split of a trained model, and the share of the backward's
    device time that the backward of the kernel whose plain version is
    ``plain`` takes."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokens

    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             SyntheticTokens(cfg, B, S, seed=1).next_batch().items()}
    (fwd, bwd, upd), busy, ranges = _step_split(cfg, params, opt, batch)
    if plain not in ranges:
        fail(f"train {tag}: no {plain} backward in the profile: {ranges}")
    step, busy_step = fwd + bwd + upd, sum(busy)
    remat = (" (with remat's second forward)" if cfg.remat != "none"
             else "")
    log(f"[train] {tag} step split, device ms by CUDA events (median of "
        f"3; waits for the host included) and device busy ms under "
        f"torch.profiler (one more step): forward {fwd:.2f} (busy "
        f"{busy[0]:.2f}), backward {bwd:.2f} (busy {busy[1]:.2f}){remat}, "
        f"optimizer {upd:.2f} (busy {busy[2]:.2f}); the backward is "
        f"{100 * bwd / step:.1f}% of the step's {step:.2f} ms "
        f"({100 * busy[1] / busy_step:.1f}% of its {busy_step:.2f} busy "
        f"ms). The kernels' backward through their plain versions, "
        f"device ms inside the backward: "
        + ", ".join(f"{k} {v:.2f} ({100 * v / busy[1]:.1f}% of the "
                    f"backward's busy time)" for k, v in ranges.items())
        + f"; {smi}")


def _leaf_errs(got, want) -> list:
    """Each leaf's largest |got - want| over that leaf's max |want|."""
    return [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            for g, w in zip(got, want, strict=True)]


def _grad_parity():
    """(d) Smoke configs of the dense, moe, ssm and hybrid families in
    float32 and bf16: one ``train_loss`` backward through the kernels and
    one through the plain versions, on the same float32 masters and
    batch. Every parameter must have a float32 gradient on both routes,
    each leaf within TOL[dtype] of the plain route's, relative to its max
    |grad|.

    Two bf16 cases are held otherwise (measured on the card, PERF.md §6
    PR 21). (1) bf16 rounds in other places on the two routes (the
    attention kernel keeps P in bf16), and the plain route is itself up
    to 3.8% of a leaf's max |grad| from the float32 gradient (zamba2's
    smoke config): a bf16 leaf outside TOL of the plain route's must be
    within TOL of being as close to the float32 gradient as the plain
    route's, |kernel - f32| <= |plain - f32| + TOL. (2) The moe family
    routes by top-k: the attention kernel's rounding sends a few tokens
    to other experts (expert counts differ) and the router's gradient
    moves by 6.1% of its max (the bf16 plain route is 9.1% from float32
    there). When the counts differ, the gmm kernel is held on the plain
    route's routing instead (plain attention, the gmm kernel: counts
    equal, every leaf within TOL); the attention kernel's bf16 gradient
    is held by the dense family."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import train_loss
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import init_train_state

    for arch, (remat, kernels) in GRAD_ARCHS.items():
        smoke = ARCHS[arch].smoke()
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        params, _ = init_train_state(smoke, gen, DEVICE)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
                 SyntheticTokens(smoke, 4, 64, seed=5).next_batch().items()}
        routes = {"kernels": ("auto", "auto"), "plain": ("ref", "ref")}
        if smoke.family == "moe":
            routes["gmm kernel"] = ("ref", "auto")
        truth = None
        for dtype in ("float32", "bfloat16"):
            got = {}
            for route, (attn, moe) in routes.items():
                cfg = dataclasses.replace(
                    smoke, dtype=dtype, attn_impl=attn, moe_impl=moe,
                    remat=remat if route == "kernels" else "none")
                ops.reset_launches()
                loss, metrics = train_loss(params, cfg, batch)
                try:
                    grads = torch.autograd.grad(loss, leaves)
                except RuntimeError as e:        # a leaf without gradient
                    fail(f"grad parity {arch} {dtype} {route}: {e}")
                torch.cuda.synchronize()
                counts = ops.kernel_launches()
                used = sorted(n for n in TRAIN_KERNELS if counts[n])
                want = {"kernels": sorted(kernels), "plain": [],
                        "gmm kernel": ["gmm"]}[route]
                if used != want or sum(counts.values()) != sum(
                        counts[n] for n in used):
                    fail(f"grad parity {arch} {dtype} {route}: launched "
                         f"{counts}, want {want}")
                if not all(torch.isfinite(g).all() and g.dtype ==
                           torch.float32 for g in grads):
                    fail(f"grad parity {arch} {dtype} {route}: a bad "
                         "gradient")
                routing = (metrics["expert_counts"].tolist()
                           if "expert_counts" in metrics else None)
                got[route] = (loss.item(), grads, routing)
            direct = _leaf_errs(got["kernels"][1], got["plain"][1])
            worst, note = max(direct), ""
            if dtype == "float32":
                truth = got["plain"][1]
                ok = worst <= TOL[dtype]
            elif got["kernels"][2] != got["plain"][2]:
                gmm_err = max(_leaf_errs(got["gmm kernel"][1],
                                         got["plain"][1]))
                ok = (got["gmm kernel"][2] == got["plain"][2]
                      and gmm_err <= TOL[dtype])
                far_plain = max(_leaf_errs(got["plain"][1], truth))
                note = (f"; routing differs (expert counts "
                        f"{got['kernels'][2]} vs {got['plain'][2]}; the "
                        f"plain route {100 * far_plain:.4f}% from "
                        f"float32), so gmm alone on the plain route's "
                        f"routing: {100 * gmm_err:.4f}%")
            else:
                far = _leaf_errs(got["kernels"][1], truth)
                far_plain = _leaf_errs(got["plain"][1], truth)
                outside = [i for i, d in enumerate(direct)
                           if d > TOL[dtype]]
                excess = max((far[i] - far_plain[i] for i in outside),
                             default=0.0)
                ok = excess <= TOL[dtype]
                if outside:
                    note = (f"; {len(outside)} leaves outside it, from the "
                            f"float32 gradient at most {100 * excess:+.4f}% "
                            f"beyond the plain route's (kernel route "
                            f"{100 * max(far):.4f}%, plain "
                            f"{100 * max(far_plain):.4f}% at worst)")
            log(f"[train] grad parity {arch} smoke {dtype} (kernel route "
                f"remat {remat!r}, through {sorted(kernels)}): "
                f"{len(leaves)} leaves, loss {got['kernels'][0]:.6f} vs "
                f"{got['plain'][0]:.6f}, largest |kernel - plain| "
                f"{100 * worst:.4f}% of its leaf's max |grad|, tol "
                f"{100 * TOL[dtype]:g}%{note} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"grad parity {arch} {dtype}: {worst:.3e} > "
                     f"{TOL[dtype]}{note}")
        del params, leaves


def _drill(smi):
    """(e) --fail-at-step then --resume at the tiny preset against an
    uninterrupted run, with deterministic algorithms requested."""
    import tempfile
    import warnings

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.train.optimizer import tree_leaves

    common = TRAIN_DRILL + ["--device", DEVICE]
    total = {name: 0 for name in TRAIN_KERNELS}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops.reset_launches()
            pa, oa, ha = train(common + ["--ckpt-dir", f"{d}/a"])
            try:
                train(common + ["--ckpt-dir", f"{d}/b", "--fail-at-step",
                                "10", "--ckpt-async"])
            except RuntimeError as e:
                if "simulated node failure at step 10" not in str(e):
                    raise
            else:
                fail("drill: --fail-at-step 10 did not fail")
            pb, ob, hb = train(common + ["--ckpt-dir", f"{d}/b",
                                         "--resume"])
            torch.cuda.synchronize()
            counts = ops.kernel_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    for name in TRAIN_KERNELS:
        total[name] += counts[name]
    a, b = tree_leaves([pa, oa]), tree_leaves([pb, ob])
    same = all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    worst = max((x.float() - y.float()).abs().max().item()
                for x, y in zip(a, b))
    notes = sorted({str(w.message).split(".")[0][:100] for w in caught})
    log(f"[train] drill: 12 steps at the tiny preset against --fail-at-step "
        f"10 + --resume from step 8: parameters and moments "
        f"{'bit-exact' if same else 'NOT bit-exact'} (largest difference "
        f"{worst:.3e}); last loss {ha[-1]['loss']:.6f} vs "
        f"{hb[-1]['loss']:.6f}; deterministic-algorithm warnings: "
        f"{notes or 'none'}; {smi}")
    if not same and worst > 1e-6:
        fail(f"drill: resumed run differs by {worst:.3e} > 1e-6")
    return total


def phase_train(smi):
    """Training on the card through ``repro_torch.launch.train``."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import preset_config
    from repro_torch.train.optimizer import tree_leaves

    totals = {name: 0 for name in TRAIN_KERNELS}

    def add(counts):
        for c in counts:
            for name in TRAIN_KERNELS:
                totals[name] += c[name]

    # (a) tinyllama-1.1b at full width
    cfg = ARCHS["tinyllama-1.1b"]
    B, S = 8, 512
    params, opt, hist, ms, launches, peak, _ = _train_run(
        "tinyllama-1.1b full", TRAIN_MAIN, smi)
    add(launches)
    drop = hist[0]["loss"] - hist[-1]["loss"]
    n_params = sum(p.numel() for p in tree_leaves(params))
    rounds = 2 if cfg.remat != "none" else 1
    _per_step("tinyllama", launches, "flash_attention",
              rounds * cfg.n_layers)
    _per_step("tinyllama", launches, "gmm", 0)
    p50 = float(np.median(ms[1:]))
    log(f"[train] tinyllama-1.1b full width: {n_params / 1e9:.4f} B float32 "
        f"master parameters, {cfg.dtype} compute, remat {cfg.remat!r}, "
        f"{B} x {S} tokens a step, {len(ms)} steps: loss "
        f"{hist[0]['loss']:.4f} (step {hist[0]['step']}) -> "
        f"{hist[-1]['loss']:.4f} (step {hist[-1]['step']}), fell by "
        f"{drop:.4f} (must fall by {TRAIN_MIN_DROP}); step ms p50 "
        f"{p50:.2f} (first {ms[0]:.2f}, max of the rest "
        f"{max(ms[1:]):.2f}), {B * S / p50 * 1e3:.1f} train tokens/s; peak "
        f"device memory {peak / 2**30:.2f} GiB; flash_attention "
        f"{launches[-1]['flash_attention']} launches a step "
        f"({rounds} x {cfg.n_layers} layers); {smi}")
    if drop < TRAIN_MIN_DROP:
        fail(f"train: tinyllama-1.1b loss fell by {drop:.4f} < "
             f"{TRAIN_MIN_DROP}")
    _backward_share("tinyllama-1.1b", cfg, params, opt, B, S,
                    "attention_ref", smi)
    del params, opt
    torch.cuda.empty_cache()

    # (b) moonshot-v1-16b-a3b at the 100m preset, rebalancing
    mcfg = preset_config(ARCHS[MOE], "100m")
    params, opt, hist, ms, launches, peak, lines = _train_run(
        f"{MOE} 100m", TRAIN_MOE, smi)
    add(launches)
    _per_step("moe", launches, "gmm", 3 * mcfg.n_layers)
    _per_step("moe", launches, "flash_attention", mcfg.n_layers)
    rebal = [ln for ln in lines if "GLB-MoE rebalance" in ln]
    if len(rebal) != 2:
        fail(f"train moe: {len(rebal)} rebalance lines, want 2")
    log(f"[train] {MOE} 100m preset ({mcfg.n_layers} layers, "
        f"{mcfg.n_experts} experts top-{mcfg.top_k}, {mcfg.dtype}): loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; step ms p50 "
        f"{float(np.median(ms[1:])):.2f}; gmm {launches[-1]['gmm']} "
        f"launches a step; peak {peak / 2**30:.2f} GiB; {smi}")
    _backward_share(f"{MOE} 100m", mcfg, params, opt, 8, 128, "gmm_ref",
                    smi)
    del params, opt
    torch.cuda.empty_cache()

    # (c) mamba2-130m at full width
    scfg = ARCHS["mamba2-130m"]
    params, opt, hist, ms, launches, peak, _ = _train_run(
        "mamba2-130m full", TRAIN_SSM, smi)
    add(launches)
    rounds = 2 if scfg.remat != "none" else 1
    _per_step("ssm", launches, "ssd_chunked", rounds * scfg.n_layers)
    p50 = float(np.median(ms[1:]))
    log(f"[train] mamba2-130m full width ({scfg.dtype}, remat "
        f"{scfg.remat!r}): loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}; step ms p50 {p50:.2f}, "
        f"{8 * 512 / p50 * 1e3:.1f} train tokens/s; ssd_chunked "
        f"{launches[-1]['ssd_chunked']} launches a step; peak "
        f"{peak / 2**30:.2f} GiB; {smi}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        fail("train: mamba2-130m loss did not fall")
    _backward_share("mamba2-130m", scfg, params, opt, 8, 512,
                    "ssd_chunked_ref", smi)
    del params, opt
    torch.cuda.empty_cache()

    # (d) gradient parity, (e) the failure / resume drill
    _grad_parity()
    drill = _drill(smi)
    for name in TRAIN_KERNELS:
        totals[name] += drill[name]
    log(f"[train] launches over the training runs: {totals}")
    return totals


# ------------------------------------------------------------ phase 9
# Distribution: ranks are processes on cuda:0, their collectives through
# gloo and staged through host memory (dist/collectives.py); NCCL runs at
# world size 1 only (it refuses two ranks on one card).
# Sizes of (a) to (c). Run alone (``--phase dist``), the phase takes UTS at
# depth 10 (1,962,542 nodes; depth 11 would take some 20 minutes on
# ranks that time-slice one card), fib(24) and NCCL at depth 9. In the
# whole run, which must end within 1200 s, phases 1-8 take 700-900 s and
# phases 10 and 11 another 105-160 s, so the sizes are cut: depth 8,
# fib(20), NCCL at depth 7 (PERF.md §6).
DIST_SIZES = {
    "alone": dict(uts=dict(UTS_TREE, depth=10), fib=dict(n=24),
                  nccl=dict(UTS_TREE, depth=9)),
    "whole": dict(uts=dict(UTS_TREE, depth=8), fib=dict(n=20),     # 122,734
                  nccl=dict(UTS_TREE, depth=7)),                    # 30,688
}
DIST_WORLD = 8
DIST_FIB_PARAMS = dict(n=16, steal_k=16)
DIST_BC = dict(scale=10, seed=7)
DIST_BC_PARAMS = dict(n=8, steal_k=8)
EP_WORLD = 4
EP_TOKENS = (8, 256)                          # x (8, 256, d_model)
EP_LAYOUTS = ((1, 4), (2, 2))                 # (data, model)
PIPE = dict(arch="tinyllama-1.1b", stages=2, micro=4, batch=2, seq=256)
COMPRESS_STEPS = 60
DIST_KERNELS = ("uts_expand", "gmm", "flash_attention")


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _dist_problem(kind, kw):
    from repro_torch.problems import bc, fib, rmat, uts

    if kind == "uts":
        return uts.uts_problem(**kw)
    if kind == "fib":
        return fib.fib_problem(**kw)
    return bc.bc_problem(rmat.rmat_graph(**kw)[0])


def _dist_glb_rank(device, cases):
    """One rank of ``GLB(mode="shard_map")`` over a (world,) ``place``
    mesh: each case run once; its result, counters, host ms by phase,
    wire bytes, this rank's kernel launches and wall time."""
    import torch.distributed as dist

    from repro_torch.core import GLB, GLBParams
    from repro_torch.dist import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_glb_mesh

    mesh = make_glb_mesh(n=dist.get_world_size(), device_type=device)
    out = []
    for label, kind, kw, params, routing in cases:
        glb = GLB(_dist_problem(kind, kw), GLBParams(**params), mesh=mesh,
                  mode="shard_map", routing=routing, device=device)
        dist.barrier()
        _sync(device)
        ops.reset_launches()
        C.reset_wire()
        t0 = time.perf_counter()
        glb.run(seed=0)
        _sync(device)
        r = glb.last_run
        out.append(dict(
            label=label, wall=time.perf_counter() - t0, result=r.result,
            per_place=r.per_place, stats=r.stats, supersteps=r.supersteps,
            host_ms=r.host_ms, wire_bytes=r.wire_bytes, wire=C.wire_bytes(),
            launches=ops.kernel_launches(), backend=dist.get_backend()))
    return out


def _sim(label, kind, kw, params, P):
    """run_sim on the card: the counters the distributed run must equal."""
    import torch

    from repro_torch.core import GLBParams, run_sim

    _sync(DEVICE)
    t0 = time.time()
    r = run_sim(_dist_problem(kind, kw), P, GLBParams(**params), seed=0,
                device=DEVICE)
    _sync(DEVICE)
    log(f"[dist run_sim x1] {label} on {P} places of one {DEVICE}: "
        f"{r.supersteps} supersteps, {time.time() - t0:.2f} s")
    host = lambda t: t.cpu().numpy() if torch.is_tensor(t) else t
    return dict(result=host(r.result), per_place=host(r.per_place),
                stats={k: host(v) for k, v in r.stats.items()},
                supersteps=r.supersteps)


def _wire_per_superstep(kind, params, routing, P):
    """The bytes a rank hands to the collectives in one superstep, from the
    code: the (size, in-state work) gather; dense: a (P, K, item) buffer
    per item field and the (P,) counts; lifeline: z packets of K items and
    a count, plus the dense buffer of the random round unless w == 0."""
    import numpy as np

    from repro_torch.core import GLBParams

    from repro_torch.problems import bc, fib, uts

    p = GLBParams(**params)
    spec = {"uts": uts, "fib": fib, "bc": bc}[kind].ITEM_SPEC
    item = sum(int(np.prod(s, dtype=np.int64)) * dt.itemsize
               for s, dt in spec.values())
    K, z = p.steal_k, p.resolve_z(P)
    dense = P * (p.steal_k_random or K) * item + P * 4
    if routing == "dense":
        return 8 + P * K * item + P * 4
    return 8 + z * (K * item + 4) + (dense if p.w else 0)


def _dist_check(tag, case, rows, sim, exact, want=None):
    """Every rank the same run, equal to run_sim in supersteps and every
    counter (and per-place results, exactly or, for BC, to rtol 1e-5)."""
    import numpy as np

    label, kind, kw, params, routing = case
    r0 = rows[0]
    for r in rows:
        if (r["supersteps"] != r0["supersteps"]
                or not np.array_equal(r["result"], r0["result"])
                or any(not np.array_equal(r["stats"][k], r0["stats"][k])
                       for k in r0["stats"])):
            fail(f"{tag} {label}: ranks disagree")
    same = (r0["supersteps"] == sim["supersteps"] and all(
        np.array_equal(r0["stats"][k], sim["stats"][k]) for k in sim["stats"]))
    if exact:
        same = same and np.array_equal(r0["per_place"], sim["per_place"])
    else:
        same = same and np.allclose(r0["per_place"], sim["per_place"],
                                    rtol=1e-5, atol=1e-6)
    log(f"{tag} {label}: {r0['supersteps']} supersteps; supersteps, all "
        f"{len(sim['stats'])} counters and per-place results "
        f"{'equal to' if same else 'DIFFER from'} run_sim at P "
        f"{len(r0['per_place'])}")
    if not same:
        fail(f"{tag} {label} differs from run_sim")
    if want is not None and not np.array_equal(r0["result"], want):
        fail(f"{tag} {label}: result {r0['result']}, want {want}")
    S = r0["supersteps"]
    wall = max(r["wall"] for r in rows)
    host = {k: np.mean([r["host_ms"][k] for r in rows]) / S
            for k in r0["host_ms"]}
    measured = r0["wire_bytes"] / S
    counted = _wire_per_superstep(kind, params, routing, len(rows))
    log(f"{tag} {label}: {wall:.2f} s (slowest rank); host ms per "
        f"superstep, mean over ranks: " + ", ".join(
            f"{k} {v:.3f}" for k, v in host.items())
        + f"; the rest {wall * 1e3 / S - sum(host.values()):.3f}; wire "
        f"bytes per superstep {measured:.0f} measured, {counted} from the "
        f"code (by collective over the run, rank 0: {r0['wire']})")
    if any(r["wire_bytes"] != counted * S for r in rows):
        fail(f"{tag} {label}: wire bytes differ from the count")
    return wall


def _stage_fn(cfg):
    """A pipeline stage of the dense family: its blocks in order, prefill
    mode, no cache."""
    import torch

    from repro_torch.models import apply_layer

    def fn(blocks, h):
        B, S = h.shape[:2]
        pos = torch.arange(S, dtype=torch.int32,
                           device=h.device)[None].expand(B, S)
        for i in range(len(blocks)):
            h, _ = apply_layer({"blocks": blocks}, cfg, i, h, pos,
                               mode="prefill")
        return h
    return fn


def _gather_full(local, mesh, placements):
    """A DTensor's full value from each rank's local shard, gathered mesh
    dim by mesh dim (innermost first) through the host-staged
    collectives."""
    import torch

    from repro_torch.dist import collectives as C

    t = local
    for i in reversed(range(len(placements))):
        pl = placements[i]
        if not pl.is_shard():
            continue
        parts = C.all_gather(t.contiguous(),
                             mesh.get_group(mesh.mesh_dim_names[i]))
        t = torch.cat(list(parts), dim=pl.dim)
    return t


def _ep_rank(device, job, out):
    """(d): one full-width MoE layer, EP on (data x model) meshes, each
    data shard's y, counts and drops against the plain route (``ref``:
    the global dispatch through gmm_ref) on that shard; the global layer
    (the gmm kernel) only timed."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.models.moe import moe_fwd, moe_init

    cfg = dataclasses.replace(job["moe"], capacity_factor=1.25)
    gen = torch.Generator(device=device)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        p = moe_init(cfg, gen.manual_seed(0), device, dtype)
        x = torch.randn(job["ep_tokens"] + (cfg.d_model,), generator=gen,
                        device=device).to(dtype)
        for dp, mp in job["ep_layouts"]:
            mesh = init_device_mesh(device, (dp, mp),
                                    mesh_dim_names=("data", "model"))
            d = mesh.get_local_rank("data")
            n = job["ep_tokens"][0] // dp
            xl = x[d * n:(d + 1) * n]
            ep = dataclasses.replace(cfg, moe_impl="ep")
            dist.barrier()
            _sync(device)
            ops.reset_launches()
            with torch.inference_mode():
                y, aux = moe_fwd(p, xl, ep, mesh=mesh)
            _sync(device)
            gmm = ops.kernel_launches()["gmm"]
            with torch.inference_mode():
                y_ref, aux_ref = moe_fwd(p, xl, dataclasses.replace(
                    cfg, moe_impl="ref"))
                counts, dropped = (aux_ref["expert_counts"],
                                   aux_ref["dropped"])
                if dp > 1:
                    g = mesh.get_group("data")
                    counts, dropped = C.psum(counts, g), C.psum(dropped, g)
                err = ((y.float() - y_ref.float()).abs().max()
                       / y_ref.float().abs().max()).item()

                def run_ep():
                    moe_fwd(p, xl, ep, mesh=mesh)
                    _sync(device)
                ep_ms = _host_ms(run_ep)
                # the global layer on the whole batch, on one rank alone
                dist.barrier()
                glob_ms = None
                if dist.get_rank() == 0:
                    def run_global():
                        moe_fwd(p, x, dataclasses.replace(
                            cfg, moe_impl="global"))
                        _sync(device)
                    glob_ms = _host_ms(run_global)
                dist.barrier()
            out[f"ep-{name}-{dp}x{mp}"] = dict(
                err=err, gmm=gmm, data_rank=d,
                counts_equal=torch.equal(counts, aux["expert_counts"]),
                dropped=float(aux["dropped"]),
                dropped_equal=float(dropped) == float(aux["dropped"]),
                ep_ms=ep_ms, global_ms=glob_ms, capacity=aux_ref["capacity"])
        del p, x
        if device == "cuda":
            torch.cuda.empty_cache()


def _host_ms(fn, iters=3):
    """Median host ms of ``fn`` (which ends in a synchronise), after one
    warm-up call."""
    import numpy as np

    fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _pipe_rank(device, job, out):
    """(e): tinyllama-1.1b at full width as a 2-stage pipeline on the
    ranks of data row 0 of a (2, 2) (data, stage) mesh; the other row
    waits. The outputs are held bit for bit to the sequential forward
    of the same layers, and to it with the plain attention: within TOL
    of its max |h| or, as ``_grad_parity`` holds bf16 past a few layers,
    within TOL of being as close to the float32 forward (plain
    attention) as the bf16 plain route is."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import pipeline_forward, split_layers_into_stages
    from repro_torch.kernels import ops
    from repro_torch.models import embed_tokens, init_lm
    from repro_torch.train.optimizer import tree_map

    pipe = job["pipe"]
    S, M = pipe["stages"], pipe["micro"]
    mesh = init_device_mesh(device, (dist.get_world_size() // S, S),
                            mesh_dim_names=("data", "stage"))
    if mesh.get_local_rank("data") == 0:
        cfg = job["dense"]
        gen = torch.Generator(device=device)
        with torch.inference_mode():
            params = init_lm(cfg, gen.manual_seed(0), device)
            tokens = torch.randint(0, cfg.vocab, (M, pipe["batch"],
                                                  pipe["seq"]),
                                   generator=gen, device=device)
            x = embed_tokens(params, cfg, tokens)
            fn = _stage_fn(cfg)
            stages = split_layers_into_stages(params["blocks"], S)
            pipeline_forward(fn, stages, x, mesh, "stage")     # warm-up
            _sync(device)
            ops.reset_launches()
            t0 = time.perf_counter()
            got = pipeline_forward(fn, stages, x, mesh, "stage")
            _sync(device)
            wall = time.perf_counter() - t0
            fa = ops.kernel_launches()["flash_attention"]
            t0 = time.perf_counter()
            want = torch.stack([fn(params["blocks"], x[m])
                                for m in range(M)])
            _sync(device)
            seq = time.perf_counter() - t0
            plain_fn = _stage_fn(dataclasses.replace(cfg, attn_impl="ref"))
            plain = torch.stack([plain_fn(params["blocks"], x[m])
                                 for m in range(M)])
            f32_fn = _stage_fn(dataclasses.replace(cfg, attn_impl="ref",
                                                   dtype="float32"))
            blocks32 = tree_map(lambda t: t.float(), params["blocks"])
            truth = torch.stack([f32_fn(blocks32, x[m].float())
                                 for m in range(M)])
            del blocks32
        rel = lambda a, b: ((a.float() - b.float()).abs().max()
                            / b.float().abs().max()).item()
        out["pipeline"] = dict(
            equal=torch.equal(got, want), finite=bool(
                torch.isfinite(got.float()).all()),
            max_diff=(got.float() - want.float()).abs().max().item(),
            plain_err=rel(got, plain), far=rel(got, truth),
            far_plain=rel(plain, truth),
            flash_attention=fa, ms=wall * 1e3, seq_ms=seq * 1e3,
            stage=mesh.get_local_rank("stage"), layers=cfg.n_layers)
        del params, x
        if device == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()


def _compress_rank(device, job, out):
    """(f): compressed_psum_mean over one full-width tinyllama layer's
    gradient-shaped float32 leaves against the host rendering of the
    formula, timed beside a plain float32 all-reduce of the same leaves;
    then the 60-step regression."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.dist import compress
    from repro_torch.ft.checkpoint import _flatten
    from repro_torch.models import init_lm

    group = dist.group.WORLD
    n, me = C.size(group), C.rank(group)
    shapes = {k: v.shape for k, v in _flatten(init_lm(
        job["dense"], device="meta")["blocks"][0]).items()}
    gen = torch.Generator(device=device)

    def leaves(seed, scale):
        gen.manual_seed(seed)
        return {k: torch.randn(s, generator=gen, device=device) * scale
                for k, s in shapes.items()}
    g, e = leaves(100 + me, 1.0), leaves(200 + me, 0.01)
    mean, err = compress.compressed_psum_mean(g, group, e)
    worst = 0.0               # against the reference's formula, in numpy
    gs = [leaves(100 + r, 1.0) for r in range(n)]
    es = [leaves(200 + r, 0.01) for r in range(n)]
    for k in shapes:
        corr = [(gs[r][k].float() + es[r][k]).cpu().numpy()
                for r in range(n)]
        amax = np.float32(max(np.abs(c).max() for c in corr))
        scale = np.float32(max(amax, np.float32(1e-30))) / np.float32(127)
        q = [np.clip(np.round(c / scale), -127, 127).astype(np.int8)
             for c in corr]
        total = np.sum([qi.astype(np.int32) for qi in q], axis=0)
        want = total.astype(np.float32) * (scale / np.float32(n))
        want_err = corr[me] - q[me].astype(np.float32) * scale
        worst = max(worst, float(np.abs(mean[k].cpu().numpy() - want).max()),
                    float(np.abs(err[k].cpu().numpy() - want_err).max()))
    del gs, es
    elems = sum(int(np.prod(s)) for s in shapes.values())

    def run_comp():
        compress.compressed_psum_mean(g, group, e)
        _sync(device)

    def run_plain():
        for v in g.values():
            C.psum(v, group)
        _sync(device)
    dist.barrier()
    comp_ms = _host_ms(run_comp)
    dist.barrier()
    plain_ms = _host_ms(run_plain)
    C.reset_wire()
    run_comp()
    comp_bytes = sum(C.wire_bytes().values())
    C.reset_wire()
    run_plain()
    plain_bytes = sum(C.wire_bytes().values())

    # the reference's 60-step regression, one shard of X, Y per rank
    gen.manual_seed(0)
    W0 = torch.randn((16, 16), generator=gen, device=device) * 0.3
    X = torch.randn((32, 16), generator=gen, device=device)
    Y = X @ (torch.randn((16, 16), generator=gen, device=device) * 0.5)
    rows = X.shape[0] // n
    Xl, Yl = X[me * rows:(me + 1) * rows], Y[me * rows:(me + 1) * rows]
    finals = {}
    for comp in (False, True):
        w = W0.clone()
        ef = compress.init_error({"w": torch.zeros_like(W0)})
        for _ in range(job["compress_steps"]):
            wg = w.clone().requires_grad_(True)
            (gw,) = torch.autograd.grad(torch.mean((Xl @ wg - Yl) ** 2), wg)
            if comp:
                gsum, ef = compress.compressed_psum_mean({"w": gw}, group,
                                                         ef)
                gw = gsum["w"]
            else:
                gw = C.pmean(gw, group)
            w = w - 0.05 * gw
        finals[comp] = w
    loss = lambda w: torch.mean((X @ w - Y) ** 2).item()
    rel = ((finals[True] - finals[False]).abs().max()
           / finals[False].abs().max().clamp(min=1e-9)).item()
    out["compress"] = dict(
        worst=worst, elems=elems, comp_ms=comp_ms, plain_ms=plain_ms,
        comp_bytes=comp_bytes, plain_bytes=plain_bytes,
        loss_exact=loss(finals[False]), loss_comp=loss(finals[True]),
        w_rel=rel)


def _at(tree, key):
    """The node of nested dicts and lists at a '/'-joined path, as
    ``ft.checkpoint._flatten`` names a leaf (a spec tree's leaves are
    tuples, which that function would walk into)."""
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _shard_rank(device, job, out):
    """(g): tinyllama-1.1b's parameters placed by tree_shardings on a
    (2 data x 2 model) mesh: each local shard's shape against the spec,
    and the host-staged reassembly bit for bit."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import param_axes, tree_shardings, tree_specs
    from repro_torch.dist.sharding import mesh_shape
    from repro_torch.ft.checkpoint import _flatten
    from repro_torch.models import init_lm

    cfg = job["dense"]
    mesh = init_device_mesh(device, (2, 2), mesh_dim_names=("data", "model"))
    sizes = mesh_shape(mesh)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device)
    axes = param_axes(cfg)
    flat_p = _flatten(params)
    specs = tree_specs(axes, params, mesh)
    shardings = tree_shardings(axes, params, mesh)
    bad, sharded, local_bytes = [], 0, 0
    for k, t in flat_p.items():
        sh, spec = _at(shardings, k), _at(specs, k)
        d = distribute_tensor(t, sh.mesh, list(sh.placements),
                              src_data_rank=None)
        local = d.to_local()
        want = []
        for size, e in zip(t.shape, spec):
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                size //= sizes[a]
            want.append(size)
        sharded += any(e is not None for e in spec)
        local_bytes += local.numel() * local.element_size()
        full = _gather_full(local, mesh, sh.placements)
        if tuple(local.shape) != tuple(want) or not torch.equal(full, t):
            bad.append(k)
    out["shard"] = dict(leaves=len(flat_p), sharded=sharded, bad=bad,
                        local_bytes=local_bytes,
                        full_bytes=sum(t.numel() * t.element_size()
                                       for t in flat_p.values()))


def _dist_models_rank(device, job):
    """(d) to (g) on one world of EP_WORLD ranks; ``job`` holds what they
    run (a spawned rank imports this file afresh, so nothing reaches it
    through the module's constants): the two model configs (``moe``,
    ``dense``), the EP batch and layouts, the pipeline's shape and the
    regression's steps."""
    out = {}
    for part in (_ep_rank, _pipe_rank, _compress_rank, _shard_rank):
        part(device, job, out)
    return out


def _production_specs():
    """(g): param_axes / spec_for of all ten archs at full width on the
    production meshes' shapes; every sharded dim must divide."""
    from repro_torch.configs import ARCHS
    from repro_torch.dist import param_axes, tree_specs
    from repro_torch.dist.sharding import mesh_shape
    from repro_torch.ft.checkpoint import _flatten
    from repro_torch.models import init_lm

    class Shape:
        def __init__(self, shape):
            self.shape = shape

    meshes = {"pod 16x16": Shape({"data": 16, "model": 16}),
              "multipod 2x16x16": Shape({"pod": 2, "data": 16,
                                         "model": 16})}
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        pshapes = init_lm(cfg, device="meta")
        axes = param_axes(cfg, pshapes)
        shp = _flatten(pshapes)
        for name, mesh in meshes.items():
            specs = tree_specs(axes, pshapes, mesh)
            sizes = mesh_shape(mesh)
            n_sharded = 0
            for k, leaf in shp.items():
                spec = _at(specs, k)
                for dim, e in zip(leaf.shape, spec):
                    prod = 1
                    for a in (() if e is None else (e,) if isinstance(
                            e, str) else e):
                        prod *= sizes[a]
                    if dim % prod:
                        fail(f"[dist host x1] {arch} {k}: dim {dim} does not "
                             f"divide by {spec}")
                n_sharded += any(e is not None for e in spec)
            log(f"[dist host x1] sharding {arch} full width on {name}: "
                f"{len(shp)} leaves, {n_sharded} sharded, every sharded "
                f"dim divides")


def phase_dist(smi, sizes="whole"):
    """Phase 9: the GLB executor with one place per process (UTS, fib,
    BC), expert-parallel MoE, the pipeline, the compressed all-reduce and
    the sharding rule engine, on ranks sharing the card; (a) to (c) at
    ``DIST_SIZES[sizes]``. Returns the kernels' launches over the ranks'
    main-path runs."""
    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.problems import fib, rmat, uts

    t_phase = time.time()
    tree, fib_kw, nccl_tree = (DIST_SIZES[sizes][k]
                               for k in ("uts", "fib", "nccl"))
    launches = dict.fromkeys(DIST_KERNELS, 0)
    staged = f"(ranks on one {DEVICE} device, collectives staged through " \
             f"host memory)"

    # (a) + (b): references first (host, then run_sim on the card)
    t0 = time.time()
    want_uts = uts.uts_count_bfs(**tree)
    adj = rmat.rmat_graph(**DIST_BC)[0]
    oracle = rmat.brandes_bc_oracle(adj)
    log(f"[dist host x1] UTS {tree}: {want_uts} nodes by the "
        f"breadth-first "
        f"count; BC oracle on R-MAT {DIST_BC}; {time.time() - t0:.1f} s")
    sims = {"uts": _sim("UTS", "uts", tree, UTS_PARAMS, DIST_WORLD),
            "fib": _sim("fib", "fib", fib_kw, DIST_FIB_PARAMS,
                        DIST_WORLD),
            "bc": _sim("BC", "bc", DIST_BC, DIST_BC_PARAMS, DIST_WORLD)}
    cases = [("uts-dense", "uts", tree, UTS_PARAMS, "dense"),
             ("uts-lifeline", "uts", tree, UTS_PARAMS, "lifeline"),
             ("fib-lifeline", "fib", fib_kw, DIST_FIB_PARAMS, "lifeline"),
             ("bc-dense", "bc", DIST_BC, DIST_BC_PARAMS, "dense")]
    t0 = time.time()
    ranks = run_ranks(_dist_glb_rank, DIST_WORLD, DEVICE, cases,
                      backend="gloo", timeout=900)
    log(f"[dist gloo x{DIST_WORLD}] GLB world {staged}: "
        f"{time.time() - t0:.1f} s with start-up")
    for i, case in enumerate(cases):
        rows = [r[i] for r in ranks]
        tag = f"[dist {rows[0]['backend']} x{DIST_WORLD}]"
        kind = case[1]
        if kind == "uts":
            wall = _dist_check(tag, case, rows, sims["uts"], True, want_uts)
            per_rank = [r["launches"]["uts_expand"] for r in rows]
            log(f"{tag} {case[0]}: {want_uts} nodes = uts_count_bfs; "
                f"{want_uts / wall:.0f} nodes/s; uts_expand launches per "
                f"rank {per_rank}")
            if min(per_rank) <= 0:
                fail(f"{tag} {case[0]}: a rank never launched uts_expand")
            launches["uts_expand"] += sum(per_rank)
        elif kind == "fib":
            _dist_check(tag, case, rows, sims["fib"], True,
                        fib.fib_oracle(fib_kw["n"]))
            log(f"{tag} fib({fib_kw['n']}) = {int(rows[0]['result'])} "
                f"(oracle {fib.fib_oracle(fib_kw['n'])})")
        else:
            _dist_check(tag, case, rows, sims["bc"], False)
            got = rows[0]["result"]
            ok = (np.allclose(got, oracle, rtol=1e-4, atol=1e-3)
                  and np.allclose(got, sims["bc"]["result"], rtol=1e-5,
                                  atol=1e-6) and np.isfinite(got).all())
            log(f"{tag} BC: {'equals' if ok else 'DIFFERS from'} "
                f"brandes_bc_oracle (rtol 1e-4, atol 1e-3) and run_sim's "
                f"result (rtol 1e-5)")
            if not ok:
                fail(f"{tag} BC disagrees with its oracle or run_sim")

    # (c) UTS on NCCL at world size 1: the NCCL code path's only run here
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    case = ("uts-dense", "uts", nccl_tree, UTS_PARAMS, "dense")
    sim1 = _sim(f"UTS depth {nccl_tree['depth']}", "uts", nccl_tree,
                UTS_PARAMS, 1)
    rows = [r[0] for r in run_ranks(_dist_glb_rank, 1, DEVICE, [case],
                                    backend=backend, timeout=600)]
    tag = f"[dist {rows[0]['backend']} x1]"
    _dist_check(tag, case, rows, sim1, True,
                uts.uts_count_bfs(**nccl_tree))
    launches["uts_expand"] += rows[0]["launches"]["uts_expand"]

    # (d) to (g) on one world of 4 ranks
    _production_specs()
    d_model = ARCHS[MOE].d_model
    t0 = time.time()
    job = {"moe": ARCHS[MOE], "dense": ARCHS[PIPE["arch"]],
           "ep_tokens": EP_TOKENS, "ep_layouts": EP_LAYOUTS, "pipe": PIPE,
           "compress_steps": COMPRESS_STEPS}
    ranks = run_ranks(_dist_models_rank, EP_WORLD, DEVICE, job,
                      backend="gloo", timeout=900)
    tag = f"[dist gloo x{EP_WORLD}]"
    log(f"{tag} model world {staged}: {time.time() - t0:.1f} s with "
        f"start-up")
    for key in ranks[0]:
        if not key.startswith("ep-"):
            continue
        rows = [r[key] for r in ranks]
        dtype = key.split("-")[1]
        worst = max(r["err"] for r in rows)
        gmm = [r["gmm"] for r in rows]
        ok = (worst <= TOL[dtype] and all(r["counts_equal"]
                                          and r["dropped_equal"]
                                          for r in rows) and min(gmm) > 0)
        log(f"{tag} EP {MOE} layer {key[3:]} (data x model), x "
            f"{EP_TOKENS + (d_model,)}, capacity {rows[0]['capacity']} a "
            f"shard: max |y - plain (gmm_ref) route on the shard| / max "
            f"|y| {worst:.3e} (TOL "
            f"{TOL[dtype]}), expert_counts and dropped ({rows[0]['dropped']:.0f}) "
            f"{'equal' if all(r['counts_equal'] and r['dropped_equal'] for r in rows) else 'DIFFER'}; "
            f"gmm launches per rank {gmm}; EP layer {rows[0]['ep_ms']:.2f} "
            f"ms (host clock, rank 0), the global layer on the whole batch "
            f"on one rank {rows[0]['global_ms']:.2f} ms")
        if not ok:
            fail(f"{tag} EP {key} failed")
        launches["gmm"] += sum(gmm)
    pipes = [r["pipeline"] for r in ranks if "pipeline" in r]
    S, M = PIPE["stages"], PIPE["micro"]
    for p in pipes:
        log(f"{tag} pipeline {PIPE['arch']} ({p['layers']} layers as {S} "
            f"stages), stage {p['stage']}: {M} microbatches of "
            f"({PIPE['batch']}, {PIPE['seq']}) tokens, bf16: "
            f"{'bit for bit equal to' if p['equal'] else 'DIFFERS from'} "
            f"the sequential forward (max diff {p['max_diff']:.3e}); "
            f"{p['plain_err']:.3e} of max |h| from it with the plain "
            f"attention (TOL {TOL['bfloat16']}), from the float32 forward "
            f"{p['far']:.3e} against the plain route's {p['far_plain']:.3e}"
            f" (plus TOL); "
            f"{p['ms'] / M:.2f} ms per microbatch ({p['ms']:.2f} ms in "
            f"all; sequential on one rank {p['seq_ms'] / M:.2f}); bubble "
            f"share of the schedule (S - 1) / (M + S - 1) = "
            f"{(S - 1) / (M + S - 1):.3f}; flash_attention launches "
            f"{p['flash_attention']}")
        near = (p["plain_err"] <= TOL["bfloat16"]
                or p["far"] <= p["far_plain"] + TOL["bfloat16"])
        if not (p["equal"] and p["finite"] and p["flash_attention"] > 0
                and near):
            fail(f"{tag} pipeline stage {p['stage']} failed")
        launches["flash_attention"] += p["flash_attention"]
    if len(pipes) != S:
        fail(f"{tag} pipeline: {len(pipes)} stages reported, want {S}")
    c = ranks[0]["compress"]
    worst = max(r["compress"]["worst"] for r in ranks)
    log(f"{tag} compressed_psum_mean over one {PIPE['arch']} layer's "
        f"gradient-shaped float32 leaves ({c['elems']} elements): max "
        f"|out - host rendering of the formula| {worst:.3e} (limit 1e-7); "
        f"{c['comp_ms']:.2f} ms against {c['plain_ms']:.2f} ms for a plain "
        f"float32 all_reduce of the same leaves (both through gloo); wire "
        f"bytes {c['comp_bytes']} against {c['plain_bytes']} (int32 codes: "
        f"float32's bytes); {COMPRESS_STEPS}-step regression: loss "
        f"{c['loss_comp']:.6f} compressed, {c['loss_exact']:.6f} exact, "
        f"w_rel {c['w_rel']:.4f}")
    if not (worst <= 1e-7 and c["loss_comp"] < c["loss_exact"] * 1.5 + 1e-3
            and c["w_rel"] < 0.05):
        fail(f"{tag} compressed_psum_mean failed its checks")
    for r in ranks:
        s = r["shard"]
        if s["bad"]:
            fail(f"{tag} sharding: leaves {s['bad'][:4]} wrong")
    s = ranks[0]["shard"]
    log(f"{tag} {PIPE['arch']} on a (2 data x 2 model) mesh: "
        f"{s['leaves']} leaves, {s['sharded']} sharded; every rank's local "
        f"shards as the specs give them ({s['local_bytes']} of "
        f"{s['full_bytes']} bytes on rank 0), reassembled through host "
        f"memory bit for bit")
    log(f"[dist] phase 9 in {time.time() - t_phase:.1f} s; launches over "
        f"the ranks' runs {launches}")
    return launches


# ----------------------------------------------------------- phase 10
# The dry run (repro_torch.launch.dryrun) on this machine's CPU, then its
# prediction of phase 8's one-card training cell held to the card.
DRY_CELLS = (("tinyllama-1.1b", "train_4k"), ("uts_glb", "glb"))
DRY_KEYS = ("status", "chips", "mesh", "trace_s", "memory_analysis",
            "collective_bytes", "collective_basis", "cost", "model_flops",
            "roofline", "device", "peaks")
DRY_MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes", "temp_basis")
DRY_TRAIN = dict(arch="tinyllama-1.1b", batch=8, seq=512)   # phase 8 (a)
ALLOC_ROUND = 512    # the CUDA caching allocator's block granularity
SEGMENT_ROUND = 2 << 20   # its segments for blocks past LARGE_ALLOC
LARGE_ALLOC = 10 << 20
SPLIT_MIN = 1 << 20       # a segment's rest is split off only past this


def _alloc_bytes(n: int) -> int:
    """What the caching allocator books for an n-byte tensor allocated
    afresh (no cached block reused): n in 512-byte blocks; past 10 MiB, a
    segment in 2 MiB steps, the whole of it when its rest would be 1 MiB
    or less."""
    if not n:
        return 0
    r = -(-n // ALLOC_ROUND) * ALLOC_ROUND
    if r <= LARGE_ALLOC:
        return r
    seg = -(-r // SEGMENT_ROUND) * SEGMENT_ROUND
    return seg if seg - r <= SPLIT_MIN else r


def phase_dryrun(smi):
    """Phase 10: (a) the dry run of tinyllama-1.1b/train_4k on the 16x16
    fake mesh and of uts_glb, in this process on the CPU; (b) the dry run
    of phase 8's training cell on a world of one, held to the card:
    argument bytes exactly, peak and step time beside the measured ones;
    (c) attention_chunked at that cell's attention shape against
    attention_ref, values and gradients. Returns the kernels' launches
    over (b)'s measured steps."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis import report
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (attention_chunked,
                                                     attention_ref)
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.trainer import init_train_state, make_train_step

    t_phase = time.time()
    tag = "[dryrun]"
    out_dir = os.path.join(ROOT, "build", "dryrun")
    # (a) the CLI's cells, as run_cell writes them
    recs = []
    try:
        for arch, shape in DRY_CELLS:
            rec = DR.run_cell(arch, shape, False, out_dir)
            if rec["status"] != "ok":
                fail(f"dryrun {arch}/{shape}: {rec['status']} "
                     f"{rec.get('error', '')}\n{rec.get('trace', '')}")
            missing = [k for k in DRY_KEYS if k not in rec] + [
                k for k in DRY_MEMORY if k not in rec["memory_analysis"]]
            if missing:
                fail(f"dryrun {arch}/{shape}: record lacks {missing}")
            recs.append(rec)
    finally:
        DR.close_world()
    for line in report.roofline_table(recs).splitlines():
        log(f"{tag} (a) {line}")
    for r in recs:
        log(f"{tag} (a) {r['arch']}/{r['shape']} on {r['chips']} ranks "
            f"({r['device']} trace {r['trace_s']} s, collectives "
            f"{r['collective_basis']}): {r['memory_analysis']}, "
            f"collectives {r['collective_bytes']}; reckoned from data-sheet "
            f"peaks, not measured")

    # (b) phase 8's cell on a world of one, then on the card
    cfg = ARCHS[DRY_TRAIN["arch"]]
    B, S = DRY_TRAIN["batch"], DRY_TRAIN["seq"]
    shape = ShapeConfig(f"train_{B}x{S}", S, B, "train")
    try:
        DR.fake_world(1)
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        tr = DR.trace_lm(DR._cell_cfg(cfg, shape), shape, mesh)
        rec = DR.lm_record(tr, mesh)
    finally:
        DR.close_world()
    mem = rec["memory_analysis"]
    args_b, temp_b = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
    roof = rec["roofline"]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params, opt = init_train_state(cfg, gen, device=DEVICE)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     dtype=torch.int32, device=DEVICE)}
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    leaves = tree_leaves(params) + tree_leaves(opt) + [batch["tokens"]]
    exact = sum(t.numel() * t.element_size() for t in leaves)
    booked = sum(_alloc_bytes(t.numel() * t.element_size()) for t in leaves)
    log(f"{tag} (b) {cfg.name} {B} x {S}, {cfg.dtype} on float32 masters, "
        f"remat {cfg.remat!r}: argument_size_in_bytes {args_b} (the dry "
        f"run's, world of 1); the {len(leaves)} tensors hold {exact} bytes, "
        f"which the caching allocator books as {booked} ({ALLOC_ROUND}-byte "
        f"blocks); memory_allocated grew by {grown}")
    if args_b != exact or grown != booked:
        fail(f"dryrun (b): argument bytes {args_b}, tensors {exact}, "
             f"allocator {booked}, grown {grown}: not equal")
    step = make_train_step(cfg, OptConfig())
    ops.reset_launches()
    params, opt, _ = step(params, opt, batch)       # warm: workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, opt, metrics = step(params, opt, batch)
    end.record()
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - base
    rounds = 2 if cfg.remat != "none" else 1
    if launches["flash_attention"] != 2 * rounds * cfg.n_layers:
        fail(f"dryrun (b): flash_attention launched "
             f"{launches['flash_attention']} times over two steps, want "
             f"{2 * rounds * cfg.n_layers}")
    if not math.isfinite(float(metrics["loss"])):
        fail(f"dryrun (b): loss {metrics['loss']}")
    pred_peak = args_b + temp_b
    mfu = rec["model_flops"] / (ms * 1e-3 * RL.PEAK_FLOPS)
    log(f"{tag} (b) predicted peak (arguments + traced temp) "
        f"{pred_peak / 2**30:.2f} GiB vs max_memory_allocated "
        f"{peak / 2**30:.2f} GiB (ratio {peak / pred_peak:.3f}); "
        f"t_compute {roof['t_compute_s'] * 1e3:.2f} ms, t_memory "
        f"{roof['t_memory_s'] * 1e3:.2f} ms (reckoned) vs the measured "
        f"step {ms:.2f} ms (CUDA events, flash_attention route); "
        f"model_flops / (ms x {RL.PEAK_FLOPS:g}) = {mfu:.4f}; useful "
        f"ratio {roof['useful_ratio']}; {smi}")
    del params, opt, batch, metrics
    torch.cuda.empty_cache()

    # (c) attention_chunked at the cell's attention shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device=DEVICE).manual_seed(1)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        mk = lambda *s: torch.randn(*s, generator=g, device=DEVICE).to(dt)
        q, k, v = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)
        ct = mk(B, S, Hq, D)
        errs = []
        outs = []
        for fn in (attention_chunked, attention_ref):
            xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*xs, causal=True)
            grads = torch.autograd.grad((o.float() * ct.float()).sum(), xs)
            outs.append([o.detach()] + list(grads))
        for got, want in zip(*outs):
            scale = max(1.0, want.float().abs().max().item())
            errs.append((got.float() - want.float()).abs().max().item()
                        / scale)
        log(f"{tag} (c) attention_chunked vs attention_ref, {name}, "
            f"({B}, {S}, {Hq}/{Hkv} heads, {D}), causal: max |err| / "
            f"max(1, max |ref|) of o, dq, dk, dv = "
            f"{', '.join(f'{e:.2e}' for e in errs)} (TOL {TOL[name]})")
        if max(errs) > TOL[name]:
            fail(f"dryrun (c): attention_chunked {name} off by {errs}")
    log(f"{tag} phase 10 in {time.time() - t_phase:.1f} s")
    return {"flash_attention": launches["flash_attention"]}


# ----------------------------------------------------------- phase 11
# The models on DTensors: tinyllama-1.1b at full width sharded (2 data x 2
# model) over 4 gloo ranks sharing the card, each step held to the same
# step on one rank (rank 0, plain tensors, the same weights).
# The training step's batch is phase 8's 8 x 512 cut to 4 x 512, so that
# the whole run ends within its time (PERF.md §6).
SPMD = dict(arch="tinyllama-1.1b", world=4, mesh=(2, 2), prefill=(8, 256),
            decode_steps=8, train=(4, 512))


def _spmd_steps(log_, fn, device):
    """``fn()`` timed (host clock around a synchronise) with the bytes and
    ops it handed to the collectives (the deltas of ``log_``)."""
    b0, c0 = dict(log_.bytes), dict(log_.count)
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    wire = {k: v - b0.get(k, 0) for k, v in log_.bytes.items()
            if v - b0.get(k, 0)}
    ops_ = sum(log_.count.values()) - sum(c0.values())
    return out, ms, dict(wire, count=ops_)


def _spmd_err(got, want):
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _allocated(device):
    """(memory_allocated, the allocator's requested bytes) of ``device``:
    the bytes of its blocks and the bytes the tensors asked for."""
    import torch

    if device != "cuda":
        return 0, 0
    stats = torch.cuda.memory_stats()
    return (torch.cuda.memory_allocated(),
            stats.get("requested_bytes.all.current", 0))


def _spmd_rank(device, job):
    """One of the SPMD world's ranks: (a) prefill, (b) decode, (c) one
    training step's loss and gradients, (d) the training cell's argument
    bytes and peak, (e) each step's ms and collective bytes; rank 0 also
    runs every step unsharded on plain tensors and holds the sharded
    ones to it. Every collective runs under ``CollectiveLog`` (gloo's
    CUDA all-gathers staged through host memory)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.collectives import CollectiveLog
    from repro_torch.dist.sharding import (batch_axes, distribute_tree,
                                           param_axes, tree_shardings)
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_lm, prefill
    from repro_torch.models.lm import argmax_vocab
    from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                             adamw_update, tree_leaves)
    from repro_torch.train.trainer import (loss_and_grads, make_decode_step,
                                           make_prefill_step)

    cfg = job["cfg"]
    lead = dist.get_rank() == 0
    mesh = init_device_mesh(device, job["mesh"],
                            mesh_dim_names=("data", "model"))

    def lay(tree, axes):
        return distribute_tree(tree, tree_shardings(axes, tree, mesh))

    out, errs = {}, {}
    log_ = CollectiveLog()
    gen = torch.Generator(device=device)

    # (c) + (d) first, on a fresh allocator (blocks reused inside older
    # segments would book more than their 512-byte rounding): float32
    # masters, bf16 compute, remat full
    Bt, St = job["train"]
    with log_:
        full = init_lm(cfg, gen.manual_seed(2), device, dtype=torch.float32)
        ttoks = torch.randint(0, cfg.vocab, (Bt, St), generator=gen,
                              device=device, dtype=torch.int32)
        _sync(device)
        base, asked = _allocated(device)
        P = lay(full, param_axes(cfg, full))
        O = adamw_init(P)
        batch = lay({"tokens": ttoks}, batch_axes(cfg, "train"))
        _sync(device)
        grown, asked_grown = (a - b for a, b in zip(_allocated(device),
                                                    (base, asked)))
        locs = [t.to_local() for t in tree_leaves([P, O, batch])]
        out["args_exact"] = sum(t.numel() * t.element_size() for t in locs)
        out["args_booked"] = sum(_alloc_bytes(t.numel() * t.element_size())
                                 for t in locs)
        out["args_grown"] = grown
        out["args_requested"] = asked_grown
        del locs
        ops.reset_launches()
        # one training step, make_train_step's body at one microbatch:
        # the loss and gradients, then AdamW; its peak over the memory
        # that is not its arguments'
        if device == "cuda":
            resident = torch.cuda.memory_allocated() - grown
            torch.cuda.reset_peak_memory_stats()
        (loss, m2, grads), grads_ms, grads_bytes = _spmd_steps(
            log_, lambda: loss_and_grads(P, cfg, batch), device)
        _, opt_ms, opt_bytes = _spmd_steps(
            log_, lambda: adamw_update(P, grads, O, OptConfig()), device)
        out["peak"] = (torch.cuda.max_memory_allocated() - resident
                       if device == "cuda" else 0)
        out["grads_ms"], out["train_ms"] = grads_ms, grads_ms + opt_ms
        out["train_bytes"] = {k: grads_bytes.get(k, 0) + opt_bytes.get(k, 0)
                              for k in set(grads_bytes) | set(opt_bytes)}
        out["loss"] = float(loss.full_tensor())
        out["train_loss_finite"] = math.isfinite(out["loss"])
        launches_train = ops.kernel_launches()
        # the gradients, gathered leaf by leaf (rank 0 keeps them in host
        # memory for the comparison)
        kept = []
        for g in tree_leaves(grads):
            gf = g.full_tensor()
            if lead:
                kept.append(gf.cpu())
            del gf
        del grads, loss, m2, P, O, batch
        if lead:      # the one-rank step, and the float32 compute's
            _, m1, ref = loss_and_grads(full, cfg, {"tokens": ttoks})
            errs["loss_one_rank"] = float(m1["loss"])
            f32 = dataclasses.replace(cfg, dtype="float32")
            ref32 = loss_and_grads(full, f32, {"tokens": ttoks})[2]
            errs["grads"] = [
                (i, _spmd_err(g.to(device), r), _spmd_err(g.to(device), r32),
                 _spmd_err(r, r32))
                for i, (g, r, r32) in enumerate(zip(
                    kept, tree_leaves(ref), tree_leaves(ref32),
                    strict=True))]
            del ref, ref32, m1, kept
        del full
        if device == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()

    # (a) + (b): the serving weights, bf16
    B, S = job["prefill"]
    steps = job["decode_steps"]
    with log_, torch.no_grad():
        params = init_lm(cfg, gen.manual_seed(0), device)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                             device=device, dtype=torch.int32)
        P = lay(params, param_axes(cfg, params))
        batch = lay({"tokens": toks}, batch_axes(cfg, "prefill"))
        if not lead:
            del params
        dist.barrier()
        ops.reset_launches()
        # make_prefill_step as the dry run's prefill cell runs it (its
        # cache just the prompt's), then lm.prefill into a cache with room
        # for the decode steps, whose logits and cache are held
        (tok, _), out["prefill_ms"], out["prefill_bytes"] = _spmd_steps(
            log_, lambda: make_prefill_step(cfg, S)(P, batch), device)
        logits, cache = prefill(P, cfg, batch, max_seq=S + steps)
        toks_out, dec_ms, dec_logits = [tok.full_tensor()], [], []
        out["prefill_tokens_agree"] = bool(torch.equal(
            argmax_vocab(logits[:, -1:], cfg.vocab).full_tensor(),
            toks_out[0]))
        for i in range(steps):
            t = lay({"tokens": toks_out[-1].to(torch.int32)},
                    {"tokens": batch_axes(cfg, "decode")["tokens"]})
            (lg, cache), ms, wire = _spmd_steps(
                log_, lambda: decode_step(P, cfg, t["tokens"], cache, S + i),
                device)
            dec_ms.append(ms)
            out["decode_bytes"] = wire
            dec_logits.append(lg)
            toks_out.append(argmax_vocab(lg, cfg.vocab).full_tensor())
        out["decode_ms"] = dec_ms
        launches_serve = ops.kernel_launches()
        full_logits = logits.full_tensor()
        full_cache = {k: v.full_tensor() for k, v in cache.items()}
        full_dec = [lg.full_tensor() for lg in dec_logits]
        # make_decode_step once more, as the dry run's decode cell runs it
        # (a replicated scalar cache length), its bytes for (e)
        t = lay({"tokens": toks_out[-1].to(torch.int32),
                 "cache_len": torch.tensor(S + steps - 1, dtype=torch.int32,
                                           device=device)},
                {k: batch_axes(cfg, "decode")[k]
                 for k in ("tokens", "cache_len")})
        _, _, out["decode_step_bytes"] = _spmd_steps(
            log_, lambda: make_decode_step(cfg)(P, t["tokens"], cache,
                                                t["cache_len"]), device)
        if lead:
            ops.reset_launches()
            lg1, c1 = prefill(params, cfg, {"tokens": toks}, max_seq=S + steps)
            errs["prefill_logits"] = _spmd_err(full_logits, lg1)
            ref_tok = argmax_vocab(lg1[:, -1:], cfg.vocab)
            errs["prefill_tokens_equal"] = bool(torch.equal(ref_tok,
                                                            toks_out[0]))
            dec = []
            for i in range(steps):
                lg1, c1 = decode_step(params, cfg, toks_out[i].to(torch.int32),
                                      c1, S + i)
                dec.append(_spmd_err(full_dec[i], lg1))
            errs["decode_logits"] = dec
            errs["cache"] = {k: _spmd_err(full_cache[k], c1[k])
                             for k in c1}
            del params, lg1, c1

    out["launches"] = {k: launches_serve[k] + launches_train[k]
                       for k in launches_serve}
    out["errs"] = errs
    return out


def phase_spmd(smi):
    """Phase 11: tinyllama-1.1b at full width on DTensors, (2 data x 2
    model) over 4 gloo ranks on the card, against one rank; the dry run's
    per-device prediction of the training cell held to the card. Returns
    flash_attention's launches over the sharded steps."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.comm import traced_lm
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models.config import ShapeConfig

    t_phase = time.time()
    cfg = dataclasses.replace(ARCHS[SPMD["arch"]], remat="full")
    n = SPMD["world"]
    tag = f"[spmd gloo x{n}]"
    B, S = SPMD["prefill"]
    Bt, St = SPMD["train"]
    steps = SPMD["decode_steps"]
    # the dry run of the three steps on a fake world of 4, this device's
    # mesh type (DTensor picks its redistributions by it)
    cells = {"prefill": ShapeConfig("prefill", S, B, "prefill"),
             "decode": ShapeConfig("decode", S + steps, B, "decode"),
             "train": ShapeConfig("train", St, Bt, "train")}
    traced, mem = {}, None
    t0 = time.time()
    try:
        DR.fake_world(n)
        mesh = init_device_mesh(DEVICE, SPMD["mesh"],
                                mesh_dim_names=("data", "model"))
        for kind, shape in cells.items():
            c = DR._cell_cfg(cfg, shape)
            if kind == "train":
                tr = DR.trace_lm(c, shape, mesh)
                mem = DR.lm_memory(tr, mesh)
                traced[kind] = tr.coll
            else:
                traced[kind] = traced_lm(c, shape, mesh)["coll"]
    finally:
        DR.close_world()
    log(f"{tag} the dry run's per-device trace of the three cells on a "
        f"fake world of {n} ({DEVICE} mesh): {time.time() - t0:.1f} s")
    job = dict(cfg=cfg, mesh=SPMD["mesh"], prefill=SPMD["prefill"],
               decode_steps=steps, train=SPMD["train"])
    t0 = time.time()
    ranks = run_ranks(_spmd_rank, n, DEVICE, job, backend="gloo",
                      timeout=900, pg_timeout=300)
    log(f"{tag} world of {n} ranks on one {DEVICE} device, {SPMD['mesh']} "
        f"(data x model), collectives through gloo, all-gathers staged "
        f"through pinned host memory: {time.time() - t0:.1f} s with "
        f"start-up; {smi}")
    e = ranks[0]["errs"]
    tol = TOL["bfloat16"]
    # (a) prefill
    ok_a = (e["prefill_logits"] <= tol and e["prefill_tokens_equal"]
            and max(e["cache"].values()) <= tol
            and all(r["prefill_tokens_agree"] for r in ranks))
    log(f"{tag} (a) prefill {B} x {S}, bf16, flash_attention on local "
        f"heads: logits max |sharded - one rank| / max |logit| "
        f"{e['prefill_logits']:.3e} (TOL {tol}); next tokens "
        f"{'equal' if e['prefill_tokens_equal'] else 'DIFFER'}; cache "
        + ", ".join(f"{k} {v:.3e}" for k, v in e["cache"].items())
        + " after the decode steps")
    # (b) decode
    worst_dec = max(e["decode_logits"])
    ok_b = worst_dec <= tol
    log(f"{tag} (b) {steps} decode steps on the sequence-sharded cache: "
        f"logits max |sharded - one rank| / max |logit| per step "
        + ", ".join(f"{x:.3e}" for x in e["decode_logits"])
        + f" (TOL {tol})")
    # (c) training
    bad = []
    for i, direct, far, far1 in e["grads"]:
        if direct > tol and far > far1 + tol:
            bad.append((i, direct, far, far1))
    held = sum(1 for _, d, _, _ in e["grads"] if d > tol)
    loss_err = abs(ranks[0]["loss"] - e["loss_one_rank"]) / abs(
        e["loss_one_rank"])
    ok_c = not bad and loss_err <= tol
    log(f"{tag} (c) one training step {Bt} x {St}, bf16 on float32 "
        f"masters, remat full: loss {ranks[0]['loss']:.6f} sharded vs "
        f"{e['loss_one_rank']:.6f} one rank (rel {loss_err:.2e}); "
        f"{len(e['grads'])} gradient leaves, worst |sharded - one rank| / "
        f"max {max(d for _, d, _, _ in e['grads']):.3e} (TOL {tol}); "
        f"{held} leaves past TOL held against the float32 gradient "
        f"(|sharded - f32| <= |one rank - f32| + TOL)"
        + (f", failing: {bad[:4]}" if bad else ""))
    # (d) memory
    args_b = mem["argument_size_in_bytes"]
    pred_peak = args_b + mem["temp_size_in_bytes"]
    # memory_allocated counts the allocator's blocks (``_alloc_bytes``:
    # its 512-byte rounding, and the 2 MiB segments of shards past 10
    # MiB); its requested bytes are the tensors' own
    ok_d = all(r["args_exact"] == args_b and r["args_requested"] == args_b
               and r["args_grown"] == r["args_booked"] for r in ranks)
    for i, r in enumerate(ranks):
        log(f"{tag} (d) rank {i}: argument bytes {r['args_exact']} (dry run "
            f"{args_b}); the allocator's requested bytes grew by "
            f"{r['args_requested']}, memory_allocated by {r['args_grown']} "
            f"(booked {r['args_booked']}: {ALLOC_ROUND}-byte blocks, 2 MiB "
            f"segments past 10 MiB); "
            f"max_memory_allocated over the step {r['peak'] / 2**30:.3f} "
            f"GiB vs predicted per-device peak {pred_peak / 2**30:.3f} GiB "
            f"(ratio {r['peak'] / pred_peak:.3f})")
    # (e) ms and bytes
    ok_e = True
    for kind, key in (("prefill", "prefill_bytes"),
                      ("decode", "decode_step_bytes"),
                      ("train", "train_bytes")):
        want = {k: v for k, v in traced[kind].items() if k != "total"}
        for i, r in enumerate(ranks):
            if r[key] != want:
                ok_e = False
                log(f"{tag} (e) rank {i} {kind}: handed {r[key]} != "
                    f"traced_lm {want}")
        same = all(r[key] == want for r in ranks)
        log(f"{tag} (e) {kind}: each rank handed the collectives "
            f"{ranks[0][key]}, traced_lm's count "
            f"{'equal on every rank' if same else 'DIFFERS'}")
    r0 = ranks[0]
    log(f"{tag} (e) ms on rank 0 (host clock): prefill {r0['prefill_ms']:.1f}"
        f", decode steps {', '.join(f'{x:.1f}' for x in r0['decode_ms'])}, "
        f"training step {r0['train_ms']:.1f} (loss and gradients "
        f"{r0['grads_ms']:.1f}, AdamW the rest); {smi}")
    fa = [r["launches"]["flash_attention"] for r in ranks]
    log(f"{tag} (e) flash_attention launches on local heads per rank {fa}")
    if min(fa) <= 0:
        fail(f"{tag} flash_attention never launched on a rank")
    if not all(r["train_loss_finite"] for r in ranks):
        fail(f"{tag} the training step's loss is not finite")
    for name, ok in (("a", ok_a), ("b", ok_b), ("c", ok_c), ("d", ok_d),
                     ("e", ok_e)):
        if not ok:
            fail(f"{tag} ({name}) failed")
    log(f"[spmd] phase 11 in {time.time() - t_phase:.1f} s")
    return {"flash_attention": sum(fa)}


# --------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/"
                                 "CUDA port on one GPU (see the module "
                                 "docstring).")
    ap.add_argument("--phase", choices=("dist", "spmd", "mla"),
                    help="run phases 1, 2 and this one alone (dist at its "
                    "uncut sizes); mla prints its kernels' line, the "
                    "others no result lines")
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke FAILED: src/repro_torch not found beside "
              "chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke FAILED: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()

    def timed(fn, *args):
        t0 = time.time()
        out = fn(*args)
        log(f"[time] {fn.__name__}: {time.time() - t0:.1f} s")
        return out

    smi = timed(phase_device)
    timed(phase_build)
    if opts.phase:
        if opts.phase == "dist":
            timed(phase_dist, smi, "alone")
        elif opts.phase == "mla":
            print(json.dumps({"kernels": timed(phase_mla)}))
        else:
            timed(phase_spmd, smi)
        log(f"[time] all phases: {time.time() - t_start:.1f} s")
        log(f"[summary] card: {smi}")
        return 0
    rows = timed(phase_kernels)
    moe_launches = timed(phase_moe)
    mla_rows = timed(phase_mla)
    params, totals, steps = timed(phase_serve)
    timed(phase_profile, params)
    mamba, ssd_launches = timed(phase_fabric)
    timed(phase_prefill_profile, mamba)
    mig_launches = timed(phase_migrate, params)
    zoo_launches = timed(phase_zoo)
    rows["uts_expand"], uts_launches = timed(phase_glb)
    timed(phase_parity, params, mamba)
    del params, mamba
    torch.cuda.empty_cache()
    trained = timed(phase_train, smi)
    dist = timed(phase_dist, smi)
    dry = timed(phase_dryrun, smi)
    spmd = timed(phase_spmd, smi)
    log(f"[time] all phases: {time.time() - t_start:.1f} s")
    all_steps = sum(steps.values())
    for name in ATTENTION:
        mig = mig_launches.get(name, 0)
        train = trained.get(name, 0)
        piped = dist.get(name, 0)
        dried = dry.get(name, 0)
        sharded = spmd.get(name, 0)
        rows[name]["launches"] = (totals[name] + moe_launches[name] + mig
                                  + zoo_launches[name] + train + piped
                                  + dried + sharded)
        log(f"[summary] {name}: {rows[name]['launches']} launches: "
            f"{totals[name]} over {all_steps} engine steps of the "
            f"tinyllama-1.1b runs ({totals[name] / all_steps:.2f} per "
            f"step), {moe_launches[name]} over the {MOE} runs, {mig} "
            f"over the migrate phase's three runs, {zoo_launches[name]} "
            f"over the zoo phase's runs, {train} over the training runs, "
            f"{piped} over the dist phase's pipeline ranks, {dried} over "
            f"the dryrun phase's measured training steps, {sharded} over "
            f"the spmd phase's sharded steps")
    rows["gmm"]["launches"] = (moe_launches["gmm"] + trained["gmm"]
                               + dist["gmm"])
    log(f"[summary] gmm: {rows['gmm']['launches']} launches: "
        f"{moe_launches['gmm']} over the three {MOE} runs, "
        f"{trained['gmm']} over the training runs, {dist['gmm']} over the "
        f"dist phase's expert-parallel ranks")
    rows["ssd_chunked"]["launches"] = (ssd_launches + zoo_launches[
        "ssd_chunked"] + trained["ssd_chunked"])
    log(f"[summary] ssd_chunked: {rows['ssd_chunked']['launches']} "
        f"launches: {ssd_launches} in the mamba2-130m fabric run, "
        f"{zoo_launches['ssd_chunked']} in the zamba2-7b runs, "
        f"{trained['ssd_chunked']} over the training runs")
    rows["uts_expand"]["launches"] = uts_launches + dist["uts_expand"]
    log(f"[summary] uts_expand: {rows['uts_expand']['launches']} launches: "
        f"{uts_launches} in the UTS run on {UTS_P} places, "
        f"{dist['uts_expand']} over the dist phase's UTS ranks")
    log(f"[summary] card: {smi}")
    print(json.dumps({"kernels": [rows[n] for n in REPLACES] + mla_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
