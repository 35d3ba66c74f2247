#!/usr/bin/env python3
"""Design sweep of the SSD chunk-scan kernels (``csrc/ssd.cu``) on one GPU.

    python3 tools/ssd_ab.py [--quick]

Times ``ssd_chunked`` (CUDA-graph replay, the timer of ``chip_smoke.py``)
at the two prefill buckets the mamba2-130m engine runs, x (1, 256, 24, 64)
and (1, 1024, 24, 64) in bf16, N 128, chunk 64:

  ssd_chunked_kernel, as built, at every cluster size c in {1, 2, 4, 8}
  and column tile pt in {16, 32, 64} (the launch plan's choice printed);
  then at the plan's (c, pt), builds of the source with one change each:
    cuda-cores   the four products on the CUDA cores (FMAs in the same
                 warp tiles, on the same split operands) instead of bf16x3
                 on the tensor cores;
    1xbf16       one bf16 pass instead of three (not float32-accurate:
                 the output is not checked; what the split costs);
    noinline     the steps of a chunk (load, state, mask, the y products)
                 compiled once each and called, not inlined at every use:
                 less code for the instruction cache to hold;
    no-CB        C B^T and its mask left out: the most that sharing the
                 product across the blocks of a chunk could save;
    no-state     the state update left out; no-combine  the cluster's
    no-out       reads of its predecessors' states, the y products, left
    no-loads     out; the reads of B and C left out (their planes zero),
    no-x         the reads of x and dt for dt x left out (none of these
                 is checked);
    empty        the same grid, cluster and shared memory, returning at
                 once: the launch floor;
    timeline     thread 0 of each block records the clock at the end of
                 each step (B and C in shared memory, the scan and dt x,
                 the weighted dt x, its state, the first cluster barrier,
                 the combine, the work that overlaps the second barrier,
                 that barrier, y), read back once at the 256-token
                 bucket; timeline+no-loads and timeline+no-x the same
                 with those reads left out;
  and ssd_chunked_loop_kernel (the first version of the kernel, the
  chunks in order), as built and with one phase left out at a time
  (loop-no-CB, loop-no-loads, loop-no-intra: the masked product,
  loop-no-state: C h_in and the state update; none checked), which splits
  its time.

Every variant that computes the function is held against
``ssd_chunked_ref`` (``chip_smoke.py``'s element-wise rule) before it is
timed. The variants are text edits of the committed source, written under
``build/ssd_ab/`` and built in parallel, one nvcc each. Each case is timed
twice, the second pass in the reverse order (``--quick``: once, the
cluster grid at the plan's tile only). Needs a CUDA device and nvcc;
prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"T256": dict(Bt=1, T=256, H=24, P=64, N=128),
          "T1024": dict(Bt=1, T=1024, H=24, P=64, N=128)}
CHUNK = 64
CLUSTERS = (1, 2, 4, 8)
TILES = (16, 32, 64)
# name: (text edits of ssd.cu, checked against the plain version)
# Thread 0 of each block records clock64() at the ends of its phases and a
# resident block writes them over the start of its own y tile.
TIMELINE = (
    ("  int tid, warp, g, t4;\n",
     "  int tid, warp, g, t4;\n  long long tl0 = 0;\n"
     "  unsigned tlx[3] = {};\n"),
    ("    // s = A cumsum(dt): warp 0, two steps a lane, a shuffle scan.\n",
     "    tlx[0] = clock64() - tl0;\n"),
    ("#pragma unroll\n    for (int i = 0; i < kPairs; ++i) {  // pW",
     "    tlx[1] = clock64() - tl0;\n"
     "#pragma unroll\n    for (int i = 0; i < kPairs; ++i) {  // pW"),
    ("    __syncthreads();\n  }\n\n  // S = B^T diag",
     "    __syncthreads();\n    tlx[2] = clock64() - tl0;\n  }\n\n"
     "  // S = B^T diag"),
    ("  const bool resident = j1 - j0 == 1;  // the run's one chunk stays "
     "loaded\n",
     "  const bool resident = j1 - j0 == 1;\n"
     "  const long long tl0 = clock64();\n  unsigned tl[6] = {};\n"
     "  blk.tl0 = tl0;\n"),
    ("    if (tid == 0) blk.sdec[1] = D;\n",
     "    tl[0] = clock64() - tl0;\n    if (tid == 0) blk.sdec[1] = D;\n"),
    ("    cluster_wait();\n\n    // (2) The combine",
     "    cluster_wait();\n    tl[1] = clock64() - tl0;\n\n"
     "    // (2) The combine"),
    ("    cluster_arrive_release();\n    // While the other blocks' writes",
     "    tl[2] = clock64() - tl0;\n    cluster_arrive_release();\n"
     "    // While the other blocks' writes"),
    ("    cluster_wait();                    // every h_in is written, no S "
     "read\n",
     "    tl[3] = clock64() - tl0;\n    cluster_wait();\n"
     "    tl[4] = clock64() - tl0;\n"),
    ("      blk.out(j0, acc, j0 > 0);\n      return;\n",
     "      blk.out(j0, acc, j0 > 0);\n      __syncthreads();\n"
     "      tl[5] = clock64() - tl0;\n      if (tid == 0) {\n"
     "        unsigned* d = reinterpret_cast<unsigned*>(\n"
     "            y + (blk.row0(j0) * H + blk.h) * P + blk.p0);\n"
     "        for (int i = 0; i < 3; ++i) d[i] = blk.tlx[i];\n"
     "        for (int i = 0; i < 6; ++i) d[3 + i] = tl[i];\n      }\n"
     "      return;\n"),
)
NO_LOADS = (("        const bool live = i < total && r < L && col < N;",
             "        const bool live = false;"),)
NO_X = (("      if (t < L) {\n        const int64_t r = r0 + t;\n"
         "        const float d = dt[r * H + h];",
         "      if (false) {\n        const int64_t r = r0 + t;\n"
         "        const float d = dt[r * H + h];"),)
PHASES = ("B/C", "scan+dtx", "weights", "state", "wait1", "combine",
          "overlap", "wait2", "out")
EDITS = {
    "built": ((), True),
    "cuda-cores": ((("constexpr bool kTensorCores = true;",
                     "constexpr bool kTensorCores = false;"),), True),
    "1xbf16": ((("        tc::mma_bf16(small[i], al, bh[2 * i], "
                 "bh[2 * i + 1]);\n        tc::mma_bf16(small[i], ah, "
                 "bl[2 * i], bl[2 * i + 1]);\n", ""),), False),
    "noinline": (tuple((f"  __device__ void {f}", f"  __device__ __noinline__ "
                        f"void {f}") for f in (
        "load(int j) {", "state(bool first", "mask() const {",
        "intra(float", "out(int j")), True),
    "no-CB": ((("    if (m0 >= Lp || n0 > m0) return;\n",
                "    return;\n"),), False),
    "no-state": ((("    const float el = first ? 0.f : sdec[0];\n",
                   "    return;\n    const float el = first ? 0.f : "
                   "sdec[0];\n"),), False),
    "no-combine": ((("         e < e1; e += kCThreads) {",
                     "         e < 0; e += kCThreads) {"),), False),
    "no-out": ((("    return n0 < PT && m0 < Lp;", "    return false;"),),
               False),
    "no-loads": (NO_LOADS, False),
    "no-x": (NO_X, False),
    "timeline": (TIMELINE, False),
    "timeline+no-loads": (TIMELINE + NO_LOADS, False),
    "timeline+no-x": (TIMELINE + NO_X, False),
    "empty": ((("  extern __shared__ __align__(16) float smem[];\n"
                "  cg::cluster_group",
                "  return;\n  extern __shared__ __align__(16) float "
                "smem[];\n  cg::cluster_group"),), False),
    "loop-no-CB": ((("        for (int n = 0; n < N; n += 4) {\n"
                     "          const float b0 = brow[n]",
                     "        for (int n = 0; n < 0; n += 4) {\n"
                     "          const float b0 = brow[n]"),), False),
    "loop-no-loads": ((("    for (int i = tid; i < L * n4; i += kThreads) {",
                        "    for (int i = tid; i < 0; i += kThreads) {"),),
                      False),
    "loop-no-intra": ((("        for (int u = 0; u <= t; ++u) {",
                        "        for (int u = 0; u < 0; ++u) {"),), False),
    "loop-no-state": ((("        for (int n = 0; n < N; n += 4) {\n"
                        "          const float4 cv",
                        "        for (int n = 0; n < 0; n += 4) {\n"
                        "          const float4 cv"),
                       ("      for (int u = 0; u < L; ++u) {\n"
                        "        const float w = se[u];",
                        "      for (int u = 0; u < 0; ++u) {\n"
                        "        const float w = se[u];")), False),
}


def _build_variants(out_dir):
    """Every variant's library, one nvcc each, all running together."""
    from repro_torch.kernels import _build

    source = _build.SOURCES["ssd"]
    text = source.read_text()
    for header in _build.HEADERS:
        shutil.copy(header, out_dir / header.name)
    started = {}
    try:
        for name, (edits, _) in EDITS.items():
            variant = text
            for old, new in edits:
                if variant.count(old) != 1:
                    raise SystemExit(f"ssd_ab: {old!r} is not in {source} "
                                     "exactly once")
                variant = variant.replace(old, new)
            path = out_dir / f"ssd_{name}.cu"
            path.write_text(variant)
            _build.SOURCES["ssd"] = path
            started[name] = _build._start("ssd")
        paths = {name: _build._finish("ssd", *s)
                 for name, s in started.items()}
    finally:
        _build.SOURCES["ssd"] = source
    return {name: _load(path) for name, path in paths.items()}


def _load(path):
    import ctypes

    from repro_torch.kernels import _build

    handle = ctypes.CDLL(str(path))
    for fn_name, argtypes in _build.SIGNATURES["ssd"].items():
        fn = getattr(handle, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def main(quick: bool) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_ssd as ms

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    out_dir = _build.BUILD_DIR.parent / "ssd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = _build_variants(out_dir)

    rng = np.random.default_rng(0)
    cases = {}
    for shape, shp in SHAPES.items():
        args = cs._ssd_inputs(rng, torch.bfloat16, **shp)
        cases[shape] = (args, ms.ssd_chunked_ref(*args, chunk=CHUNK),
                        _build.ssd_plan(shp["Bt"], shp["T"], shp["H"],
                                        shp["P"], shp["N"], CHUNK))
    runs = []          # (label, variant, shape, cluster, tile, loop, check)
    for shape, (_, _, (c0, pt0, _, _)) in cases.items():
        for c in CLUSTERS:
            for pt in (TILES if not quick else (pt0,)):
                runs.append(("sweep", "built", shape, c, pt, False, True))
        for name, (_, check) in EDITS.items():
            if name == "built":
                continue
            loop = name.startswith("loop-")
            runs.append(("variant", name, shape, c0, pt0, loop, check))
        runs.append(("variant", "loop", shape, c0, pt0, True, True))
    times = {}
    try:
        for sweep in range(1 if quick else 2):
            for label, name, shape, c, pt, loop, check in (
                    runs if sweep == 0 else runs[::-1]):
                args, (yr, hr), _ = cases[shape]
                _build._libs["ssd"] = libs["built" if name == "loop"
                                           else name]
                fn = lambda a=args, c=c, pt=pt, loop=loop: ms._launch(
                    *a, CHUNK, cluster=c, tile=pt, loop=loop)
                y, h = fn()
                torch.cuda.synchronize()
                ry = cs._ssd_err(y, yr, cs.SSD_REL["bfloat16"])[1]
                rh = cs._ssd_err(h, hr, 0.0)[1]
                if check and (ry > 1.0 or rh > 1.0):
                    raise SystemExit(f"ssd_ab: {name} {shape} c {c} pt "
                                     f"{pt} disagrees: y {ry}, h {rh}")
                ms_k, _ = cs.time_ms(fn, iters=50)
                key = (shape, label, name, c if not loop else 0,
                       pt if not loop else 16)
                times.setdefault(key, [check, ry, rh]).append(ms_k * 1e3)
    finally:
        _build._libs.pop("ssd", None)
    timelines = [_timeline(name, libs[name], *cases["T256"])
                 for name in EDITS if name.startswith("timeline")]
    print("checked, y and h share of their limit, then us per call in each "
          "pass; ssd_plan picks " + ", ".join(
              f"{s}: c {p[0]} pt {p[1]} ({p[2]} chunks a block, grid "
              f"{p[3]})" for s, (_, _, p) in cases.items()))
    for (shape, label, name, c, pt), (check, ry, rh, *us) in times.items():
        print(f"{shape:6s} {label:8s} {name:14s} c={c} pt={pt:2d} "
              f"{str(check):5s} {ry:.3f} {rh:.3f} "
              + " ".join(f"{t:.2f}" for t in us))
    print("\n".join(timelines))
    return 0


def _timeline(name, lib, args, _want, plan):
    """One launch of the timeline build at ``plan``: the mean over heads,
    for each block rank, of where its thread 0 was at the end of each
    phase (cycles from its start, and us at the SM clock read after)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_ssd as ms

    c, pt, per, grid = plan
    if per != 1:
        return "timeline: runs of more than one chunk are not recorded"
    _build._libs["ssd"] = lib
    try:
        y, _ = ms._launch(*args, CHUNK, cluster=c, tile=pt)
        torch.cuda.synchronize()
    finally:
        _build._libs.pop("ssd", None)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    words = y.contiguous().view(torch.int32)[0].cpu()   # (T, H, P / 2)
    tiles = grid[1] // args[0].shape[2]
    L = args[0].shape[1] // c
    lines = [f"{name} (T256, c {c}, pt {pt}; SM clock {mhz:g} MHz): "
             "end of each phase, cycles from the block's start (us)"]
    for k in range(c):
        ends = torch.stack([words[k * L, yb // tiles,
                                  (yb % tiles) * pt // 2:][:9]
                            for yb in range(grid[1])]).double().mean(0)
        lines.append(f"  block {k}: " + ", ".join(
            f"{name} {v:.0f} ({v / mhz:.2f})"
            for name, v in zip(PHASES, ends.tolist())))
    return "\n".join(lines)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one pass; the cluster sweep at the plan's tile")
    ns = ap.parse_args()
    os.chdir(ROOT)
    sys.exit(main(ns.quick))
