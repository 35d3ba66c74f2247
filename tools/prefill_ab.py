#!/usr/bin/env python3
"""Design sweep of the bf16 chunked-prefill kernel on one GPU.

    python3 tools/prefill_ab.py [--parent DIR]

Times ``paged_prefill`` (``csrc/attention_tc.cu``, bf16, CUDA-graph
replay, the timer of ``chip_smoke.py``) at the two chunk shapes the
engines run, one 64-token chunk at offset 128 through a scrambled block table (tinyllama-1.1b: 32/4
heads of 64; moonshot-v1-16b-a3b: 16/16 heads of 128), for every cluster
size c in {1, 2, 4, 8} and five builds of the source:

  built       the source as committed (two key slices at D 128, one at
              D 64);
  1-slice     4 warps a block, one on each 16 rows;
  2-slices    8 warps a block, two on each 16 rows, each scoring half of
              every key tile, merged in shared memory at the end;
  no-scoring  the same loads and merges with the scoring skipped: a floor
              under any scoring method (its output is not attention and
              is not checked);
  no-table    the key rows read in logical order, the block table never
              read: what the table's reads cost (not checked either);

beside the CUDA-core ``paged_prefill_kernel`` the bf16 route replaced.
With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) it also
builds that checkout's ``attention_tc.cu`` and times ``flash_attention``
at both 256-token prompt shapes through it and through the committed
source, in turns (parent, built, built, parent in each pass), to show
whether sharing the tile loop moved it. Its ``repro_flash_attention_tc``
must take this checkout's arguments (``D`` and ``Dv`` both).

The variants are built beside the committed source under
``build/prefill_ab/``. Each case is timed twice, the second pass in the
reverse order. Needs a CUDA device and nvcc; prints the card's name and
power limit first.
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

KT = "    const bf16* kt = ks + ((j & 1) * kBN + slice * KB) * LD;\n"
SLICES = "constexpr int kPrefillSlices = D >= 128 ? 2 : 1;"
EDITS = {
    "built": None,
    "1-slice": (SLICES, "constexpr int kPrefillSlices = 1;"),
    "2-slices": (SLICES, "constexpr int kPrefillSlices = 2;"),
    "no-scoring": (KT, "    continue;\n" + KT),
    "no-table": ("    int phys = table[pos / block_size];\n",
                 "    int phys = pos / block_size;\n"),
}
CLUSTERS = (1, 2, 4, 8)
SHAPES = {"tinyllama": (32, 4, 64), "moonshot": (16, 16, 128)}
OFFSET, CHUNK, S, BS = 128, 64, 1024, 16


def _load(name, path, out_dir, only=None):
    """Build ``path`` as the attention_tc library ``name`` (its headers
    copied beside it) and load it; ``only`` limits the entry points."""
    from repro_torch.kernels import _build

    dst = out_dir / f"attention_tc_{name}.cu"
    if path != dst:
        shutil.copy(path, dst)
    sources, sigs = dict(_build.SOURCES), dict(_build.SIGNATURES)
    _build.SOURCES["attention_tc"] = dst
    if only is not None:
        _build.SIGNATURES["attention_tc"] = {
            k: v for k, v in sigs["attention_tc"].items() if k in only}
    try:
        _build._libs.pop("attention_tc", None)
        return _build.lib("attention_tc")
    finally:
        _build.SOURCES.update(sources)
        _build.SIGNATURES.update(sigs)
        _build._libs.pop("attention_tc", None)


def main(parent) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    source = _build.SOURCES["attention_tc"]
    text = source.read_text()
    out_dir = _build.BUILD_DIR.parent / "prefill_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.HEADERS:
        shutil.copy(header, out_dir / header.name)
    libs = {}
    for name, edit in EDITS.items():
        path = source
        if edit is not None:
            if text.count(edit[0]) != 1:
                raise SystemExit(f"prefill_ab: {edit[0]!r} is not in "
                                 f"{source} exactly once")
            path = out_dir / f"attention_tc_{name}.cu"
            path.write_text(text.replace(*edit))
        libs[name] = _load(name, path, out_dir)
    if parent is not None:
        libs["parent"] = _load(
            "parent", Path(parent) / "src/repro_torch/csrc/attention_tc.cu",
            out_dir, only=("repro_flash_attention_tc",))

    rng = np.random.default_rng(0)
    MB = S // BS
    NB = 8 * MB
    rnd = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", torch.bfloat16)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    prefill, prompt = {}, {}
    for shape, (hq, hkv, d) in SHAPES.items():
        lens = [OFFSET + CHUNK]
        q = rnd(1, CHUNK, hq, d)
        kp, vp = rnd(NB, BS, hkv, d), rnd(NB, BS, hkv, d)
        bt = i32(cs._tables(rng, lens, MB, NB))
        ln, off = i32(lens), i32([OFFSET])
        args = (q, kp, vp, bt, ln, off)
        prefill[shape] = (args, pd.paged_prefill_ref(*args))
        qp, kd, vd = rnd(1, 256, hq, d), rnd(1, 256, hkv, d), rnd(1, 256, hkv,
                                                                   d)
        prompt[shape] = ((qp, kd, vd), fa.attention_ref(qp, kd, vd))

    plan = _build.prefill_plan
    times = {}

    def run(key, fn, want, check=True):
        got = fn()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if check and err > cs.TOL["bfloat16"]:
            raise SystemExit(f"{key}: max_abs_err {err}")
        ms, _ = cs.time_ms(fn, iters=50)
        times.setdefault(key, [err]).append(ms * 1e3)

    try:
        for sweep in range(2):
            order = [(n, c) for n in EDITS for c in CLUSTERS]
            for name, c in (order if sweep == 0 else order[::-1]):
                _build._libs["attention_tc"] = libs[name]
                _build.prefill_plan = lambda *a, c=c: (c, None)
                for shape, (args, want) in prefill.items():
                    run((shape, "paged_prefill", name, c),
                        lambda a=args: pd.paged_prefill(*a), want,
                        name not in ("no-scoring", "no-table"))
            _build.prefill_plan = plan
            for shape, (args, want) in prefill.items():
                run((shape, "paged_prefill", "cuda-core", 1),
                    lambda a=args: cs._cuda_core_prefill(*a), want)
            if parent is not None:
                for name in ("parent", "built", "built", "parent"):
                    _build._libs["attention_tc"] = libs[name]
                    for shape, (args, want) in prompt.items():
                        run((shape, "flash_attention", name, 1),
                            lambda a=args: fa.flash_attention(*a), want)
    finally:
        _build.prefill_plan = plan
        _build._libs.pop("attention_tc", None)
    chosen = {shape: plan(1, hkv, hq // hkv, CHUNK)[0]
              for shape, (hq, hkv, _) in SHAPES.items()}
    print(f"max_abs_err, then us per call in each pass; prefill_plan picks "
          f"c = {chosen}")
    for (shape, kernel, name, c), (err, *us) in sorted(times.items()):
        print(f"{shape:9s} {kernel:15s} {name:10s} c={c} {err:.3e} "
              + " ".join(f"{t:.2f}" for t in us))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit, to time its "
                         "flash_attention_tc_kernel beside this one")
    ns = ap.parse_args()
    parent = os.path.abspath(ns.parent) if ns.parent else None
    os.chdir(ROOT)
    sys.exit(main(parent))
