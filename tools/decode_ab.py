#!/usr/bin/env python3
"""Design sweep of the bf16 decode kernels (``csrc/decode_tc.cu``) on one GPU.

    python3 tools/decode_ab.py

Times ``flash_decode`` and ``paged_decode`` (bf16, CUDA-graph replay, the
timer of ``chip_smoke.py``) at the three decode shapes the engines run, 8
slots of lengths 100-384 against a 1024-row cache (tinyllama-1.1b: 32/4
heads of 64; moonshot-v1-16b-a3b: 16/16 heads of 128; zamba2-7b: 32/32
heads of 112), for every cluster size c in {1, 2, 4, 8} and four builds of
the source:

  built       the source as committed;
  3-stage     a ring of three K/V tiles instead of two;
  no-scoring  the same loads, merges and barriers with the tensor-core
              scoring skipped: a floor under any scoring method (its
              output is not attention and is not checked);
  tc-G1       a group of one query head (moonshot) scored on a
              1-of-16-row tensor-core tile instead of the CUDA cores
              (``kCoreScoringG1`` false); other groups as built.

The variants are text edits of the committed source, built beside it
under ``build/decode_ab/``. Each (variant, c) is timed twice, the second
pass in the reverse order. Needs a CUDA device and nvcc; prints the
card's name and power limit first.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

EDITS = {
    "built": None,
    "3-stage": ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    "no-scoring": ("    if (kb >= hi) continue;", "    continue;"),
    "tc-G1": ("constexpr bool kCoreScoringG1 = true;",
              "constexpr bool kCoreScoringG1 = false;"),
}
CLUSTERS = (1, 2, 4, 8)
SHAPES = {"tinyllama": (32, 4, 64), "moonshot": (16, 16, 128),
          "zamba2": (32, 32, 112)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    source = _build.SOURCES["decode_tc"]
    text = source.read_text()
    out_dir = _build.BUILD_DIR.parent / "decode_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.HEADERS:
        shutil.copy(header, out_dir / header.name)
    libs = {}
    for name, edit in EDITS.items():
        if edit is not None:
            if text.count(edit[0]) != 1:
                raise SystemExit(f"decode_ab: {edit[0]!r} is not in "
                                 f"{source} exactly once")
            path = out_dir / f"decode_tc_{name}.cu"
            path.write_text(text.replace(*edit))
            _build.SOURCES["decode_tc"] = path
        _build._libs.pop("decode_tc", None)
        libs[name] = _build.lib("decode_tc")
    _build.SOURCES["decode_tc"] = source

    rng = np.random.default_rng(0)
    S, Bs, B = 1024, 16, 8
    NB = B * S // Bs
    rnd = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to("cuda", torch.bfloat16)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device="cuda")
    cases = {}
    for shape, (hq, hkv, d) in SHAPES.items():
        lens = rng.integers(100, 385, B)
        q, k, v = rnd(B, 1, hq, d), rnd(B, S, hkv, d), rnd(B, S, hkv, d)
        kp, vp = rnd(NB, Bs, hkv, d), rnd(NB, Bs, hkv, d)
        bt, ln = i32(cs._tables(rng, lens, S // Bs, NB)), i32(lens)
        cases[shape, "flash_decode"] = (
            lambda q=q, k=k, v=v, ln=ln: fd.flash_decode(q, k, v, ln),
            fd.decode_ref(q, k, v, ln))
        cases[shape, "paged_decode"] = (
            lambda q=q, kp=kp, vp=vp, bt=bt, ln=ln: pd.paged_decode(
                q, kp, vp, bt, ln),
            pd.paged_decode_ref(q, kp, vp, bt, ln))

    plan = _build.decode_plan
    times = {}
    try:
        for sweep in range(2):
            order = [(n, c) for n in libs for c in CLUSTERS]
            for name, c in (order if sweep == 0 else order[::-1]):
                _build._libs["decode_tc"] = libs[name]
                _build.decode_plan = lambda B, H, G, c=c: (c, None)
                for key, (fn, want) in cases.items():
                    got = fn()
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    if name != "no-scoring" and err > cs.TOL["bfloat16"]:
                        raise SystemExit(f"{name} c={c} {key}: max_abs_err "
                                         f"{err}")
                    ms, _ = cs.time_ms(fn, iters=50)
                    times.setdefault((*key, name, c), [err]).append(ms * 1e3)
    finally:
        _build.decode_plan = plan
        _build._libs.pop("decode_tc", None)
    chosen = {shape: plan(B, hkv, hq // hkv)[0]
              for shape, (hq, hkv, _) in SHAPES.items()}
    print(f"max_abs_err, then us per call in each pass; decode_plan picks "
          f"c = {chosen}")
    for (shape, kernel, name, c), (err, *us) in sorted(times.items()):
        print(f"{shape:9s} {kernel:12s} {name:10s} c={c} {err:.3e} "
              + " ".join(f"{t:.2f}" for t in us))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
