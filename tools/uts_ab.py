#!/usr/bin/env python3
"""Design sweep of the UTS expansion kernel (``csrc/uts.cu``) on one GPU.

    python3 tools/uts_ab.py

Times ``uts_expand`` (CUDA-graph replay, the timer of ``chip_smoke.py``)
at the UTS path's shape, 1024 nodes x 256 lanes, for nine builds of
the source and the first version of the kernel:

  built          the source as committed (2 lanes a thread, 8-byte
                 stores, the binary search);
  1-lane, 4-lanes, 8-lanes
                 1 lane a thread (4-byte stores), 4 or 8 (16-byte stores);
  32-compares    the count by the 32 compares even for a sorted table;
  4-lanes-32-compares  both;
  scalar-stores  4-byte stores only (a thread's lanes one by one);
  no-count       the count left out (its output is not checked): a floor
                 under any way of counting;
  empty          the same grid returning at once: the floor of a launch;
  lane-kernel    uts_expand_lane_kernel, one thread a (node, lane), the
                 thresholds in shared memory (the kernel the port called
                 before).

The variants are text edits of the committed source, built beside it
under ``build/uts_ab/``. Each is timed twice, the second pass in the
reverse order. Needs a CUDA device and nvcc; prints the card's name and
power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LANES = {n: ("constexpr int kVec = 2;", f"constexpr int kVec = {n};")
         for n in (1, 4, 8)}
COMPARES = ("  if (sorted) {\n", "  if (false) {\n")
EDITS = {
    "built": (),
    "1-lane": (LANES[1],),
    "4-lanes": (LANES[4],),
    "8-lanes": (LANES[8],),
    "32-compares": (COMPARES,),
    "4-lanes-32-compares": (LANES[4], COMPARES),
    "scalar-stores": (("const bool vec_rows = W % kVec == 0;",
                       "const bool vec_rows = false;"),),
    "no-count": (("mv[e] = child_count(h0, thr, sorted);", "mv[e] = 0;"),),
    "empty": (("  const unsigned W = kW > 0 ? kW : W_rt;\n",
               "  return;\n  const unsigned W = kW > 0 ? kW : W_rt;\n"),),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("uts_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import uts_expand as ue

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    source = _build.SOURCES["uts"]
    text = source.read_text()
    out_dir = _build.BUILD_DIR.parent / "uts_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, edits in EDITS.items():
        if edits:
            variant = text
            for old, new in edits:
                if variant.count(old) != 1:
                    raise SystemExit(f"uts_ab: {old!r} is not in {source} "
                                     "exactly once")
                variant = variant.replace(old, new)
            path = out_dir / f"uts_{name}.cu"
            path.write_text(variant)
            _build.SOURCES["uts"] = path
        _build._libs.pop("uts", None)
        libs[name] = _build.lib("uts")
    _build.SOURCES["uts"] = source

    M, W = cs.UTS_MAIN["M"], cs.UTS_MAIN["W"]
    args = cs._uts_inputs(np.random.default_rng(0), M, 0, 32)
    want = ue.uts_expand_ref(*args, W)
    runs = {name: "repro_uts_expand" for name in EDITS}
    runs["lane-kernel"] = "repro_uts_expand_lane"
    times = {}
    try:
        for sweep in range(2):
            order = list(runs)
            for name in (order if sweep == 0 else order[::-1]):
                _build._libs["uts"] = libs.get(name, libs["built"])
                fn = lambda e=runs[name]: ue._launch(e, *args, W)
                same = all(torch.equal(g, x) for g, x in zip(fn(), want))
                if name not in ("no-count", "empty") and not same:
                    raise SystemExit(f"uts_ab: {name} is not bit-exact")
                ms, _ = cs.time_ms(fn, iters=50)
                times.setdefault(name, [same]).append(ms * 1e3)
    finally:
        _build._libs.pop("uts", None)
    print(f"M {M} x W {W}: bit-exact, then us per call in each pass")
    for name, (same, *us) in times.items():
        print(f"{name:20s} {same!s:5s} " + " ".join(f"{t:.2f}" for t in us))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
