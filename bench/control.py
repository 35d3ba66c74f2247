#!/usr/bin/env python3
"""Readings that set a cell's limit: for each seed, one run of the cell at
its own size and load (a short window), the widest gap of the served
tokens under the reference, and, for the seeds named by
``--control-seeds``, the widest gap of the control (the layout's
reference, ``reference.<layout>``, below the configuration's precision:
float8 for the dense layout) and the ``correct`` that the run's own
checks give it. One process, one JSON line a seed, then a summary line.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 20
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import gc

    import torch
    from harness import runner
    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = runner.run(cell, seed, args.seconds, False, "cuda:0", t0,
                         control=seed in ctl)
        c = out.get("control")
        row = {"seed": seed, "correct": out["correct"],
               "gap": out["checks"]["logit_gap"]["value"],
               "control_correct": c["correct"] if c else None,
               "control_gap": c["checks"]["logit_gap"]["value"] if c else None,
               "served_tokens_distinct": out.get("served"),
               "attempted": out["attempted"], "failed": out["failed"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gaps = [r["gap"] for r in rows]
    ctls = [r["control_gap"] for r in rows if r["control_gap"] is not None]
    print(json.dumps({"workload": args.workload, "lower": max(gaps),
                      "upper": min(ctls) if ctls else None,
                      "limit": out["checks"]["logit_gap"]["limit"],
                      "correct": [r["correct"] for r in rows],
                      "control_correct": [r["control_correct"] for r in rows
                                          if r["control_gap"] is not None],
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
