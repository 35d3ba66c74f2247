#!/usr/bin/env python3
"""The knee of an open-loop cell: the cell's engine and mix at each of
several arrival rates, one window each, in one process. For each rate it
prints the requests due in the window, the backlog (due, not yet
admitted) when the window opens and when it closes, the requests whose
first token came in the window, and the p90 of their TTFT. The knee is
the highest rate whose backlog does not grow over the window.

    python3 bench/sweep.py --workload <cell> --rates 1.5,2,2.5 --seconds 40
"""
import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def backlog(recs, t):
    return sum(1 for r in recs if r.due <= t
               and (r.t_first is None or r.t_first > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--warmup", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "bench" / "nv")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import gc

    import torch
    from harness import system
    from harness.serve import LoadLoop
    from harness.spec import load_cell
    from harness.stats import percentile
    from harness.traffic import Traffic
    from layouts import layout_of

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    dev = torch.device("cuda:0")
    mcfg = system.model_config(cell.config)
    params = system.make_params(cell.config, mcfg, args.seed, dev)
    V = layout_of(cell.config).dims(cell.config)["V"]
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic,
                   load=dict(cell.traffic["load"], rate_per_s=rate))
        eng = system.make_engine(mcfg, params, cell.engine, dev)
        drv = LoadLoop(eng, Traffic(mix, args.seed, V), cell.engine,
                       args.seconds)
        drv.run_poisson(args.warmup, tail=False)
        w0, w1 = drv.window
        first = [(r.t_first - r.due) * 1e3 for r in drv.recs
                 if r.t_first is not None and w0 <= r.t_first < w1]
        print(json.dumps({
            "rate_per_s": rate,
            "due": sum(1 for r in drv.recs if r.window),
            "backlog_open": backlog(drv.recs, w0),
            "backlog_close": backlog(drv.recs, w1),
            "first_tokens": len(first),
            "ttft_p90_ms": percentile(first, 90) if first else None,
            "steps": sum(1 for s in drv.steps if s.window),
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del eng, drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
