#!/usr/bin/env python3
"""Runs one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up builds or loads the port's kernels
(into ``build/repro_torch/``), makes the weights on the card from the
seed, fills the engine and brings it to steady state; the window then
runs for ``--seconds``; the reference checks what was served. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit (also the last lines of standard error). Without a CUDA device, or
with fewer than the cell asks for, it prints no result and exits 3.
"""
import time

_T_CALL = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from its start
    time in /proc; where that cannot be read, this module's first line)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return min(_T_CALL, time.perf_counter() - max(age, 0.0))
    except (OSError, ValueError, IndexError):
        return _T_CALL


def banned_modules():
    """Loaded modules whose top-level name (the part before the first dot)
    is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(BANNED))


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    t_imp = time.perf_counter()
    try:
        import torch
        t_torch = time.perf_counter()
        from harness import runner
        from harness.spec import load_cell
        cell = load_cell(args.workload)
    except (ImportError, OSError, KeyError, ValueError) as e:
        print(f"error: cannot load the cell or the system: {e!r}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    t_prog = time.perf_counter()
    torch.zeros(1, device="cuda:0")
    print(f"set-up: interpreter {t_imp - t_process:.2f} s, torch "
          f"{t_torch - t_imp:.2f} s, the program {t_prog - t_torch:.2f} s, "
          f"CUDA context {time.perf_counter() - t_prog:.2f} s",
          file=sys.stderr)
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", t_process)
    found = banned_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    print(json.dumps({k: out[k] for k in keys if k in out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
