#!/usr/bin/env python3
"""What the serving engine's tracing costs, on one GPU: the steps of one
engine, timed on the host clock with its ``Tracer`` on and off in turn.

    python3 tools/trace_ab.py [--workload nemo-docqa-batch] [--steps 20]
                              [--prompt 1024] [--seed 1]

Builds the engine and the weights of a benchmark cell as
``bench/run.py`` does (``bench/harness/system.py``), fills every slot
with a prompt of ``--prompt`` tokens whose output is long enough that no
request finishes, then times ``2 * --steps`` steps, each ending in the
engine's own drain: every one decodes ``steps_per_sync`` tokens for
every slot and admits nothing, so the steps differ only in the tracer.
The engine, its scheduler and its phase spans switch between the tracer
and none before each step, in the order on, off, off, on, ... Prints the
card's name and power limit, each side's median, quartiles and mean, the
median of the differences within each run of four steps, and the host
time spent inside the tracing calls of a traced step, timed around each
call (a step's time jitters by more than tracing costs). Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
DEVICE = "cuda:0"


def _time_calls(phases, tracer) -> list:
    """Time every call into the engine's phase spans and its tracer's
    counters from outside (calls they make themselves are not counted
    twice): [seconds, calls], summed from now on."""
    total = [0.0, 0]
    depth = [0]

    def timed(fn):
        def call(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    total[0] += time.perf_counter() - t0
                    total[1] += 1
        return call

    for name in ("begin", "end", "stop_clock", "synced", "unwind",
                 "resolve"):
        setattr(phases, name, timed(getattr(phases, name)))
    tracer.counter = timed(tracer.counter)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="nemo-docqa-batch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    device = torch.device(DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("trace_ab: no CUDA device", file=sys.stderr)
        return 2
    from harness import system
    from harness.spec import load_cell
    from repro_torch.obs import NULL_TRACER

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cell = load_cell(args.workload)
    e = cell.engine
    mcfg = system.model_config(cell.config)
    params = system.make_params(cell.config, mcfg, args.seed, device)
    tracer = system.make_tracer()
    eng = system.make_engine(mcfg, params, e, device, tracer)
    phases = eng._phases
    iters = 2 * args.steps + 2
    room = e["max_seq"] - 1 - args.prompt
    if room < iters * e["steps_per_sync"]:
        raise SystemExit(f"trace_ab: {args.prompt}-token prompts leave "
                         f"room for {room} tokens, {iters} steps need "
                         f"{iters * e['steps_per_sync']}")
    gen = torch.Generator().manual_seed(args.seed)
    V = mcfg.vocab
    for i in range(e["max_slots"]):
        prompt = torch.randint(1, V, (args.prompt,), generator=gen)
        eng.submit(system.Request(rid=i, prompt=prompt.tolist(),
                                  max_new=room))
    eng.step()                                  # the fill, untimed
    eng.step()
    inside = _time_calls(phases, tracer)
    on_ms, off_ms = [], []
    for k in range(2 * args.steps):
        on = k % 4 in (0, 3)
        eng.tracer = eng.sched.tracer = tracer if on else NULL_TRACER
        eng._phases = phases if on else None
        t0 = time.perf_counter()
        eng.step()
        (on_ms if on else off_ms).append((time.perf_counter() - t0) * 1e3)
    assert all(r is not None and not r.done for r in eng.slots)
    for name, ms in (("on", on_ms), ("off", off_ms)):
        q = statistics.quantiles(ms, n=4)
        print(f"tracer {name}: {len(ms)} steps, median {q[1]:.3f} ms "
              f"(quartiles {q[0]:.3f}, {q[2]:.3f}), mean "
              f"{statistics.fmean(ms):.3f} ms")
    # each run of four steps (on, off, off, on) gives one difference
    pairs = [(on_ms[j] + on_ms[j + 1] - off_ms[j] - off_ms[j + 1]) / 2
             for j in range(0, len(on_ms) - 1, 2)]
    q = statistics.quantiles(pairs, n=4)
    print(f"on - off: median {q[1]:.3f} ms a step over {len(pairs)} runs "
          f"of four (quartiles {q[0]:.3f}, {q[2]:.3f}); {args.workload}, "
          f"{e['max_slots']} slots, {e['steps_per_sync']} tokens a step")
    print(f"inside the tracing calls: {inside[0] / len(on_ms) * 1e6:.1f} "
          f"us a traced step ({inside[1] / len(on_ms):.1f} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
