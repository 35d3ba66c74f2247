"""GLB parameter auto-tuning — the paper's future-work item (4): "Provide a
mechanism to auto-tune GLB parameters (e.g., task granularity, size of
random victims/lifeline buddies)".

Strategy: short probe runs in sim mode over a small (w, z, n) grid on a
scaled-down instance of the user's problem, scored by makespan (supersteps)
with idle fraction as the tie-breaker — the quantities the paper's log
exposes for manual tuning (§2.4). Deterministic given the seed. The
counterpart of ``repro.core.autotune`` (without its TPU tile tables, which
do not carry over to the card).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Sequence

from .params import GLBParams
from .problem import GLBProblem
from .scheduler import run_sim


class TuneResult(NamedTuple):
    best: GLBParams
    table: list  # (params, supersteps, idle_frac)


def autotune(
    problem: GLBProblem,
    P: int,
    base: GLBParams = GLBParams(),
    w_grid: Sequence[int] = (0, 1, 2, 4),
    z_grid: Sequence[int] = (0, 2),          # 0 => log2(P) cap
    n_grid: Sequence[int] = (32, 128, 512),
    seed: int = 0,
    max_supersteps: int = 50_000,
    candidates=None,
    device="cuda",
) -> TuneResult:
    rows = []
    for w, z, n in itertools.product(w_grid, z_grid, n_grid):
        params = dataclasses.replace(
            base, w=w, z=z, n=n, max_supersteps=max_supersteps
        )
        out = run_sim(problem, P, params, seed=seed, candidates=candidates,
                      device=device)
        if not out.converged:
            continue
        steps = out.supersteps
        idle = float(int(out.stats["idle_steps"].sum()) / max(steps * P, 1))
        # score: wall-clock proxy = supersteps x per-superstep cost (~n)
        rows.append((params, steps, idle))
    if not rows:
        raise RuntimeError("no converging configuration found")
    rows.sort(key=lambda r: (r[1] * max(r[0].n, 1), r[2]))
    return TuneResult(best=rows[0][0], table=rows)
