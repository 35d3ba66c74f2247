"""repro_torch.core — the paper's contribution: lifeline-based global load
balancing. The counterpart of ``repro.core``.

Layout:
  params.py    — GLBParams (the paper's w / z / n tunables + packet caps)
  taskbag.py   — array-backed TaskBag for P places at once
  problem.py   — the TaskQueue/TaskBag user contract, batched over places
  lifeline.py  — lifeline topology + the deterministic steal matching
                 (numpy, on the host)
  scheduler.py — superstep loop over P simulated places of one device
  executor.py  — the same superstep, one place per process, collectives
                 over a ``torch.distributed`` mesh dimension
  stats.py     — the paper's per-worker logging counters, merged reports
  api.py       — GLB facade (paper's ``GLB.run``)
  autotune.py  — (w, z, n) probe-run auto-tuning
"""
from .api import GLB
from .executor import (GLBDistRun, ShardmapLowering, build_place_fn,
                       lower_shardmap, run_shardmap)
from .lifeline import (MatchResult, diffusion_pairs, lifeline_buddies,
                       lifeline_mask, match_steals, random_candidates,
                       rewire_lifelines, terminated)
from .params import GLBParams
from .problem import GLBProblem
from .scheduler import GLBRun, run_sim
from .stats import fabric_summary, merge_place_stats

__all__ = [
    "GLB",
    "GLBParams",
    "GLBProblem",
    "GLBRun",
    "run_sim",
    "GLBDistRun",
    "build_place_fn",
    "run_shardmap",
    "lower_shardmap",
    "ShardmapLowering",
    "MatchResult",
    "diffusion_pairs",
    "lifeline_buddies",
    "lifeline_mask",
    "match_steals",
    "random_candidates",
    "rewire_lifelines",
    "terminated",
    "merge_place_stats",
    "fabric_summary",
]
