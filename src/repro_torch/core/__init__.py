"""repro_torch.core — the paper's lifeline-based global load balancing,
on the host in numpy (P is the number of serving replicas):

  params.py   — GLBParams (the paper's w / z / n tunables + packet caps)
  lifeline.py — lifeline topology + the deterministic steal matching
  stats.py    — result collection: merged per-place stats
"""
from .lifeline import (MatchResult, diffusion_pairs, lifeline_buddies,
                       lifeline_mask, match_steals, random_candidates,
                       rewire_lifelines, terminated)
from .params import GLBParams
from .stats import fabric_summary, merge_place_stats

__all__ = [
    "GLBParams",
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
