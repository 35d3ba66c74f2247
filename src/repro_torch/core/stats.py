"""GLB logging counters (paper §2.4) and result collection. The
counterpart of ``repro.core.stats``.

The paper logs, per worker: (1) time spent processing vs distributing work,
(2) random/lifeline steal requests sent and received, (3) steals perpetrated,
(4) workload sent/received. In the bulk-synchronous adaptation "time" becomes
superstep counts; everything else maps 1:1. The task executor keeps the
counters as (P,) int32 tensors on its device (``init_stats`` /
``update_stats``); ``merge_place_stats`` and ``fabric_summary`` merge
per-place stat dicts of places or serving replicas into one report.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FIELDS = (
    "processed",        # work units processed (paper: tasks computed)
    "active_steps",     # supersteps in which this place processed > 0 items
    "idle_steps",       # supersteps in which this place was hungry
    "steals_random",    # successful steals via the random round (as thief)
    "steals_lifeline",  # successful steals via a lifeline edge (as thief)
    "served",           # steals served (as victim, "perpetrated" on us)
    "items_sent",       # task items shipped out
    "items_recv",       # task items received
    "lifeline_regs",    # lifeline registrations (requests "sent")
    "max_size",         # high-water mark of the bag (capacity audit)
)


def init_stats(P: int, device=None) -> Dict[str, torch.Tensor]:
    return {f: torch.zeros((P,), dtype=torch.int32, device=device)
            for f in FIELDS}


def update_stats(
    stats: Dict[str, torch.Tensor],
    *,
    processed: torch.Tensor,      # (P,) items processed this superstep
    hungry: torch.Tensor,         # (P,) bool at match time
    src: torch.Tensor,            # (P,) victim index or -1
    via_lifeline: torch.Tensor,   # (P,) bool
    dst: torch.Tensor,            # (P,) thief index or -1
    sent: torch.Tensor,           # (P,) packet items sent
    recv: torch.Tensor,           # (P,) packet items received
    registered: torch.Tensor,     # (P,) bool — registered lifelines
    sizes: torch.Tensor,          # (P,) post-transfer bag sizes
) -> Dict[str, torch.Tensor]:
    i32 = lambda t: t.to(torch.int32)
    got = src >= 0
    s = dict(stats)
    s["processed"] = stats["processed"] + i32(processed)
    s["active_steps"] = stats["active_steps"] + i32(processed > 0)
    s["idle_steps"] = stats["idle_steps"] + i32(hungry)
    s["steals_random"] = stats["steals_random"] + i32(got & ~via_lifeline)
    s["steals_lifeline"] = stats["steals_lifeline"] + i32(got & via_lifeline)
    s["served"] = stats["served"] + i32(dst >= 0)
    s["items_sent"] = stats["items_sent"] + i32(sent)
    s["items_recv"] = stats["items_recv"] + i32(recv)
    s["lifeline_regs"] = stats["lifeline_regs"] + i32(registered)
    s["max_size"] = torch.maximum(stats["max_size"], i32(sizes))
    return s


def merge_place_stats(per_place) -> Dict[str, Dict[str, float]]:
    """Result collection (paper §2.4): reduce a list of per-place stat
    dicts — GLB places or serving replicas, any numeric fields — into one
    fabric-level report of total/mean/max(+argmax) per field. Fields are
    the union across places (a replica without a prefix cache simply
    contributes 0), so heterogeneous fabrics still merge."""
    fields: list = []
    for st in per_place:
        fields.extend(f for f in st if f not in fields)
    out: Dict[str, Dict[str, float]] = {}
    for f in fields:
        v = np.asarray([float(st.get(f, 0)) for st in per_place])
        out[f] = {
            "total": float(v.sum()),
            "mean": float(v.mean()),
            "max": float(v.max()),
            "argmax": int(v.argmax()),
        }
    return out


def fabric_summary(per_place, title: str = "fabric",
                   places: int = None) -> str:
    """Human-readable merged report, one line per field — the serving
    analogue of ``summarize`` (which formats the executor's device-array
    stats). Includes the paper's imbalance metric over whichever field
    carries the work count (``processed`` or ``tokens_out``).

    Accepts either a list of per-place stat dicts (merged here) or an
    ALREADY-merged mapping ``field -> {total, mean, max, argmax}`` such
    as the replica balancer's ``collect()`` — underscore-prefixed
    sub-reports (``"_balancer"``) are skipped, and ``places`` names the
    place count the merge no longer carries."""
    if isinstance(per_place, dict):
        merged = {f: m for f, m in per_place.items()
                  if isinstance(m, dict) and not f.startswith("_")}
        P = places if places is not None else 1 + max(
            (int(m.get("argmax", 0)) for m in merged.values()), default=0
        )
    else:
        merged = merge_place_stats(per_place)
        P = len(per_place)
    lines = [f"{title}: {P} places"]
    for f, m in merged.items():
        lines.append(
            f"  {f:<18} total={m['total']:>12.0f}  mean={m['mean']:>10.1f}"
            f"  max={m['max']:>10.0f} (place {m['argmax']})"
        )
    for work in ("processed", "tokens_out"):
        if work in merged and merged[work]["total"] > 0:
            m = merged[work]
            lines.append(
                f"  workload imbalance: max/mean="
                f"{m['max'] / max(m['mean'], 1e-9):.3f}"
            )
            break
    return "\n".join(lines)


def summarize(stats, supersteps: int) -> str:
    """Paper-style log summary across places (stats as tensors or numpy
    arrays with a leading P axis)."""
    st = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in stats.items()}
    P = st["processed"].shape[0]
    lines = [f"GLB stats over {P} places, {supersteps} supersteps"]
    for f in FIELDS:
        v = st[f]
        lines.append(
            f"  {f:<16} total={int(v.sum()):>12}  mean={v.mean():>12.1f}  "
            f"std={v.std():>10.2f}  max={int(v.max()):>10}"
        )
    proc = st["processed"].astype(np.float64)
    if proc.sum() > 0:
        # Workload-distribution quality, the paper's Fig. 6/8/10 metric.
        lines.append(
            f"  workload imbalance: max/mean={proc.max() / max(proc.mean(), 1e-9):.3f}"
            f"  std/mean={proc.std() / max(proc.mean(), 1e-9):.3f}"
        )
    return "\n".join(lines)
