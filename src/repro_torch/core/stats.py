"""GLB result collection (paper §2.4): per-place stats merged into one
fabric report. The counterpart of ``repro.core.stats`` (its
``merge_place_stats`` and ``fabric_summary``; the task executor's
per-superstep counters come with the executor's slice).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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
