"""A steady slice of whole engine steps under ``torch.profiler``, reduced
to what the per-layer metrics read: the slice's length, the union of the
device's operation intervals (busy), device seconds by kernel name and by
kernel class, and the idle gaps labelled by what the host was doing.

Kernel classes are data: each ``bench/kernel_classes/<class>.json``
holds ``{"match": [substrings]}``; a kernel belongs to the first class
(by file name) one of whose substrings its name contains. A kernel that
no class matches is listed, so that a later change can add its class as
a file of its own.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

SLICE = "bench.slice"


def load_classes(folder: Path) -> List[Tuple[str, List[str]]]:
    return [(p.stem, json.loads(p.read_text())["match"])
            for p in sorted(folder.glob("*.json"))]


def classify(name: str, classes) -> Optional[str]:
    for cls, subs in classes:
        if any(s in name for s in subs):
            return cls
    return None


@dataclasses.dataclass
class Trace:
    slice_s: float
    busy_s: float
    by_name: Dict[str, float]
    by_class: Dict[str, float]
    gaps: List[Tuple[str, float]]
    unclassified: List[str]


class SliceProfiler:
    """Profiles the engine steps between the first boundary at or after
    ``start_at()`` and the first boundary ``length_s`` after the profiler
    has started (starting it takes a second or two)."""

    def __init__(self, start_at: Callable[[], float], length_s: float,
                 sync):
        self.start_at, self.length_s, self.sync = start_at, length_s, sync
        self.prof = self.rf = None
        self.t0 = None
        self.done = False

    def boundary(self, now: float) -> bool:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.done:
            return False
        if self.prof is None:
            if now < self.start_at() or now == float("inf"):
                return False
            self.sync()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.rf = torch.profiler.record_function(SLICE)
            self.rf.__enter__()
            self.t0 = time.perf_counter()
            return True
        if now != float("inf") and \
                time.perf_counter() - self.t0 < self.length_s:
            return True
        self.sync()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True
        return False

    def reduce(self, classes) -> Optional[Trace]:
        if self.prof is None or not self.done:
            return None
        return reduce_events(_events(self.prof), classes)


def _events(prof):
    """(name, on_device, start_us, end_us) of every profiled event."""
    from torch.autograd import DeviceType

    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                        s + e.duration_ns() / 1e3))
    except AttributeError:
        for e in prof.events():
            out.append((e.name, e.device_type == DeviceType.CUDA,
                        e.time_range.start, e.time_range.end))
    return out


def reduce_events(events, classes, gap_floor_us: float = 20.0) -> Trace:
    """``events``: (name, on_device, start_us, end_us). The slice is the
    host range named ``bench.slice``; device operations are clipped to
    it."""
    lo, hi = next((s, e) for n, dev, s, e in events
                  if n == SLICE and not dev)
    dev = sorted((s, e, n) for n, d, s, e in events
                 if d and n != SLICE and e > lo and s < hi)
    by_name: Dict[str, float] = {}
    merged: List[List[float]] = []
    for s, e, n in dev:
        s, e = max(s, lo), min(e, hi)
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e6
    by_class: Dict[str, float] = {}
    unclassified = set()
    for n, sec in by_name.items():
        cls = classify(n, classes)
        if cls is None:
            unclassified.add(n)
            cls = "other"
        by_class[cls] = by_class.get(cls, 0.0) + sec
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] - edges[k] > 0]
    return Trace((hi - lo) / 1e6, busy, by_name, by_class,
                 _label_gaps(events, gaps, lo, hi, gap_floor_us),
                 sorted(unclassified))


def _label_gaps(events, gaps, lo, hi, floor_us):
    """Idle seconds by the innermost host operation running at each gap's
    middle (gaps under ``floor_us`` summed apart)."""
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n != SLICE and e > lo and s < hi)
    starts = [h[0] for h in host]
    totals: Dict[str, float] = {}
    short = 0.0
    active: List[tuple] = []
    k = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        if e - s < floor_us:
            short += (e - s) / 1e6
            continue
        mid = (s + e) / 2
        j = bisect.bisect_right(starts, mid)
        active.extend(host[k:j])
        k = max(k, j)
        active = [h for h in active if h[1] > mid]
        label = max(active)[2] if active else "host, no operation"
        totals[label] = totals.get(label, 0.0) + (e - s) / 1e6
    if short:
        totals[f"gaps under {floor_us:g} us"] = short
    return sorted(totals.items(), key=lambda kv: -kv[1])
