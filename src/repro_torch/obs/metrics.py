"""Metrics registry: counters, gauges, and fixed-bucket histograms with
``snapshot()``/``merge()`` compatible with ``core.stats.merge_place_stats``
plus Prometheus text rendering for a future ingress.

This is the aggregate half of the observability layer (``obs.trace`` is
the timeline half): per-replica registries record request-latency
distributions (TTFT, time-per-output-token, queue wait, prefill chunk
ms, migration bytes/ms) and the fabric merges them the same way GLB
result collection merges place stats — ``snapshot()`` flattens every
instrument to plain numeric fields, so the existing
``merge_place_stats`` / ``fabric_summary`` machinery consumes registries
without knowing they exist.

Histograms are **fixed-bucket**: merging across replicas is exact
(bucket counts add), and quantiles are estimated by linear interpolation
inside the covering bucket — within one bucket width of the true sample
quantile by construction (asserted against numpy quantiles in
``tests/test_obs.py``). All instruments are plain-python and update in
O(1); nothing here touches the device.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, Optional, Sequence

# Default latency buckets (ms): geometric-ish 0.05ms .. 30s. The serving
# engine's TTFT/queue-wait/chunk timings land here; fixed across the
# fabric so per-replica histograms merge bucket-for-bucket.
DEFAULT_MS_BUCKETS = (
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
    500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
)
# Byte-size buckets (KiB-scale) for migration payloads.
DEFAULT_BYTE_BUCKETS = tuple(float(4 ** k * 256) for k in range(12))


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value (``set``) with a ``set_max`` helper for
    high-water marks."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are the finite upper edges
    (ascending); one overflow bucket catches the rest. Tracks count,
    sum, min, max alongside the bucket counts, so snapshots expose both
    exact moments and estimated quantiles."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BUCKETS):
        # User input is validated with real exceptions, not asserts —
        # asserts vanish under ``python -O`` and a silently-accepted bad
        # bucket layout corrupts every merge downstream.
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if not all(a < b for a, b in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram bounds must be strictly ascending: {bounds}"
            )
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1): linear interpolation inside
        the covering bucket, clamped to the observed min/max so tiny
        samples do not report a bucket edge nobody hit."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.vmax)
                frac = (rank - cum + 1) / c     # position inside bucket
                est = lo + (hi - lo) * min(frac, 1.0)
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def merge_from(self, other: "Histogram") -> None:
        if self.bounds != other.bounds:
            raise ValueError(
                "cannot merge histograms with different bucket layouts: "
                f"{self.bounds} vs {other.bounds}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Named instruments with lazy creation: ``counter(name)`` /
    ``gauge(name)`` / ``histogram(name, bounds)`` return the existing
    instrument or make one. A name belongs to exactly one kind."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def _check_unique(self, name: str, kind: dict) -> None:
        for d in (self._counters, self._gauges, self._hists):
            if d is not kind and name in d:
                raise ValueError(f"metric {name!r} already registered "
                                 "as a different kind")

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._check_unique(name, self._counters)
            self._counters[name] = Counter()
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._check_unique(name, self._gauges)
            self._gauges[name] = Gauge()
        return self._gauges[name]

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        if name not in self._hists:
            self._check_unique(name, self._hists)
            self._hists[name] = Histogram(bounds)
        return self._hists[name]

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict — the per-replica unit GLB result collection
        reduces (``merge_place_stats`` consumes these directly).
        Histograms flatten to ``_count/_sum/_mean/_p50/_p99/_max``."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._hists.items():
            out[f"{name}_count"] = float(h.count)
            out[f"{name}_sum"] = round(h.total, 6)
            out[f"{name}_mean"] = round(h.mean, 6)
            out[f"{name}_p50"] = round(h.quantile(0.50), 6)
            out[f"{name}_p99"] = round(h.quantile(0.99), 6)
            out[f"{name}_max"] = round(h.vmax, 6) if h.count else 0.0
        return out

    # --------------------------------------------------------------- merge
    @staticmethod
    def merged(regs: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
        """Exact fabric-level merge: counters add, gauges take the max
        (every gauge in this stack is a high-water mark or a level whose
        fabric-wide worst case is the interesting number), histograms
        merge bucket counts — so quantiles of the MERGED distribution
        are available, not averages of per-replica quantiles."""
        out = MetricsRegistry()
        for reg in regs:
            for name, c in reg._counters.items():
                out.counter(name).inc(c.value)
            for name, g in reg._gauges.items():
                out.gauge(name).set_max(g.value)
            for name, h in reg._hists.items():
                out.histogram(name, h.bounds).merge_from(h)
        return out

    # ---------------------------------------------------------- prometheus
    def render_prometheus(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition format (the contract a future
        ingress scrapes). Histograms use cumulative ``_bucket{le=}``
        series per the spec."""
        lines: List[str] = []
        for name in sorted(self._counters):
            full = prefix + name
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {_fmt(self._counters[name].value)}")
        for name in sorted(self._gauges):
            full = prefix + name
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {_fmt(self._gauges[name].value)}")
        for name in sorted(self._hists):
            h = self._hists[name]
            full = prefix + name
            lines.append(f"# TYPE {full} histogram")
            cum = 0
            for bound, c in zip(h.bounds, h.counts):
                cum += c
                lines.append(f'{full}_bucket{{le="{_fmt(bound)}"}} {cum}')
            lines.append(f'{full}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{full}_sum {_fmt(h.total)}")
            lines.append(f"{full}_count {h.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def quantiles_from_values(values: Sequence[float], qs: Sequence[float],
                          bounds: Optional[Sequence[float]] = None
                          ) -> List[float]:
    """Convenience: run ``values`` through a fresh fixed-bucket histogram
    and read the requested quantiles — what a bench row does to report
    registry-derived percentiles next to numpy ones."""
    h = Histogram(bounds if bounds is not None else DEFAULT_MS_BUCKETS)
    for v in values:
        h.observe(v)
    return [h.quantile(q) for q in qs]
