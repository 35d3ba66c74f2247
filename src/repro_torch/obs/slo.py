"""SLO monitoring: declared latency targets, rolling attainment windows,
and multi-window burn-rate alerts. A copy of ``repro.obs.slo``.

SLO-aware admission and scheduling need a measurement
substrate before any scheduler can optimize against it — this module is
that substrate. An :class:`SLOMonitor` holds declared targets (TTFT,
TPOT, queue wait — any ms-valued metric the engine observes), keeps a
rolling window of pass/fail samples per target, and evaluates
**multi-window burn rates** (the Google SRE alerting recipe): with an
objective of 99%, the error budget is 1%, and the *burn rate* is the
observed error rate divided by that budget. An alert fires only when
the burn exceeds the threshold in BOTH a long window (is the budget
really being consumed?) and a short window (is it still happening
NOW?) — fast detection without flapping on a single slow request.

Alert transitions are emitted as ``slo_burn`` / ``slo_burn_clear``
trace instants on the fabric track and counted in the registry, so the
analyzer (``obs.analyze``) and the fabric report both surface them.
Wiring: ``Engine(..., slo=monitor)`` feeds per-request observations at
the same sites that feed the metrics histograms;
``GLBReplicaBalancer(..., slo=monitor)`` binds the fabric tracer/pid,
calls :meth:`SLOMonitor.check` each balance pass, and appends
attainment lines to ``report()``.

Timestamps are explicit parameters (defaulting to the trace clock) so
tests drive the windows deterministically without monkeypatching.
Everything is plain python and O(window) worst case; the monitor is
optional everywhere and costs nothing when absent.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from .trace import NULL_TRACER, now_us

# (long_window_s, short_window_s, burn_rate_threshold): page-worthy fast
# burn and a slower ticket-worthy burn — the standard SRE pairing,
# scaled down to bench-run durations.
DEFAULT_WINDOWS = ((60.0, 5.0, 14.0), (300.0, 25.0, 6.0))


@dataclass(frozen=True)
class SLOTarget:
    """``metric`` must stay under ``threshold_ms`` for at least
    ``objective`` of requests (e.g. TTFT < 250 ms for 99%)."""
    metric: str
    threshold_ms: float
    objective: float = 0.99

    def __post_init__(self):
        if self.threshold_ms <= 0:
            raise ValueError(
                f"SLO threshold for {self.metric!r} must be positive, "
                f"got {self.threshold_ms}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO objective for {self.metric!r} must be in (0, 1), "
                f"got {self.objective}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


def parse_slo_spec(spec: str) -> List[SLOTarget]:
    """Parse a CLI spec like ``"ttft_ms=250,tpot_ms=50"`` (optionally
    ``ttft_ms=250@0.999`` to override the 99% objective)."""
    targets: List[SLOTarget] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad SLO spec {part!r}: expected metric=threshold_ms")
        metric, rhs = part.split("=", 1)
        objective = 0.99
        if "@" in rhs:
            rhs, obj = rhs.split("@", 1)
            objective = float(obj)
        targets.append(SLOTarget(metric.strip(), float(rhs),
                                 objective))
    return targets


class SLOMonitor:
    """Rolling SLO attainment + multi-window burn-rate alerting over
    declared targets. One monitor serves a whole fabric: every replica's
    engine/scheduler feeds ``observe()``, the balancer calls ``check()``
    once per superstep."""

    def __init__(self, targets: Iterable[SLOTarget],
                 windows: Tuple[Tuple[float, float, float], ...]
                 = DEFAULT_WINDOWS,
                 tracer=None, metrics=None, pid: int = 0):
        targets = list(targets)
        if not targets:
            raise ValueError("SLOMonitor needs at least one target")
        seen = set()
        for t in targets:
            if t.metric in seen:
                raise ValueError(f"duplicate SLO target {t.metric!r}")
            seen.add(t.metric)
        for long_s, short_s, burn in windows:
            if short_s >= long_s:
                raise ValueError(
                    f"short window {short_s}s must be < long window "
                    f"{long_s}s")
            if burn <= 1.0:
                raise ValueError(
                    f"burn threshold {burn} must be > 1 (1.0 = exactly "
                    "consuming the budget)")
        self.targets: Dict[str, SLOTarget] = {t.metric: t
                                              for t in targets}
        self.windows = tuple(windows)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.pid = pid
        horizon = max(w[0] for w in self.windows)
        self._horizon_us = horizon * 1e6
        # per metric: (ts_us, ok) samples within the longest window,
        # plus all-time totals for attainment reporting.
        self._samples: Dict[str, Deque[Tuple[float, bool]]] = {
            m: deque() for m in self.targets}
        self._total: Dict[str, int] = {m: 0 for m in self.targets}
        self._bad: Dict[str, int] = {m: 0 for m in self.targets}
        self._alerting: Dict[str, bool] = {m: False for m in self.targets}
        self.alerts_fired = 0

    def bind(self, tracer=None, metrics=None,
             pid: Optional[int] = None) -> None:
        """Late wiring: the balancer attaches its fabric tracer/pid to a
        monitor constructed before the fabric existed. Only unset
        fields are filled — explicit construction args win."""
        if tracer is not None and self.tracer is NULL_TRACER:
            self.tracer = tracer
        if metrics is not None and self.metrics is None:
            self.metrics = metrics
        if pid is not None and self.pid == 0:
            self.pid = pid

    def target_ms(self, metric: str) -> Optional[float]:
        """Declared threshold for ``metric`` in ms, or None when no
        target was declared — the scheduler's SLO-aware admission
        (DESIGN.md §16) reads its TTFT/queue-wait budgets through this
        instead of poking at ``targets`` directly."""
        t = self.targets.get(metric)
        return t.threshold_ms if t is not None else None

    # ------------------------------------------------------------- feeding
    def observe(self, metric: str, value_ms: float,
                ts_us: Optional[float] = None) -> None:
        """Record one request-level sample. Metrics without a declared
        target are ignored — call sites stay unconditional."""
        t = self.targets.get(metric)
        if t is None:
            return
        ts = now_us() if ts_us is None else ts_us
        ok = value_ms <= t.threshold_ms
        self._samples[metric].append((ts, ok))
        self._total[metric] += 1
        if not ok:
            self._bad[metric] += 1
        if self.metrics is not None:
            self.metrics.counter(f"slo_{metric}_total").inc()
            if not ok:
                self.metrics.counter(f"slo_{metric}_violations").inc()
        self._prune(metric, ts)

    def _prune(self, metric: str, now: float) -> None:
        q = self._samples[metric]
        cutoff = now - self._horizon_us
        while q and q[0][0] < cutoff:
            q.popleft()

    # ------------------------------------------------------------ alerting
    def _burn(self, metric: str, window_s: float, now: float) -> float:
        """Error rate inside the window divided by the error budget."""
        t = self.targets[metric]
        cutoff = now - window_s * 1e6
        total = bad = 0
        for ts, ok in reversed(self._samples[metric]):
            if ts < cutoff:
                break
            total += 1
            if not ok:
                bad += 1
        if total == 0:
            return 0.0
        return (bad / total) / t.error_budget

    def check(self, ts_us: Optional[float] = None) -> List[str]:
        """Evaluate every (target × window-pair); returns the metrics
        currently in alert. Fires ``slo_burn`` on entering the alert
        state and ``slo_burn_clear`` on leaving it (state transitions
        only — a sustained burn is ONE alert, not one per check)."""
        now = now_us() if ts_us is None else ts_us
        alerting: List[str] = []
        for metric in self.targets:
            self._prune(metric, now)
            hit = None
            for long_s, short_s, threshold in self.windows:
                burn_long = self._burn(metric, long_s, now)
                burn_short = self._burn(metric, short_s, now)
                if burn_long > threshold and burn_short > threshold:
                    hit = (long_s, short_s, threshold,
                           burn_long, burn_short)
                    break
            if hit is not None:
                alerting.append(metric)
            if hit is not None and not self._alerting[metric]:
                self._alerting[metric] = True
                self.alerts_fired += 1
                if self.metrics is not None:
                    self.metrics.counter("slo_burn_alerts").inc()
                if self.tracer.enabled:
                    long_s, short_s, threshold, bl, bs = hit
                    self.tracer.instant(
                        "slo_burn", pid=self.pid,
                        args={"metric": metric,
                              "threshold_ms":
                                  self.targets[metric].threshold_ms,
                              "window_s": long_s,
                              "burn_long": round(bl, 2),
                              "burn_short": round(bs, 2),
                              "burn_threshold": threshold})
            elif hit is None and self._alerting[metric]:
                self._alerting[metric] = False
                if self.tracer.enabled:
                    self.tracer.instant("slo_burn_clear", pid=self.pid,
                                        args={"metric": metric})
        return alerting

    # ----------------------------------------------------------- reporting
    def attainment(self) -> Dict[str, Dict[str, float]]:
        """All-time attainment per target (the fabric report's SLO
        block): observed fraction vs objective, sample counts, and
        whether the target was met."""
        out: Dict[str, Dict[str, float]] = {}
        for metric, t in self.targets.items():
            total, bad = self._total[metric], self._bad[metric]
            attained = (total - bad) / total if total else 1.0
            out[metric] = {
                "threshold_ms": t.threshold_ms,
                "objective": t.objective,
                "attained": attained,
                "total": float(total),
                "violations": float(bad),
                "met": float(attained >= t.objective),
            }
        return out

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict for ``collect()``-style merging (same shape
        contract as registry snapshots)."""
        out: Dict[str, float] = {"slo_burn_alerts":
                                 float(self.alerts_fired)}
        for metric, a in self.attainment().items():
            out[f"slo_{metric}_attained"] = round(a["attained"], 6)
            out[f"slo_{metric}_met"] = a["met"]
            out[f"slo_{metric}_total"] = a["total"]
            out[f"slo_{metric}_violations"] = a["violations"]
        return out

    def report_lines(self) -> List[str]:
        lines = []
        for metric, a in self.attainment().items():
            status = "MET" if a["met"] else "MISSED"
            lines.append(
                f"slo {metric} < {a['threshold_ms']:g}ms: "
                f"{100 * a['attained']:.2f}% attained "
                f"(objective {100 * a['objective']:g}%, "
                f"{int(a['violations'])}/{int(a['total'])} over) "
                f"[{status}]")
        if self.alerts_fired:
            lines.append(f"slo burn alerts fired: {self.alerts_fired}")
        return lines
