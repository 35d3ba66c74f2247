"""Trace analytics: the *consume* side of the observability layer. A
copy of ``repro.obs.analyze`` (stdlib only), so that the port reads its
own traces without the JAX package.

The GLB paper's scaling argument is an accounting exercise — §2.4 logs
per-worker time processing vs distributing, steals sent/received, and
workload shipped, and the efficiency table is those numbers reduced.
This module reproduces that table from OUR artifacts: it loads a Chrome
trace (a file written by ``Tracer.write``/``FlightRecorder.write``, a
raw trace dict, or a live tracer via its ``dump()``) and answers the
paper's questions against the serving fabric:

* **per-request waterfalls** — every request's wall-clock is carved
  exhaustively into ``queued / prefill / decode / preempted / migrating
  / unattributed`` from its async lifecycle spans, stitched across pids
  when the request migrated (span ownership travels with the request,
  DESIGN.md §10). ``unattributed`` is the residual by construction, so
  the buckets always sum to the wall-clock exactly; the invariant
  checked here (and gated in CI) is that the residual stays ≤1%.
* **per-replica utilization** — busy/prefill/decode/migrate splits and
  idle fractions from the duration spans, the paper's "time computing
  vs distributing" per place.
* **steal efficiency** — decode-time moved per migration KiB and moves
  per steal round, from the fabric balancer's instants + the migrated
  requests' own post-migration decode time: the paper's efficiency
  metrics recomputed from the timeline rather than from counters.
* **critical path** — the p99-latency request's waterfall, the thing a
  future SLO-aware scheduler must shorten.

Everything is stdlib-only (CI's analyze gate runs before any heavyweight
import) and renders as markdown (``render_markdown``) or JSON via the
CLI::

    python -m repro_torch.obs.analyze trace.json
    python -m repro_torch.obs.analyze trace.json --json --max-unattributed 0.01

The CLI exits non-zero on validator errors or attribution-invariant
violations — it IS the CI gate, not just a report generator.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .trace import validate_chrome_trace

# Lifecycle phase -> attribution bucket. A "queued" segment that follows
# a preemption is re-bucketed to "preempted": the request already held a
# slot, so that wait is scheduler-induced, not arrival queueing. A
# "queued" segment that follows a crash re-admission (a ``readmitted``
# instant) is re-bucketed to "recovering" for the same reason — that
# wait is failure-induced, not arrival queueing (DESIGN.md §15).
PHASE_BUCKET = {
    "queued": "queued",
    "prefill": "prefill",
    "decode": "decode",
    "migrate": "migrating",
}
BUCKETS = ("queued", "prefill", "decode", "preempted", "migrating",
           "recovering", "unattributed")


@dataclass
class Segment:
    """One contiguous phase occupation of a request's timeline."""
    phase: str
    bucket: str
    pid: int
    t0: float
    t1: float

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class RequestBreakdown:
    """One request's exhaustive wall-clock waterfall: lifecycle buckets,
    the segment list behind them, and its preemption/migration/
    re-admission event counts."""

    rid: str
    t_begin: float
    t_end: float
    buckets: Dict[str, float]
    segments: List[Segment]
    replicas: List[int]
    preemptions: int = 0
    migrations: int = 0
    readmissions: int = 0           # crash re-admissions (replica died)
    migration_bytes: float = 0.0
    post_migration_decode_us: float = 0.0
    tokens: int = 0
    flushed: bool = False
    truncated: bool = False

    @property
    def wall_us(self) -> float:
        return self.t_end - self.t_begin

    @property
    def unattributed_us(self) -> float:
        return self.buckets.get("unattributed", 0.0)

    @property
    def unattributed_frac(self) -> float:
        w = self.wall_us
        return self.unattributed_us / w if w > 0 else 0.0


@dataclass
class ReplicaReport:
    """One replica's busy/prefill/decode/migrate/idle split over the
    trace window — the paper's time-computing-vs-distributing row."""

    pid: int
    name: str
    window_us: float
    busy_us: float
    prefill_us: float
    decode_us: float
    migrate_us: float
    steps: int

    @property
    def idle_us(self) -> float:
        return max(0.0, self.window_us - self.busy_us)

    @property
    def utilization(self) -> float:
        return self.busy_us / self.window_us if self.window_us > 0 else 0.0


@dataclass
class StealReport:
    """Fabric-level steal efficiency — the paper's table, from traces."""
    supersteps: int = 0
    steal_rounds: int = 0
    tier1_rounds: int = 0           # rounds containing a queue steal
    tier2_rounds: int = 0           # rounds containing a live migration
    tier1_moves: int = 0            # queued requests re-submitted
    tier2_moves: int = 0            # live KV migrations landed
    tier2_modes: Dict[str, int] = field(default_factory=dict)
    migration_bytes: float = 0.0
    moved_decode_us: float = 0.0    # decode time requests ran post-move
    terminated_at_superstep: Optional[int] = None
    replicas_dead: int = 0          # replica_dead instants (DESIGN.md §15)
    readmissions: int = 0           # request_readmitted instants
    wedged: bool = False            # fabric_wedged instant present

    @property
    def moves(self) -> int:
        return self.tier1_moves + self.tier2_moves

    @property
    def moves_per_steal_round(self) -> float:
        return self.moves / self.steal_rounds if self.steal_rounds else 0.0

    # Per-tier round math: each tier divided by the rounds in which THAT
    # tier fired. The old single ratio silently mixed a double-counted
    # balancer total into one denominator, over-crediting queue steals
    # whenever live migrations also ran.
    @property
    def tier1_moves_per_round(self) -> float:
        return self.tier1_moves / self.tier1_rounds if self.tier1_rounds \
            else 0.0

    @property
    def tier2_moves_per_round(self) -> float:
        return self.tier2_moves / self.tier2_rounds if self.tier2_rounds \
            else 0.0

    @property
    def moved_decode_us_per_kib(self) -> float:
        kib = self.migration_bytes / 1024.0
        return self.moved_decode_us / kib if kib > 0 else 0.0


@dataclass
class TenantPrediction:
    """Per-tenant decode-length prediction accuracy, from the
    ``cost_sample`` instants the engine emits at request finish."""
    tenant: str
    samples: int = 0
    mean_abs_err: float = 0.0        # tokens
    bias: float = 0.0                # mean (predicted - actual), tokens


@dataclass
class PredictionReport:
    """Prediction-error attribution for the cost model (DESIGN.md §16):
    how far the decode-length predictions were from reality, per tenant
    and over time. ``early``/``late`` split the samples chronologically
    in half — a converging online predictor shows late ≤ early."""
    samples: int = 0
    mean_abs_err: float = 0.0        # tokens, all samples
    bias: float = 0.0                # mean signed error, tokens
    early_abs_err: float = 0.0       # first half of the run
    late_abs_err: float = 0.0        # second half of the run
    tenants: List[TenantPrediction] = field(default_factory=list)

    @property
    def converging(self) -> bool:
        return self.samples < 2 or self.late_abs_err <= self.early_abs_err


@dataclass
class TraceAnalysis:
    """The full analysis of one trace: request waterfalls, replica
    utilization, steal efficiency, and (when the cost model ran)
    prediction-error attribution — everything the markdown/JSON
    renderers and the CI invariants read."""

    requests: List[RequestBreakdown]
    replicas: List[ReplicaReport]
    steal: StealReport
    validator_problems: List[str]
    window_us: float
    slo_burn_alerts: int = 0
    flight: Optional[dict] = None
    prediction: Optional[PredictionReport] = None

    def request(self, rid) -> Optional[RequestBreakdown]:
        want = rid if str(rid).startswith("req") else f"req{rid}"
        for r in self.requests:
            if r.rid == want:
                return r
        return None

    def p99_request(self) -> Optional[RequestBreakdown]:
        return self.quantile_request(0.99)

    def quantile_request(self, q: float) -> Optional[RequestBreakdown]:
        done = [r for r in self.requests if r.wall_us > 0]
        if not done:
            return None
        done.sort(key=lambda r: r.wall_us)
        return done[min(int(q * (len(done) - 1) + 0.999999),
                        len(done) - 1)]

    def bucket_totals(self) -> Dict[str, float]:
        out = {b: 0.0 for b in BUCKETS}
        for r in self.requests:
            for b, v in r.buckets.items():
                out[b] = out.get(b, 0.0) + v
        return out

    def to_dict(self) -> dict:
        d = asdict(self)
        for r, rd in zip(self.requests, d["requests"]):
            rd["wall_us"] = r.wall_us
            rd["unattributed_frac"] = r.unattributed_frac
        for r, rd in zip(self.replicas, d["replicas"]):
            rd["idle_us"] = r.idle_us
            rd["utilization"] = r.utilization
        d["steal"]["moves"] = self.steal.moves
        d["steal"]["moves_per_steal_round"] = \
            self.steal.moves_per_steal_round
        d["steal"]["tier1_moves_per_round"] = \
            self.steal.tier1_moves_per_round
        d["steal"]["tier2_moves_per_round"] = \
            self.steal.tier2_moves_per_round
        d["steal"]["moved_decode_us_per_kib"] = \
            self.steal.moved_decode_us_per_kib
        if self.prediction is not None:
            d["prediction"]["converging"] = self.prediction.converging
        d["bucket_totals"] = self.bucket_totals()
        return d


# --------------------------------------------------------------- loading
def _load(source: Any) -> dict:
    """Accept a file path, a trace dict, or a live tracer (anything with
    ``dump()``)."""
    if isinstance(source, str):
        with open(source) as f:
            return json.load(f)
    if isinstance(source, dict):
        return source
    if hasattr(source, "dump"):
        return source.dump()
    raise TypeError(f"cannot load a trace from {type(source).__name__}")


# ----------------------------------------------------------- request pass
def _parse_requests(events: Sequence[dict]
                    ) -> Tuple[List[RequestBreakdown], float]:
    """Reconstruct per-request waterfalls from the async lifecycle
    events. The tracer guarantees one open phase per request at a time
    and closes under the PREVIOUS owner's pid on migration, so a plain
    linear scan per id recovers the exact segment list; the residual
    (transition gaps, pre-first-phase time) lands in ``unattributed``."""
    reqs: Dict[str, RequestBreakdown] = {}
    open_phase: Dict[str, Tuple[str, float, int]] = {}
    after_preempt: Dict[str, bool] = {}
    after_readmit: Dict[str, bool] = {}
    first_migrate_in: Dict[str, float] = {}
    migration_bytes = 0.0

    def close(rid: str, ts: float) -> None:
        op = open_phase.pop(rid, None)
        if op is None:
            return
        phase, t0, pid = op
        bucket = PHASE_BUCKET.get(phase, "unattributed")
        # Recovery wins over preemption: a re-admitted request's wait is
        # failure-induced whatever else happened to it before the crash.
        if phase == "queued" and after_readmit.get(rid):
            bucket = "recovering"
            after_readmit[rid] = False
            after_preempt[rid] = False
        elif phase == "queued" and after_preempt.get(rid):
            bucket = "preempted"
            after_preempt[rid] = False
        r = reqs[rid]
        r.segments.append(Segment(phase, bucket, pid, t0, ts))
        if pid not in r.replicas:
            r.replicas.append(pid)
        if (bucket == "decode" and rid in first_migrate_in
                and ts > first_migrate_in[rid]):
            r.post_migration_decode_us += ts - max(t0,
                                                   first_migrate_in[rid])

    for ev in events:
        if ev.get("cat") != "request":
            continue
        rid = ev.get("id")
        if rid is None:
            continue
        ph, name, ts = ev.get("ph"), ev.get("name"), ev.get("ts", 0.0)
        pid = ev.get("pid", 0)
        args = ev.get("args") or {}
        if rid not in reqs:
            reqs[rid] = RequestBreakdown(
                rid=rid, t_begin=ts, t_end=ts,
                buckets={b: 0.0 for b in BUCKETS}, segments=[],
                replicas=[])
        r = reqs[rid]
        if args.get("synthesized") or name == "(truncated)":
            # Flight-ring truncation: this request's early history was
            # evicted; its buckets are lower bounds, not exhaustive.
            r.truncated = True
        if ph == "b":
            if name == "request":
                r.t_begin = ts
            else:
                close(rid, ts)      # defensive: tracer closes first
                open_phase[rid] = (name, ts, pid)
        elif ph == "e":
            if name == "request":
                close(rid, ts)
                r.t_end = ts
                r.flushed = bool(args.get("flushed"))
                r.tokens = int(args.get("tokens", r.tokens))
            else:
                close(rid, ts)
        elif ph == "n":
            if name == "preempted":
                r.preemptions += 1
                after_preempt[rid] = True
            elif name == "migrated_out":
                r.migrations += 1
                b = float(args.get("bytes", 0.0))
                r.migration_bytes += b
                migration_bytes += b
            elif name == "migrated_in":
                first_migrate_in.setdefault(rid, ts)
            elif name == "readmitted":
                r.readmissions += 1
                after_readmit[rid] = True

    for rid, r in reqs.items():
        close(rid, r.t_end)         # unterminated trace tail
        for seg in r.segments:
            r.buckets[seg.bucket] = r.buckets.get(seg.bucket, 0.0) \
                + seg.dur
        attributed = sum(seg.dur for seg in r.segments)
        r.buckets["unattributed"] = r.wall_us - attributed
    out = sorted(reqs.values(), key=lambda r: r.t_begin)
    return out, migration_bytes


# ---------------------------------------------------------- duration pass
def _parse_spans(events: Sequence[dict]) -> List[Tuple[str, int, int,
                                                       float, float]]:
    """Rebuild (name, pid, tid, t0, t1) duration spans from B/E pairs
    (LIFO per track, same discipline the validator checks)."""
    stacks: Dict[tuple, List[Tuple[str, float]]] = {}
    spans: List[Tuple[str, int, int, float, float]] = []
    for ev in events:
        ph = ev.get("ph")
        if ph == "B":
            key = (ev.get("pid"), ev.get("tid"))
            stacks.setdefault(key, []).append(
                (ev.get("name", "?"), ev.get("ts", 0.0)))
        elif ph == "E":
            key = (ev.get("pid"), ev.get("tid"))
            stack = stacks.get(key)
            if stack:
                name, t0 = stack.pop()
                spans.append((name, key[0], key[1], t0,
                              ev.get("ts", t0)))
    return spans


def _analyze_replicas(events: Sequence[dict],
                      spans: Sequence[Tuple[str, int, int, float, float]],
                      window: Tuple[float, float]
                      ) -> List[ReplicaReport]:
    names: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            names[ev.get("pid")] = (ev.get("args") or {}).get("name", "")
    per_pid: Dict[int, Dict[str, float]] = {}
    steps: Dict[int, int] = {}
    for name, pid, tid, t0, t1 in spans:
        d = per_pid.setdefault(pid, {})
        d[name] = d.get(name, 0.0) + (t1 - t0)
        if name == "engine_step":
            steps[pid] = steps.get(pid, 0) + 1
    out: List[ReplicaReport] = []
    window_us = max(0.0, window[1] - window[0])
    for pid in sorted(per_pid):
        d = per_pid[pid]
        if "engine_step" not in d:
            continue                # fabric/sim track, not a replica
        prefill = d.get("prefill", 0.0) + d.get("prefill_chunk", 0.0)
        migrate = d.get("migrate_out", 0.0) + d.get("migrate_in", 0.0)
        # migrate_out/in run outside engine_step (the balancer drives
        # them between steps), so busy is the sum; paged prefill runs on
        # side tids DURING the step, so decode is the step remainder.
        busy = d["engine_step"] + migrate
        out.append(ReplicaReport(
            pid=pid, name=names.get(pid, f"pid {pid}"),
            window_us=window_us, busy_us=busy,
            prefill_us=prefill,
            decode_us=max(0.0, d["engine_step"] - prefill),
            migrate_us=migrate, steps=steps.get(pid, 0)))
    return out


def _analyze_steal(events: Sequence[dict],
                   spans: Sequence[Tuple[str, int, int, float, float]],
                   requests: Sequence[RequestBreakdown],
                   migration_bytes: float) -> StealReport:
    rep = StealReport(migration_bytes=migration_bytes)
    supersteps = sorted((t0, t1) for name, pid, tid, t0, t1 in spans
                        if name == "superstep")
    rep.supersteps = len(supersteps)
    tier1_ts: List[float] = []
    tier2_ts: List[float] = []
    for ev in events:
        if ev.get("ph") != "i":
            continue
        name, args = ev.get("name"), ev.get("args") or {}
        if name == "steal_queued":
            rep.tier1_moves += int(args.get("n", 1))
            tier1_ts.append(ev.get("ts", 0.0))
        elif name == "steal_live":
            rep.tier2_moves += 1
            mode = args.get("mode", "?")
            rep.tier2_modes[mode] = rep.tier2_modes.get(mode, 0) + 1
            tier2_ts.append(ev.get("ts", 0.0))
        elif name == "terminated":
            rep.terminated_at_superstep = int(args.get("superstep", 0))
        elif name == "replica_dead":
            rep.replicas_dead += 1
        elif name == "request_readmitted":
            rep.readmissions += 1
        elif name == "fabric_wedged":
            rep.wedged = True

    def _rounds(ts_list: List[float]) -> int:
        if not supersteps:
            # Steals emitted outside any superstep span (manual
            # balance() calls) count one round each so efficiency is
            # never divided by 0.
            return len(ts_list)
        return sum(1 for t0, t1 in supersteps
                   if any(t0 <= ts <= t1 for ts in ts_list))

    rep.tier1_rounds = _rounds(tier1_ts)
    rep.tier2_rounds = _rounds(tier2_ts)
    rep.steal_rounds = _rounds(tier1_ts + tier2_ts)
    # Only genuinely MIGRATED requests (a migrated_out was traced) credit
    # the steal-efficiency numerator: decode run after a crash
    # re-admission is recovery, not stealing, and shipped zero bytes.
    rep.moved_decode_us = sum(r.post_migration_decode_us
                              for r in requests if r.migrations > 0)
    return rep


def _analyze_predictions(events: Sequence[dict]
                         ) -> Optional[PredictionReport]:
    """Fold every ``cost_sample`` instant (ts-ordered) into a
    :class:`PredictionReport`; None when the trace has none (cost model
    not attached — the report section simply doesn't render)."""
    samples: List[Tuple[float, str, float, float]] = []
    for ev in events:
        if ev.get("ph") != "i" or ev.get("name") != "cost_sample":
            continue
        args = ev.get("args") or {}
        samples.append((ev.get("ts", 0.0), str(args.get("tenant", "")),
                        float(args.get("predicted", 0.0)),
                        float(args.get("actual", 0.0))))
    if not samples:
        return None
    samples.sort(key=lambda s: s[0])
    errs = [p - a for _, _, p, a in samples]
    half = len(errs) // 2
    rep = PredictionReport(
        samples=len(errs),
        mean_abs_err=sum(abs(e) for e in errs) / len(errs),
        bias=sum(errs) / len(errs),
        early_abs_err=(sum(abs(e) for e in errs[:half]) / half
                       if half else 0.0),
        late_abs_err=(sum(abs(e) for e in errs[half:])
                      / max(len(errs) - half, 1)),
    )
    by_tenant: Dict[str, List[float]] = {}
    for (_, tenant, p, a) in samples:
        by_tenant.setdefault(tenant, []).append(p - a)
    for tenant in sorted(by_tenant):
        es = by_tenant[tenant]
        rep.tenants.append(TenantPrediction(
            tenant=tenant, samples=len(es),
            mean_abs_err=sum(abs(e) for e in es) / len(es),
            bias=sum(es) / len(es)))
    return rep


# ------------------------------------------------------------ entry point
def analyze_trace(source: Any) -> TraceAnalysis:
    trace = _load(source)
    problems = validate_chrome_trace(trace)
    events = trace.get("traceEvents") or []
    requests, migration_bytes = _parse_requests(events)
    spans = _parse_spans(events)
    ts_all = [ev.get("ts", 0.0) for ev in events if ev.get("ts", 0) > 0]
    window = (min(ts_all), max(ts_all)) if ts_all else (0.0, 0.0)
    replicas = _analyze_replicas(events, spans, window)
    steal = _analyze_steal(events, spans, requests, migration_bytes)
    burns = sum(1 for ev in events
                if ev.get("ph") == "i" and ev.get("name") == "slo_burn")
    flight = (trace.get("otherData") or {}).get("flight")
    return TraceAnalysis(
        requests=requests, replicas=replicas, steal=steal,
        validator_problems=problems,
        window_us=max(0.0, window[1] - window[0]),
        slo_burn_alerts=burns, flight=flight,
        prediction=_analyze_predictions(events))


def check_invariants(analysis: TraceAnalysis,
                     max_unattributed: float = 0.01,
                     abs_slack_us: float = 50.0) -> List[str]:
    """The attribution contract CI gates on: for EVERY fully-recorded
    request, bucket sums equal wall-clock (residual is the unattributed
    bucket by construction) and that residual is within
    ``max(max_unattributed · wall, abs_slack_us)``; a negative residual
    beyond slack means segments overlapped — a tracer bug. Truncated
    (flight-ring) requests are exempt: their history is a suffix."""
    violations = list(analysis.validator_problems)
    for r in analysis.requests:
        if r.truncated:
            continue
        slack = max(max_unattributed * r.wall_us, abs_slack_us)
        u = r.unattributed_us
        if u > slack:
            violations.append(
                f"{r.rid}: unattributed {u:.0f}us of {r.wall_us:.0f}us "
                f"wall ({100 * r.unattributed_frac:.2f}% > "
                f"{100 * max_unattributed:.0f}%)")
        elif u < -abs_slack_us:
            violations.append(
                f"{r.rid}: overlapping segments ({u:.0f}us residual)")
    return violations


# -------------------------------------------------------------- rendering
def _us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.0f}us"


def _pct(v: float) -> str:
    return f"{100 * v:.1f}%"


def render_markdown(analysis: TraceAnalysis,
                    max_unattributed: float = 0.01) -> str:
    a = analysis
    lines = ["# Trace analysis", ""]
    if a.flight:
        lines.append(
            f"_flight ring: capacity={a.flight.get('capacity')} "
            f"dropped={a.flight.get('dropped')} "
            f"synthesized_opens={a.flight.get('synthesized_opens')}_")
        lines.append("")
    lines.append(f"- window: **{_us(a.window_us)}**  ·  requests: "
                 f"**{len(a.requests)}**  ·  replicas: "
                 f"**{len(a.replicas)}**")
    if a.validator_problems:
        lines.append(f"- **VALIDATOR: {len(a.validator_problems)} "
                     f"problem(s)** — e.g. {a.validator_problems[0]}")
    else:
        lines.append("- validator: clean")
    viol = [v for v in check_invariants(a, max_unattributed)
            if v not in a.validator_problems]
    if viol:
        lines.append(f"- **ATTRIBUTION: {len(viol)} violation(s)** — "
                     f"e.g. {viol[0]}")
    else:
        lines.append(f"- attribution: every request ≥"
                     f"{_pct(1 - max_unattributed)} accounted")
    if a.slo_burn_alerts:
        lines.append(f"- **SLO burn alerts: {a.slo_burn_alerts}**")
    lines.append("")

    lines += ["## Request time attribution", "",
              "| bucket | total | share |", "|---|---:|---:|"]
    totals = a.bucket_totals()
    wall = sum(r.wall_us for r in a.requests) or 1.0
    for b in BUCKETS:
        lines.append(f"| {b} | {_us(totals.get(b, 0.0))} | "
                     f"{_pct(totals.get(b, 0.0) / wall)} |")
    lines.append("")

    if a.replicas:
        lines += ["## Replica utilization", "",
                  "| replica | busy | util | prefill | decode | migrate"
                  " | idle | steps |", "|---|---:|---:|---:|---:|---:|"
                  "---:|---:|"]
        for r in a.replicas:
            lines.append(
                f"| {r.name} | {_us(r.busy_us)} | "
                f"{_pct(r.utilization)} | {_us(r.prefill_us)} | "
                f"{_us(r.decode_us)} | {_us(r.migrate_us)} | "
                f"{_us(r.idle_us)} | {r.steps} |")
        lines.append("")

    s = a.steal
    lines += ["## Steal efficiency", ""]
    lines.append(f"- supersteps: {s.supersteps} (steal rounds: "
                 f"{s.steal_rounds})" +
                 (f", terminated at superstep "
                  f"{s.terminated_at_superstep}"
                  if s.terminated_at_superstep is not None else ""))
    lines.append(f"- moves: {s.moves} ({s.tier1_moves} queued + "
                 f"{s.tier2_moves} live KV"
                 + (f" {s.tier2_modes}" if s.tier2_modes else "") + ")")
    lines.append(f"- moves per steal round: "
                 f"{s.moves_per_steal_round:.2f} "
                 f"(tier-1 {s.tier1_moves_per_round:.2f}/round over "
                 f"{s.tier1_rounds}, tier-2 "
                 f"{s.tier2_moves_per_round:.2f}/round over "
                 f"{s.tier2_rounds})")
    lines.append(f"- migration payload: {s.migration_bytes / 1024:.1f} "
                 f"KiB; decode time moved: {_us(s.moved_decode_us)} "
                 f"({s.moved_decode_us_per_kib:.1f} us/KiB)")
    if s.replicas_dead or s.readmissions or s.wedged:
        lines.append(
            f"- **failures**: {s.replicas_dead} replica(s) dead, "
            f"{s.readmissions} request(s) re-admitted"
            + (", **fabric wedged**" if s.wedged else ""))
    lines.append("")

    if a.prediction is not None:
        p = a.prediction
        trend = "converging" if p.converging else "**diverging**"
        lines += ["## Prediction error", ""]
        lines.append(
            f"- {p.samples} scored prediction(s): mean |err| "
            f"{p.mean_abs_err:.1f} tokens, bias {p.bias:+.1f} "
            f"(early {p.early_abs_err:.1f} → late {p.late_abs_err:.1f}: "
            f"{trend})")
        if p.tenants:
            lines += ["", "| tenant | samples | mean abs err | bias |",
                      "|---|---:|---:|---:|"]
            for t in p.tenants:
                lines.append(
                    f"| {t.tenant or '(default)'} | {t.samples} | "
                    f"{t.mean_abs_err:.1f} | {t.bias:+.1f} |")
        lines.append("")

    p99 = a.p99_request()
    if p99 is not None:
        lines += [f"## Critical path (p99 request: {p99.rid}, "
                  f"{_us(p99.wall_us)} wall)", ""]
        lines.append(f"- replicas {p99.replicas}, "
                     f"{p99.preemptions} preemption(s), "
                     f"{p99.migrations} migration(s), "
                     f"{p99.tokens} token(s)")
        lines += ["", "| phase | bucket | replica | start | dur |",
                  "|---|---|---:|---:|---:|"]
        for seg in p99.segments:
            lines.append(f"| {seg.phase} | {seg.bucket} | {seg.pid} | "
                         f"+{_us(seg.t0 - p99.t_begin)} | "
                         f"{_us(seg.dur)} |")
        if p99.unattributed_us > 0:
            lines.append(f"| _(unattributed)_ |  |  |  | "
                         f"{_us(p99.unattributed_us)} |")
        lines.append("")
    return "\n".join(lines)


def render_summary(analysis: TraceAnalysis) -> str:
    """Compact multi-line fabric report for example scripts' exits."""
    a = analysis
    totals = a.bucket_totals()
    wall = sum(r.wall_us for r in a.requests) or 1.0
    parts = [f"{b}={_pct(totals.get(b, 0.0) / wall)}"
             for b in BUCKETS if totals.get(b, 0.0) > 0]
    lines = [f"trace: {len(a.requests)} request(s) over "
             f"{_us(a.window_us)}; attribution " + " ".join(parts)]
    for r in a.replicas:
        lines.append(f"  {r.name}: util {_pct(r.utilization)} "
                     f"(prefill {_us(r.prefill_us)}, decode "
                     f"{_us(r.decode_us)}, migrate {_us(r.migrate_us)}, "
                     f"idle {_us(r.idle_us)}; {r.steps} steps)")
    s = a.steal
    if s.moves:
        lines.append(
            f"  steals: {s.moves} move(s) in {s.steal_rounds} round(s), "
            f"{s.migration_bytes / 1024:.1f} KiB shipped, "
            f"{s.moved_decode_us_per_kib:.1f} us decode/KiB")
    if s.replicas_dead or s.wedged:
        lines.append(
            f"  failures: {s.replicas_dead} replica(s) dead, "
            f"{s.readmissions} re-admission(s)"
            + (", fabric WEDGED" if s.wedged else ""))
    if a.prediction is not None:
        p = a.prediction
        lines.append(
            f"  predictions: {p.samples} scored, mean |err| "
            f"{p.mean_abs_err:.1f} tokens "
            f"(early {p.early_abs_err:.1f} → late {p.late_abs_err:.1f})")
    p99 = a.p99_request()
    if p99 is not None:
        lines.append(f"  p99 request {p99.rid}: {_us(p99.wall_us)} "
                     f"({len(p99.segments)} segments, "
                     f"{_pct(p99.unattributed_frac)} unattributed)")
    return "\n".join(lines)


def headline(analysis: TraceAnalysis) -> str:
    """One-liner for ``uts_demo --trace``-style post-run output."""
    a = analysis
    ok = not a.validator_problems and not check_invariants(a)
    util = (sum(r.utilization for r in a.replicas) / len(a.replicas)
            if a.replicas else 0.0)
    return (f"analysis: {'ok' if ok else 'VIOLATIONS'}; "
            f"{len(a.requests)} request(s), "
            f"{len(a.replicas)} replica(s) at {_pct(util)} mean util, "
            f"{a.steal.moves} steal move(s)")


# -------------------------------------------------------------------- CLI
def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="Analyze a Chrome trace produced by the serving "
                    "fabric: request attribution, replica utilization, "
                    "steal efficiency. Exits 1 on validator errors or "
                    "attribution-invariant violations (the CI gate).")
    ap.add_argument("trace", help="path to a trace JSON file")
    ap.add_argument("--json", action="store_true",
                    help="emit the analysis as JSON instead of markdown")
    ap.add_argument("--out", help="also write the report to this path")
    ap.add_argument("--summary",
                    help="append the markdown report to this file "
                         "(e.g. $GITHUB_STEP_SUMMARY)")
    ap.add_argument("--max-unattributed", type=float, default=0.01,
                    help="max unattributed fraction of any request's "
                         "wall-clock (default 0.01)")
    args = ap.parse_args(argv)

    analysis = analyze_trace(args.trace)
    if args.json:
        report = json.dumps(analysis.to_dict(), indent=2, default=float)
    else:
        report = render_markdown(analysis, args.max_unattributed)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report if not args.json
                    else render_markdown(analysis,
                                         args.max_unattributed))
    if args.summary:
        with open(args.summary, "a") as f:
            f.write(render_markdown(analysis, args.max_unattributed)
                    + "\n")

    violations = check_invariants(analysis, args.max_unattributed)
    if violations:
        print(f"\nFAIL: {len(violations)} violation(s):",
              file=sys.stderr)
        for v in violations[:20]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    print(f"\nOK: {len(analysis.requests)} request(s) fully attributed "
          f"(<= {100 * args.max_unattributed:.0f}% unattributed each)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
