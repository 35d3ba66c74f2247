"""repro_torch.obs — zero-dependency tracing, metrics and their analysis
(copies of ``repro.obs``).

  trace.py    — Chrome trace_event spans/instants/counters, request
                lifecycle async spans, NullTracer disabled default.
  metrics.py  — counters / gauges / fixed-bucket histograms with
                snapshot()/merged() and Prometheus rendering.
  flight.py   — FlightRecorder: bounded ring-buffer tracer whose
                dump() is always balanced (synthesized opens for
                evicted begins) — always-on tracing in fixed memory.
  analyze.py  — trace analytics: per-request time attribution,
                replica utilization, steal efficiency, p99 critical
                path; the ``python -m repro_torch.obs.analyze`` gate.
  slo.py      — SLOMonitor: declared TTFT/TPOT/queue-wait targets,
                rolling windows, multi-window burn-rate alerts.
"""
from .trace import (NULL_TRACER, NullTracer, Tracer, atomic_write_json,
                    clock_sync, now_us, validate_chrome_trace)
from .metrics import (DEFAULT_BYTE_BUCKETS, DEFAULT_MS_BUCKETS, Counter,
                      Gauge, Histogram, MetricsRegistry,
                      quantiles_from_values)
from .flight import FlightRecorder
from .slo import SLOMonitor, SLOTarget, parse_slo_spec

# analyze is exported lazily (PEP 562): `python -m repro_torch.obs.analyze`
# imports this package BEFORE running analyze as __main__, and an eager
# import here would put a second copy in sys.modules (RuntimeWarning).
_ANALYZE_EXPORTS = ("TraceAnalysis", "analyze_trace", "check_invariants",
                    "render_markdown", "render_summary")


def __getattr__(name):
    if name in _ANALYZE_EXPORTS:
        from . import analyze
        return getattr(analyze, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "atomic_write_json",
    "clock_sync",
    "now_us",
    "validate_chrome_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "quantiles_from_values",
    "DEFAULT_MS_BUCKETS",
    "DEFAULT_BYTE_BUCKETS",
    "FlightRecorder",
    "TraceAnalysis",
    "analyze_trace",
    "check_invariants",
    "render_markdown",
    "render_summary",
    "SLOMonitor",
    "SLOTarget",
    "parse_slo_spec",
]
