"""repro_torch.obs — zero-dependency tracing and metrics (copies of
``repro.obs.trace`` and ``repro.obs.metrics``).

  trace.py    — Chrome trace_event spans/instants/counters, request
                lifecycle async spans, NullTracer disabled default.
  metrics.py  — counters / gauges / fixed-bucket histograms with
                snapshot()/merged() and Prometheus rendering.
"""
from .trace import (NULL_TRACER, NullTracer, Tracer, atomic_write_json,
                    clock_sync, now_us, validate_chrome_trace)
from .metrics import (DEFAULT_BYTE_BUCKETS, DEFAULT_MS_BUCKETS, Counter,
                      Gauge, Histogram, MetricsRegistry,
                      quantiles_from_values)

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
]
