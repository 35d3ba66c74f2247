"""ttft_p90_ms: the 90th percentile, over every request due in the
window, of its first token's time minus its due time (open loop); a
request with no first token when latencies stop being read counts at its
age then."""
from harness.stats import percentile


def read(run):
    due = [r for r in run.recs if r.window]
    if not due:
        return None
    stop = run.loop.stop
    return percentile([((r.t_first if r.t_first is not None
                         and r.t_first <= stop else stop) - r.due) * 1e3
                       for r in due], 90)
