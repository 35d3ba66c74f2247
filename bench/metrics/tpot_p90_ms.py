"""tpot_p90_ms: the 90th percentile, over requests due in the window that
had at least 2 tokens when latencies stop being read, of (last token's
time - first token's time) / (tokens - 1)."""
from harness.stats import percentile


def read(run):
    vals = [(r.t_last - r.t_first) / (r.n_last - 1) * 1e3
            for r in run.recs if r.window and r.n_last >= 2]
    return percentile(vals, 90) if vals else None
