"""queue_wait_p90_ms.poisson: the 90th percentile, over requests due in
the window, of the time from their due time to the start of their
``prefill`` phase in the engine's own trace (the scheduler's admission),
in ms."""
from harness.stats import percentile


def read(run):
    if run.spans is None:
        return None
    start = {}
    for ev in run.spans:
        if ev.get("ph") == "b" and ev.get("name") == "prefill":
            start.setdefault(ev["id"], ev["ts"] / 1e6)
    vals = [(start[f"req{r.i}"] - r.due) * 1e3 for r in run.recs
            if r.window and f"req{r.i}" in start]
    return percentile(vals, 90) if vals else None
