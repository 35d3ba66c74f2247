"""prefill_ms.batch: the mean device milliseconds (``device_ms``, CUDA
events at the span's edges) of a fresh admission's ``prefill`` span in
the engine's trace (the bucket's forward, the copy into the pool and the
first token's sample), over the window's steps outside the profiled
slice. A request's first ``prefill`` span is its fresh admission; a
later one resumes it after a preemption."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    first = {}
    for sp in spans.parse(run.spans):
        if sp.name == "prefill":
            first.setdefault(sp.args.get("rid"), sp.t0)
    steps = spans.timed_steps(run)
    ms = [sp.args["device_ms"]
          for group in spans.by_step(run, steps).values() for sp in group
          if sp.name == "prefill" and "device_ms" in sp.args
          and first.get(sp.args.get("rid")) == sp.t0]
    return sum(ms) / len(ms) if ms else None
