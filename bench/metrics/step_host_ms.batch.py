"""step_host_ms.batch: the host's own milliseconds of one Engine.step
(its self time): the ``engine_step`` span's host duration less the host
durations of its ``prefill``, ``prefill_chunk`` and ``decode_loop``
spans, which end when the device's work for them is done or enqueued.
What is left is the plan, the drain and the step's other bookkeeping.
The mean over the window's steps outside the profiled slice that have a
``decode_loop`` span."""
from harness import spans

CHILDREN = ("prefill", "prefill_chunk", "decode_loop")


def read(run):
    if run.spans is None:
        return None
    selfs = []
    for group in spans.by_step(run, spans.timed_steps(run)).values():
        names = [sp.name for sp in group]
        if "engine_step" not in names or "decode_loop" not in names:
            continue
        step = next(sp for sp in group if sp.name == "engine_step")
        selfs.append(step.dur - sum(sp.dur for sp in group
                                    if sp.name in CHILDREN))
    return sum(selfs) / len(selfs) * 1e3 if selfs else None
